// Sliding-DFT hop for Hopper (sm_90a): one kernel, two sources of the slide.
//
// Replaces openmeters_tpu/ops/pallas_sliding.py::sliding_hop, both its
// whole-row variant (_build, "B1a") and its bin-tiled variant (_build_tiled,
// "B1b").  For each stream and each of `cols` columns, in order:
//
//   1. F = rot * (F + D_k)              only if k < ready, else F is held
//   2. W = a0 F[b] + sum_j a_j/2 (F[b-j] + F[b+j]), hermitian reflection at
//      bin 0 and at Nyquist (the cosine-sum window as a frequency stencil)
//   3. W -= (F[0] / n) dc_corr          (DC removal, post-slide bin 0)
//   4. p  = |W|^2 norm
//   5. kCodes: code = clip(rint((max(ln(max(p, 1e-45)) LN_TO_DB, floor) + 144)
//                               * 65535/156), 0, 65535) as uint16;
//      else p as float32
//
// and writes the new state (fr, fi) and the columns [S, cols, bins].  The
// delta spectrum D_k is where the two variants differ:
//
//   - B1a (kSpectra = false): D_k = d_k . upd, the column's `hop` sample
//     deltas against the [hop, bins] DFT update matrices, computed here.  At
//     the flagship shape (S=8192, cols=4, hop=64, bins=1025) that product is
//     4.3 GFMA a hop against ~0.2 GB of traffic, so this variant is bound by
//     f32 FMA issue.
//   - B1b (kSpectra = true): D_k comes in precomputed, [S, cols, bins]
//     complex64 read in place as float2 (the caller's rFFT of the deltas,
//     which replaces a [hop, bins] product far too large for large FFTs:
//     2 x 512 x 8193 floats at 16384/512).  Every operation left is a few
//     FLOPs a bin, so this variant is bound by bytes: the state in and out,
//     the delta spectra in and the columns out.
//
// Design.  Grid = (bin tile, stream tile).  A block of EXT = 128 threads
// slides EXT consecutive bins -- TILE = 122 output bins plus a HALO of 3 on
// each side, recomputed redundantly rather than exchanged -- for TS = 8
// streams; each thread owns one bin and keeps the 8 streams' complex state in
// registers across the column loop.  The TPU variant's halo states, tile
// padding and in-place aliasing exist only for VMEM and Mosaic and are not
// carried over: the state goes out to fresh buffers, never in place, since a
// neighbouring block still reads the old halo.  For B1a the deltas of the
// stream tile are staged in shared memory and read back as float4
// broadcasts, and the delta spectra of up to CCH = 4 columns are accumulated
// in one pass over `hop`, so every upd element is read once per block
// (through the read-only cache; the update matrices stay in L2) and feeds
// 2 * CCH * TS FMAs.  The slid values then go through shared memory for the
// stencil.  All arithmetic is full f32 on the CUDA cores (no fast math:
// logf, no flush to zero).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO = 3;              // max stencil reach, len(coeffs) - 1
constexpr int EXT = 128;             // bins slid per block = threads per block
constexpr int TILE = EXT - 2 * HALO; // output bins per block
constexpr int TS = 8;                // streams per block
constexpr int CCH = 4;               // columns whose delta spectra share a pass
constexpr float LN_TO_DB = 4.3429448f;
constexpr float STORE_LO = -144.0f;

template <bool kSpectra, bool kCodes>
__global__ void __launch_bounds__(EXT) sliding_hop_kernel(
    const float* __restrict__ fr, const float* __restrict__ fi,
    const float* __restrict__ deltas, const float2* __restrict__ dspec,
    const float* __restrict__ upd_r, const float* __restrict__ upd_i,
    const float* __restrict__ rot_r, const float* __restrict__ rot_i,
    const float* __restrict__ dc_corr, const float* __restrict__ norm,
    float* __restrict__ fr_out, float* __restrict__ fi_out,
    void* __restrict__ out,
    int S, int cols, int hop, int bins, int ready,
    float inv_n, float a0, float h1, float h2, float h3, int reach, int dc_bins,
    float floor_db, float store_scale) {
  extern __shared__ __align__(16) float smem[];
  float* sd = smem;                                      // B1a: [TS][cols][hop] deltas
  float* sre = sd + (kSpectra ? 0 : TS * cols * hop);    // [TS][EXT] slid real parts
  float* sim = sre + TS * EXT;                           // [TS][EXT] slid imaginary parts

  const int t = threadIdx.x;
  const int tile0 = blockIdx.x * TILE;    // first output bin of the block
  const int g = tile0 - HALO + t;         // this thread's bin
  const bool in_range = g >= 0 && g < bins;
  const bool emits = t >= HALO && t < HALO + TILE && g < bins;
  const int s0 = blockIdx.y * TS;
  const float halves[3] = {h1, h2, h3};

  if constexpr (!kSpectra) {
    // stage the stream tile's deltas (hop % 4 == 0, so rows are float4-aligned)
    const int n4 = TS * cols * hop / 4;
    const long long base4 = (long long)s0 * cols * hop / 4;
    const long long total4 = (long long)S * cols * hop / 4;
    const float4* src = reinterpret_cast<const float4*>(deltas);
    float4* dst = reinterpret_cast<float4*>(sd);
    for (int i = t; i < n4; i += EXT) {
      dst[i] = base4 + i < total4 ? src[base4 + i]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  float xr[TS], xi[TS];
  float rr = 0.f, ri = 0.f;
  if (in_range) {
    rr = rot_r[g];
    ri = rot_i[g];
  }
#pragma unroll
  for (int s = 0; s < TS; ++s) {
    const bool ok = in_range && s0 + s < S;
    xr[s] = ok ? fr[(long long)(s0 + s) * bins + g] : 0.f;
    xi[s] = ok ? fi[(long long)(s0 + s) * bins + g] : 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < cols; c0 += CCH) {
    // B1a: delta spectra of columns c0 .. c0+CCH-1 for this bin, all TS streams
    float dr[CCH][TS], di[CCH][TS];
    if constexpr (!kSpectra) {
#pragma unroll
      for (int kk = 0; kk < CCH; ++kk) {
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          dr[kk][s] = 0.f;
          di[kk][s] = 0.f;
        }
      }
      if (in_range) {
        for (int j = 0; j < hop; j += 4) {
          float ur[4], ui[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ur[q] = __ldg(upd_r + (long long)(j + q) * bins + g);
            ui[q] = __ldg(upd_i + (long long)(j + q) * bins + g);
          }
#pragma unroll
          for (int kk = 0; kk < CCH; ++kk) {
            const int k = c0 + kk;
            if (k < cols) {
#pragma unroll
              for (int s = 0; s < TS; ++s) {
                const float4 d =
                    *reinterpret_cast<const float4*>(sd + (s * cols + k) * hop + j);
                float ar = dr[kk][s], ai = di[kk][s];
                ar = fmaf(d.x, ur[0], ar);
                ai = fmaf(d.x, ui[0], ai);
                ar = fmaf(d.y, ur[1], ar);
                ai = fmaf(d.y, ui[1], ai);
                ar = fmaf(d.z, ur[2], ar);
                ai = fmaf(d.z, ui[2], ai);
                ar = fmaf(d.w, ur[3], ar);
                ai = fmaf(d.w, ui[3], ai);
                dr[kk][s] = ar;
                di[kk][s] = ai;
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int kk = 0; kk < CCH; ++kk) {
      const int k = c0 + kk;
      if (k >= cols) break;  // uniform across the block
      if (k < ready) {
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          float ddr, ddi;
          if constexpr (kSpectra) {
            const bool ok = in_range && s0 + s < S;
            const float2 d = ok ? dspec[((long long)(s0 + s) * cols + k) * bins + g]
                                : make_float2(0.f, 0.f);
            ddr = d.x;
            ddi = d.y;
          } else {
            ddr = dr[kk][s];
            ddi = di[kk][s];
          }
          const float tr = xr[s] + ddr;
          const float ti = xi[s] + ddi;
          xr[s] = tr * rr - ti * ri;
          xi[s] = tr * ri + ti * rr;
        }
      }
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        sre[s * EXT + t] = xr[s];
        sim[s * EXT + t] = xi[s];
      }
      __syncthreads();

      if (emits) {
        const float nrm = norm[g];
        const float dc = g < dc_bins ? dc_corr[g] : 0.f;
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          if (s0 + s >= S) break;
          const float* pr = sre + s * EXT;
          const float* pi = sim + s * EXT;
          float wr = a0 * xr[s];
          float wi = a0 * xi[s];
#pragma unroll
          for (int j = 1; j <= HALO; ++j) {
            if (j > reach) break;
            float lr, li, hr, hi;
            if (g - j >= 0) {
              lr = pr[t - j];
              li = pi[t - j];
            } else {  // F[-m] = conj(F[m])
              const int loc = (j - g) - tile0 + HALO;
              lr = pr[loc];
              li = -pi[loc];
            }
            if (g + j <= bins - 1) {
              hr = pr[t + j];
              hi = pi[t + j];
            } else {  // F[N - m] = conj(F[m]) past Nyquist
              const int loc = (2 * (bins - 1) - (g + j)) - tile0 + HALO;
              hr = pr[loc];
              hi = -pi[loc];
            }
            wr = wr + halves[j - 1] * (lr + hr);
            wi = wi + halves[j - 1] * (li + hi);
          }
          if (g < dc_bins) {  // only bins < len(coeffs), all in tile 0
            const float mean = pr[HALO - tile0] * inv_n;
            wr = wr - mean * dc;
          }
          const float p = (wr * wr + wi * wi) * nrm;
          const long long o = ((long long)(s0 + s) * cols + k) * bins + g;
          if constexpr (kCodes) {
            const float db = fmaxf(logf(fmaxf(p, 1e-45f)) * LN_TO_DB, floor_db);
            float code = rintf((db - STORE_LO) * store_scale);  // half to even
            code = fminf(fmaxf(code, 0.f), 65535.f);
            static_cast<uint16_t*>(out)[o] = (uint16_t)code;
          } else {
            static_cast<float*>(out)[o] = p;
          }
        }
      }
      __syncthreads();  // the next column overwrites sre/sim
    }
  }

  if (emits) {
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      if (s0 + s < S) {
        fr_out[(long long)(s0 + s) * bins + g] = xr[s];
        fi_out[(long long)(s0 + s) * bins + g] = xi[s];
      }
    }
  }
}

template <bool kSpectra, bool kCodes>
int launch(const float* fr, const float* fi, const float* deltas,
           const float2* dspec, const float* upd_r, const float* upd_i,
           const float* rot_r, const float* rot_i, const float* dc_corr,
           const float* norm, float* fr_out, float* fi_out, void* out, int S,
           int cols, int hop, int bins, int ready, float inv_n, float a0,
           float h1, float h2, float h3, int reach, int dc_bins, float floor_db,
           float store_scale, cudaStream_t stream) {
  const dim3 grid((bins + TILE - 1) / TILE, (S + TS - 1) / TS);
  const size_t smem =
      sizeof(float) * ((kSpectra ? 0 : (size_t)TS * cols * hop) + 2 * TS * EXT);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sliding_hop_kernel<kSpectra, kCodes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sliding_hop_kernel<kSpectra, kCodes><<<grid, EXT, smem, stream>>>(
      fr, fi, deltas, dspec, upd_r, upd_i, rot_r, rot_i, dc_corr, norm, fr_out,
      fi_out, out, S, cols, hop, bins, ready, inv_n, a0, h1, h2, h3, reach,
      dc_bins, floor_db, store_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entries: launch on `stream` and return cudaGetLastError().  `out` is
// uint16 codes when emit_codes is nonzero, else float32 power.

// B1a: the delta spectra from the [S, cols, hop] deltas and upd.
extern "C" int sliding_hop_launch(
    const float* fr, const float* fi, const float* deltas,
    const float* upd_r, const float* upd_i, const float* rot_r,
    const float* rot_i, const float* dc_corr, const float* norm,
    float* fr_out, float* fi_out, void* out,
    int S, int cols, int hop, int bins, int ready,
    float inv_n, float a0, float h1, float h2, float h3, int reach, int dc_bins,
    float floor_db, float store_scale, int emit_codes, void* stream) {
  if (S == 0) return 0;
  if (reach > HALO || hop % 4 != 0 || dc_bins > TILE)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (emit_codes)
    return launch<false, true>(fr, fi, deltas, nullptr, upd_r, upd_i, rot_r,
                               rot_i, dc_corr, norm, fr_out, fi_out, out, S,
                               cols, hop, bins, ready, inv_n, a0, h1, h2, h3,
                               reach, dc_bins, floor_db, store_scale, st);
  return launch<false, false>(fr, fi, deltas, nullptr, upd_r, upd_i, rot_r,
                              rot_i, dc_corr, norm, fr_out, fi_out, out, S,
                              cols, hop, bins, ready, inv_n, a0, h1, h2, h3,
                              reach, dc_bins, floor_db, store_scale, st);
}

// B1b: the delta spectra given, [S, cols, bins] complex64.
extern "C" int sliding_hop_spectra_launch(
    const float* fr, const float* fi, const void* dspec, const float* rot_r,
    const float* rot_i, const float* dc_corr, const float* norm,
    float* fr_out, float* fi_out, void* out,
    int S, int cols, int bins, int ready,
    float inv_n, float a0, float h1, float h2, float h3, int reach, int dc_bins,
    float floor_db, float store_scale, int emit_codes, void* stream) {
  if (S == 0) return 0;
  if (reach > HALO || dc_bins > TILE) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const float2*>(dspec);
  if (emit_codes)
    return launch<true, true>(fr, fi, nullptr, d, nullptr, nullptr, rot_r,
                              rot_i, dc_corr, norm, fr_out, fi_out, out, S,
                              cols, 0, bins, ready, inv_n, a0, h1, h2, h3,
                              reach, dc_bins, floor_db, store_scale, st);
  return launch<true, false>(fr, fi, nullptr, d, nullptr, nullptr, rot_r,
                             rot_i, dc_corr, norm, fr_out, fi_out, out, S,
                             cols, 0, bins, ready, inv_n, a0, h1, h2, h3,
                             reach, dc_bins, floor_db, store_scale, st);
}
