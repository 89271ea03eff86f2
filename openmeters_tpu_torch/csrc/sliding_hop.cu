// Sliding-DFT hop from precomputed delta spectra for Hopper (sm_90a), "B1b".
//
// Replaces openmeters_tpu/ops/pallas_sliding.py::sliding_hop, its bin-tiled
// variant (_build_tiled).  For each stream and each of `cols` columns, in
// order:
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
// and writes the new state (fr, fi) and the columns [S, cols, bins].  D_k
// comes in precomputed, [S, cols, bins] complex64 read in place as float2
// (the caller's rFFT of the deltas, which replaces a [hop, bins] product far
// too large for large FFTs: 2 x 512 x 8193 floats at 16384/512).  Every
// operation left is a few FLOPs a bin, so this kernel is bound by bytes: the
// state in and out, the delta spectra in and the columns out.  (The
// whole-row variant, B1a, which computes D_k from sample deltas on the
// tensor cores, is sliding_hop_deltas.cu.)
//
// Design.  Grid = (bin tile, stream tile).  A block of EXT = 128 threads
// slides EXT consecutive bins -- TILE = 122 output bins plus a HALO of 3 on
// each side, recomputed redundantly rather than exchanged -- for TS = 8
// streams; each thread owns one bin and keeps the 8 streams' complex state in
// registers across the column loop.  The TPU variant's halo states, tile
// padding and in-place aliasing exist only for VMEM and Mosaic and are not
// carried over: the state goes out to fresh buffers, never in place, since a
// neighbouring block still reads the old halo.  The slid values go through
// shared memory for the stencil.  All arithmetic is full f32 on the CUDA
// cores (no fast math: logf, no flush to zero).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO = 3;              // max stencil reach, len(coeffs) - 1
constexpr int EXT = 128;             // bins slid per block = threads per block
constexpr int TILE = EXT - 2 * HALO; // output bins per block
constexpr int TS = 8;                // streams per block
constexpr int CCH = 4;               // columns a pass of the column loop takes
constexpr float LN_TO_DB = 4.3429448f;
constexpr float STORE_LO = -144.0f;

template <bool kCodes>
__global__ void __launch_bounds__(EXT) sliding_hop_spectra_kernel(
    const float* __restrict__ fr, const float* __restrict__ fi,
    const float2* __restrict__ dspec,
    const float* __restrict__ rot_r, const float* __restrict__ rot_i,
    const float* __restrict__ dc_corr, const float* __restrict__ norm,
    float* __restrict__ fr_out, float* __restrict__ fi_out,
    void* __restrict__ out,
    int S, int cols, int bins, int ready,
    float inv_n, float a0, float h1, float h2, float h3, int reach, int dc_bins,
    float floor_db, float store_scale) {
  extern __shared__ __align__(16) float smem[];
  float* sre = smem;                                     // [TS][EXT] slid real parts
  float* sim = sre + TS * EXT;                           // [TS][EXT] slid imaginary parts

  const int t = threadIdx.x;
  const int tile0 = blockIdx.x * TILE;    // first output bin of the block
  const int g = tile0 - HALO + t;         // this thread's bin
  const bool in_range = g >= 0 && g < bins;
  const bool emits = t >= HALO && t < HALO + TILE && g < bins;
  const int s0 = blockIdx.y * TS;
  const float halves[3] = {h1, h2, h3};

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
#pragma unroll
    for (int kk = 0; kk < CCH; ++kk) {
      const int k = c0 + kk;
      if (k >= cols) break;  // uniform across the block
      if (k < ready) {
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          const bool ok = in_range && s0 + s < S;
          const float2 d = ok ? dspec[((long long)(s0 + s) * cols + k) * bins + g]
                              : make_float2(0.f, 0.f);
          const float tr = xr[s] + d.x;
          const float ti = xi[s] + d.y;
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

template <bool kCodes>
int launch(const float* fr, const float* fi, const float2* dspec,
           const float* rot_r, const float* rot_i, const float* dc_corr,
           const float* norm, float* fr_out, float* fi_out, void* out, int S,
           int cols, int bins, int ready, float inv_n, float a0,
           float h1, float h2, float h3, int reach, int dc_bins, float floor_db,
           float store_scale, cudaStream_t stream) {
  const dim3 grid((bins + TILE - 1) / TILE, (S + TS - 1) / TS);
  const size_t smem = sizeof(float) * 2 * TS * EXT;
  sliding_hop_spectra_kernel<kCodes><<<grid, EXT, smem, stream>>>(
      fr, fi, dspec, rot_r, rot_i, dc_corr, norm, fr_out, fi_out, out, S, cols,
      bins, ready, inv_n, a0, h1, h2, h3, reach, dc_bins, floor_db, store_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry: launches on `stream` and returns cudaGetLastError().  The
// delta spectra are [S, cols, bins] complex64; `out` is uint16 codes when
// emit_codes is nonzero, else float32 power.
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
    return launch<true>(fr, fi, d, rot_r, rot_i, dc_corr, norm, fr_out, fi_out, out, S, cols,
                        bins, ready, inv_n, a0, h1, h2, h3, reach, dc_bins, floor_db,
                        store_scale, st);
  return launch<false>(fr, fi, d, rot_r, rot_i, dc_corr, norm, fr_out, fi_out, out, S, cols,
                       bins, ready, inv_n, a0, h1, h2, h3, reach, dc_bins, floor_db,
                       store_scale, st);
}
