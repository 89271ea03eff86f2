// Sliding-DFT hop for large FFTs on Hopper (sm_90a), "B1b".
//
// Replaces openmeters_tpu/ops/pallas_sliding.py::sliding_hop, its bin-tiled
// variant (_build_tiled, with the rfft_mxu of the deltas before it).  For
// each stream and each of `cols` columns, in order:
//
//   0. D_k = rfft(d_k, n), the delta spectrum of the column's hop samples;
//   1. F = rot * (F + D_k)              only if k < ready, else F is held
//   2. W = a0 F[b] + sum_j a_j/2 (F[b-j] + F[b+j]), hermitian reflection at
//      bin 0 and at Nyquist (the cosine-sum window as a frequency stencil)
//   3. W -= (F[0] / n) dc_corr          (DC removal, post-slide bin 0)
//   4. p  = |W|^2 norm
//   5. kCodes: code = clip(rint((max(ln(max(p, 1e-45)) LN_TO_DB, floor) + 144)
//                               * 65535/156), 0, 65535) as uint16;
//      else p as float32
//
// and writes the new state (fr, fi) and the columns [S, cols, bins].  (The
// whole-row variant, B1a, which computes D_k on the tensor cores from
// [hop, bins] update matrices, is sliding_hop_deltas.cu; those matrices are
// far too large here: 2 x 512 x 8193 floats at 16384/512.)
//
// sliding_hop_block_kernel, n <= 16384 (every large config the engine
// meets).  A block of 512 threads owns one stream's whole row at a time and
// computes step 0 itself: with R = n/P, P = hop rounded up to a power of
// two (the deltas zero-padded), the pruned transform of the P nonzero
// samples is
//   D[q R + r] = sum_{m<P} (d[m] e^{-2 pi i m r/n}) e^{-2 pi i m q/P},
// R twiddled P-point FFTs; and since d is real, Y_{R-r}[q] =
// conj(Y_r[P-1-q]), so only r = 0..R/2 run (fft_block.cuh, decimation in
// frequency, passes of up to 8 points).  So the kernel reads only the state,
// the deltas and a few rows, and writes the state and the columns: it is
// bound by those bytes (1.36 GB at 16384/512, S=8192), not by the ~6 GFLOP
// of its transforms.  Shared memory holds the state row (64 KB), which
// comes in by cp.async and is slid in place, and as many transforms as let
// two blocks share an SM (12 of the 17 at 16384/512: two passes over the
// buffer), so that one block's loads and stores run beside the other's
// transforms; the blocks are persistent, and each prefetches its next
// stream's row and deltas.
//
// sliding_hop_spectra_kernel, larger n, where a row outgrows one block:
// D_k comes in precomputed, [S, cols, bins] complex64 read in place as
// float2 (the caller's rFFT of the deltas).  Grid = (bin tile, stream
// tile).  A block of EXT = 128 threads slides EXT consecutive bins -- TILE =
// 122 output bins plus a HALO of 3 on each side, recomputed redundantly
// rather than exchanged -- for TS = 8 streams; each thread owns one bin and
// keeps the 8 streams' complex state in registers across the column loop.
// The state goes out to fresh buffers, never in place, since a neighbouring
// block still reads the old halo.  The slid values go through shared memory
// for the stencil.
//
// All arithmetic is full f32 on the CUDA cores (no fast math: logf, no
// flush to zero).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_block.cuh"

namespace {

constexpr int HALO = 3;              // max stencil reach, len(coeffs) - 1
constexpr int EXT = 128;             // bins slid per block = threads per block
constexpr int TILE = EXT - 2 * HALO; // output bins per block
constexpr int TS = 8;                // streams per block
constexpr int CCH = 4;               // columns a pass of the column loop takes
constexpr float LN_TO_DB = 4.3429448f;
constexpr float STORE_LO = -144.0f;

constexpr int BT = 512;              // threads of the whole-row block
constexpr int BLOCK_MAXB = 3;        // radix-2 stages a pass: 8 points in registers
constexpr int BLOCK_MAX_N = 16384;
constexpr size_t MAX_SMEM = 232448;   // a block's shared memory on sm_90
constexpr size_t HALF_SMEM = 115712;  // each of two blocks an SM (1 KB of the SM's 228 reserved a block)

template <bool kCodes>
__device__ __forceinline__ void emit(void* out, long long o, float p, float floor_db,
                                     float store_scale) {
  if constexpr (kCodes) {
    const float db = fmaxf(logf(fmaxf(p, 1e-45f)) * LN_TO_DB, floor_db);
    float code = rintf((db - STORE_LO) * store_scale);  // half to even
    code = fminf(fmaxf(code, 0.f), 65535.f);
    static_cast<uint16_t*>(out)[o] = (uint16_t)code;
  } else {
    static_cast<float*>(out)[o] = p;
  }
}

struct BlockParams {
  const float* fr;
  const float* fi;
  const float* deltas;    // [S, cols, hop]
  const float2* build_tw; // [count P], exp(-2 pi i m r/n) at r P + m
  const float2* fft_tw;   // the P-point plan's table (ops/block_fft.py)
  const float* rot_r;
  const float* rot_i;
  const float* dc_corr;
  const float* norm;
  float* fr_out;
  float* fi_out;
  void* out;
  int S, cols, hop, log2p, log2n, bins, ready, chunk;  // chunk: transforms a pass over the buffer
  float inv_n, a0, halves[HALO];
  int reach, dc_bins;
  float floor_db, store_scale;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Stream s's state row into (sr, si), one cp.async group.
__device__ __forceinline__ void fetch_row(const BlockParams& P, int s, float* sr, float* si) {
  const long long row = (long long)s * P.bins;
  for (int b = threadIdx.x; b < P.bins; b += BT) {
    cp_async4(sr + b, P.fr + row + b);
    cp_async4(si + b, P.fi + row + b);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A persistent block walks the streams s = blockIdx.x + k gridDim.x, two
// blocks an SM where their shared memory fits, so that one block's loads
// and stores run beside the other's transforms.  The next stream's state
// row comes in by cp.async behind this one's last stores, while the next
// stream's first transforms run.
template <bool kCodes>
__global__ void __launch_bounds__(BT, 2) sliding_hop_block_kernel(const BlockParams P) {
  extern __shared__ __align__(16) float2 z[];  // [chunk P] transforms, then the row
  const int t = threadIdx.x;
  const int bins = P.bins, lp = P.log2p, pts = 1 << lp;
  const int lr = P.log2n - lp, R = 1 << lr;  // R = n / P
  const int count = R / 2 + 1;              // transforms r = 0..R/2
  // slot_of permutes aligned groups of 16 points: the transforms' area
  // is rounded up to a multiple of 16 (it differs only where P < 16)
  const int area = (P.chunk * pts + 15) & ~15;
  float* sr = reinterpret_cast<float*>(z + area);  // [bins] state, real
  float* si = sr + bins;                                     // [bins] imaginary

  if (blockIdx.x < P.S) fetch_row(P, blockIdx.x, sr, si);
  for (int s = blockIdx.x; s < P.S; s += gridDim.x) {
    const int next = s + gridDim.x;
    const long long row = (long long)s * bins;
    if (next < P.S && t < 32) {  // the next stream's deltas, into L2
      const char* d = reinterpret_cast<const char*>(P.deltas + (long long)next * P.cols * P.hop);
      for (int o = 128 * t; o < 4 * P.cols * P.hop; o += 128 * 32)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(d + o));
    }

    for (int k = 0; k < P.cols; ++k) {
      const bool slide = k < P.ready;  // uniform across the block
      const float* d = P.deltas + ((long long)s * P.cols + k) * P.hop;
      // the transforms r0..r1-1 at a time, as many as shared memory holds
      for (int r0 = 0; slide && r0 < count; r0 += P.chunk) {
        const int r1 = min(count, r0 + P.chunk);
        // 0. y_r[m] = d[m] e^{-2 pi i m r/n}, m < P
        for (int g = t; g < (r1 - r0) << lp; g += BT) {
          const int m = g & (pts - 1);
          const float dm = m < P.hop ? __ldg(d + m) : 0.f;
          const float2 w = __ldg(P.build_tw + (r0 << lp) + g);
          z[slot_of(g)] = make_float2(dm * w.x, dm * w.y);
        }
        __syncthreads();
        block_fft_dif<BLOCK_MAXB, false>(z, lp, r1 - r0, P.fft_tw);
        if (k == 0 && r0 == 0) {
          asm volatile("cp.async.wait_group 0;\n" ::);
          __syncthreads();
        }
        // 1. slide the bins D[q R + r] = Y_r[q] (r <= R/2) or
        //    conj(Y_{R-r}[P-1-q]) (r > R/2) whose transform is here
        for (int b = t; b < bins; b += BT) {
          const int r = b & (R - 1), q = b >> lr;
          const bool low = 2 * r <= R;
          const int rr = low ? r : R - r;
          if (rr < r0 || rr >= r1) continue;
          float2 dv = z[slot_of(((rr - r0) << lp) + bit_reverse(low ? q : pts - 1 - q, lp))];
          if (!low) dv.y = -dv.y;
          const float rot_r = __ldg(P.rot_r + b), rot_i = __ldg(P.rot_i + b);
          const float tr = sr[b] + dv.x;
          const float ti = si[b] + dv.y;
          sr[b] = tr * rot_r - ti * rot_i;
          si[b] = tr * rot_i + ti * rot_r;
        }
        __syncthreads();  // the transforms are read; the next ones take the buffer
      }
      if (k == 0 && !slide) {
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
      }

      // 2-5. stencil, DC removal, power, out
      const float mean = sr[0] * P.inv_n;
      for (int b = t; b < bins; b += BT) {
        float wr = P.a0 * sr[b];
        float wi = P.a0 * si[b];
#pragma unroll
        for (int j = 1; j <= HALO; ++j) {
          if (j > P.reach) break;
          float lo_r, lo_i, hi_r, hi_i;
          if (b - j >= 0) {
            lo_r = sr[b - j];
            lo_i = si[b - j];
          } else {  // F[-m] = conj(F[m])
            lo_r = sr[j - b];
            lo_i = -si[j - b];
          }
          if (b + j <= bins - 1) {
            hi_r = sr[b + j];
            hi_i = si[b + j];
          } else {  // F[N - m] = conj(F[m]) past Nyquist
            const int m = 2 * (bins - 1) - (b + j);
            hi_r = sr[m];
            hi_i = -si[m];
          }
          wr = wr + P.halves[j - 1] * (lo_r + hi_r);
          wi = wi + P.halves[j - 1] * (lo_i + hi_i);
        }
        if (b < P.dc_bins) wr = wr - mean * __ldg(P.dc_corr + b);
        const float p = (wr * wr + wi * wi) * __ldg(P.norm + b);
        emit<kCodes>(P.out, ((long long)s * P.cols + k) * bins + b, p, P.floor_db,
                     P.store_scale);
      }
      __syncthreads();  // the next column slides the row in place
    }

    for (int b = t; b < bins; b += BT) {
      P.fr_out[row + b] = sr[b];
      P.fi_out[row + b] = si[b];
    }
    __syncthreads();  // the row is read
    if (next < P.S) fetch_row(P, next, sr, si);
  }
}

template <bool kCodes>
int launch_block(const BlockParams& P, size_t smem, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sliding_hop_block_kernel<kCodes>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sliding_hop_block_kernel<kCodes>,
                                                        BT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const int grid = P.S < blocks ? P.S : (int)blocks;
  sliding_hop_block_kernel<kCodes><<<grid, BT, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

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

// Host entry of the whole-row kernel: launches one persistent block an SM
// on `stream` and returns cudaGetLastError().  deltas are [S, cols, hop]
// float32; build_tw the [count P] twiddles exp(-2 pi i m r/n) at r P + m
// (P = hop rounded up to a power of two, count = n/P/2 + 1); fft_tw the
// P-point plan's table; `out` is uint16 codes when emit_codes is nonzero,
// else float32 power.
extern "C" int sliding_hop_block_launch(
    const float* fr, const float* fi, const float* deltas, const float* build_tw,
    const float* fft_tw, const float* rot_r, const float* rot_i, const float* dc_corr,
    const float* norm, float* fr_out, float* fi_out, void* out,
    int S, int cols, int hop, int n, int ready,
    float inv_n, float a0, float h1, float h2, float h3, int reach, int dc_bins,
    float floor_db, float store_scale, int emit_codes, void* stream) {
  if (S == 0) return 0;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  int log2p = 0;
  while ((1 << log2p) < hop) ++log2p;
  if ((1 << log2n) != n || n > BLOCK_MAX_N || hop < 1 || 2 * (1 << log2p) > n ||
      reach > HALO || dc_bins > n / 2 + 1)
    return (int)cudaErrorInvalidValue;
  BlockParams P;
  P.fr = fr; P.fi = fi; P.deltas = deltas;
  P.build_tw = reinterpret_cast<const float2*>(build_tw);
  P.fft_tw = reinterpret_cast<const float2*>(fft_tw);
  P.rot_r = rot_r; P.rot_i = rot_i; P.dc_corr = dc_corr; P.norm = norm;
  P.fr_out = fr_out; P.fi_out = fi_out; P.out = out;
  P.S = S; P.cols = cols; P.hop = hop; P.log2p = log2p; P.log2n = log2n;
  P.bins = n / 2 + 1; P.ready = ready;
  P.inv_n = inv_n; P.a0 = a0;
  P.halves[0] = h1; P.halves[1] = h2; P.halves[2] = h3;
  P.reach = reach; P.dc_bins = dc_bins;
  P.floor_db = floor_db; P.store_scale = store_scale;
  // the state row and as many of the R/2 + 1 transforms of P points as
  // let two blocks share an SM, else as many as one block holds
  // (the transforms' area rounded up to 16 points, as the kernel lays it)
  const int count = (n >> log2p) / 2 + 1;
  const size_t tr = sizeof(float2) << log2p, row = 2 * sizeof(float) * (size_t)P.bins;
  const size_t slack = 15 * sizeof(float2);  // the rounding, at most
  size_t fit = HALF_SMEM > row + slack ? (HALF_SMEM - row - slack) / tr : 0;
  if (fit < 1) fit = (MAX_SMEM - row - slack) / tr;
  P.chunk = fit < (size_t)count ? (int)fit : count;
  if (P.chunk < 1) return (int)cudaErrorInvalidValue;
  const size_t area = (((size_t)P.chunk << log2p) + 15) & ~(size_t)15;
  const size_t smem = sizeof(float2) * area + row;
  const auto st = static_cast<cudaStream_t>(stream);
  return emit_codes ? launch_block<true>(P, smem, st) : launch_block<false>(P, smem, st);
}
