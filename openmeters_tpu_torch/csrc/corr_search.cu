// The oscilloscope trigger's correlation search for Hopper (sm_90a).
//
// Replaces openmeters_tpu/ops/pallas_corr.py: corr_dots_sums_ring (B4, work
// window read from the mirrored history ring), corr_dots_sums (B5, work
// rows given) and corr_dots (B6, no sums) -- one kernel, with the source of
// the window and the sums as launch arguments.  Per stream s, for offsets
// o < out_len:
//
//   dots[s, o]  = sum_k work[s, (o + shift[s] + k) mod n] * tmpl[s, k]
//   sx[s, o]    = sum_{k < klen[s]} work[s, o + k]
//   sxx[s, o]   = sum_{k < klen[s]} work[s, o + k]^2
//   wmean[s]    = sum_{i < wlen[s]} work[s, i] / max(wlen[s], 1)
//
// with work[s, j] = src[s, start[s] + j] for j < wcap (start clipped to
// [0, src_len - wcap]; 0 without starts), zero from wcap to the transform
// length n.
//
// What bounds it: the card's floor is the bytes (one window and one
// template read, three [out_len] rows written: ~77 KB a stream, 0.19 ms at
// S = 8192 and 3.35 TB/s).  This version is bound by shared-memory passes
// instead: an n-point forward and an n/2-point inverse transform, two
// radix-2 stages a pass, 13 passes over a 64 KB buffer at n = 8192.
//
// Design.  One block per stream, the whole chain in one buffer of
// max(n, wcap + 1) complex f32: in shared memory up to n = 16384 (96 kHz);
// above that (n = 32768 at 192 kHz, 256 KB) in a global scratch row per
// block, a grid of one block per SM taking the streams in turn so that the
// scratch stays in L2.  The steps:
//   1. (sums) the window and its square into two prefix arrays, scanned by
//      the block (a serial chunk a thread, warp shuffles across chunks):
//      sx and sxx are differences of the prefix at o + klen and o, wmean
//      the prefix at wlen -- the JAX package's own cumsum formulation;
//   2. the window and the template packed as one complex signal
//      work + i * 2^e * tmpl, where the power of two 2^e (exact) brings the
//      template's peak to the window's, so that separating the two spectra
//      loses no more precision to the larger one than it must;
//   3. one forward n-point FFT (decimation in frequency, bit-reversed out);
//   4. per bin pair (k, n - k): W and T by Hermitian symmetry, the product
//      P = W conj(T) e^{+2 pi i k shift / n} (the phase from the twiddle
//      table at (k * shift) mod n, reduced in exact integers), written to k
//      and its conjugate to n - k;
//   5. the inverse of a Hermitian spectrum is real, so it runs at half
//      length: Q[k] = (P[k] + P[k + n/2]) + i e^{2 pi i k / n}
//      (P[k] - P[k + n/2]), k < n/2, transforms to y[2m] + i y[2m + 1].
//      In the bit-reversed layout P[k] and P[k + n/2] sit side by side at
//      2r and 2r + 1 (r the bit reversal of k over log2 n - 1 bits), so
//      Q[k] replaces P[k] in place and the n/2-point inverse (decimation in
//      time, natural out) runs over the even slots;
//   6. dots[o] = y[o] * 2^-e / n for o < out_len.
// No six-step layout, no tile grid and no separate Nyquist term: those were
// the TPU's.  All arithmetic is plain f32 (no fast math).
#include <cuda_runtime.h>

#include "fft_radix2.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may opt into

struct Params {
  const float* src;    // [S, src_len]: ring rows or work rows
  const int* starts;   // [S] window starts into src, or null (0)
  const float* tmpl;   // [S, tmpl_len]
  const int* klen;     // [S]
  const int* wlen;     // [S]
  const int* shift;    // [S]
  const float2* tw;    // [n/2] exp(-2 pi i k / n)
  float* dots;         // [S, out_len]
  float* sx;           // [S, out_len]
  float* sxx;          // [S, out_len]
  float* wmean;        // [S]
  float2* scratch;     // [gridDim.x, words] buffers in global memory, or null (shared)
  long long words;
  int rows, src_len, wcap, tmpl_len, n, log2n, out_len, sums;
};

// Inclusive prefix sums in place over a[1..len] and b[1..len] (a[0] and b[0]
// hold 0).  Each thread sums one contiguous chunk, the chunk totals are
// scanned across the block, and each thread rewrites its chunk.
__device__ void block_prefix2(float* a, float* b, int len, float* warp_tot) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const int chunk = (len + nt - 1) / nt;
  const int lo = 1 + t * chunk;
  const int hi = min(lo + chunk, len + 1);
  float sa = 0.f, sb = 0.f;
  for (int i = lo; i < hi; ++i) {
    sa += a[i];
    sb += b[i];
  }
  float ia = sa, ib = sb;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ya = __shfl_up_sync(0xffffffffu, ia, d);
    const float yb = __shfl_up_sync(0xffffffffu, ib, d);
    if (lane >= d) {
      ia += ya;
      ib += yb;
    }
  }
  float ea = __shfl_up_sync(0xffffffffu, ia, 1);  // exclusive within the warp
  float eb = __shfl_up_sync(0xffffffffu, ib, 1);
  if (lane == 0) ea = eb = 0.f;
  if (lane == 31) {
    warp_tot[warp] = ia;
    warp_tot[32 + warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    float va = lane < nwarps ? warp_tot[lane] : 0.f;
    float vb = lane < nwarps ? warp_tot[32 + lane] : 0.f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ya = __shfl_up_sync(0xffffffffu, va, d);
      const float yb = __shfl_up_sync(0xffffffffu, vb, d);
      if (lane >= d) {
        va += ya;
        vb += yb;
      }
    }
    if (lane < nwarps) {
      warp_tot[lane] = va;
      warp_tot[32 + lane] = vb;
    }
  }
  __syncthreads();
  float oa = ea + (warp > 0 ? warp_tot[warp - 1] : 0.f);
  float ob = eb + (warp > 0 ? warp_tot[32 + warp - 1] : 0.f);
  for (int i = lo; i < hi; ++i) {
    oa += a[i];
    a[i] = oa;
    ob += b[i];
    b[i] = ob;
  }
  __syncthreads();
}

// Block-wide maxima of two non-negative values, returned to every thread.
__device__ float2 block_max2(float x, float y, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, d));
    y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, d));
  }
  __syncthreads();  // warp_tot may still be read by a previous step
  if (lane == 0) {
    warp_tot[warp] = x;
    warp_tot[32 + warp] = y;
  }
  __syncthreads();
  float mx = 0.f, my = 0.f;
  for (int w = 0; w < nwarps; ++w) {
    mx = fmaxf(mx, warp_tot[w]);
    my = fmaxf(my, warp_tot[32 + w]);
  }
  return make_float2(mx, my);
}

// e^{+2 pi i m / n} for m in [0, n) from tw[k] = e^{-2 pi i k / n}, k < n/2.
__device__ __forceinline__ float2 phase_plus(const float2* tw, int m, int half) {
  if (m < half) {
    const float2 w = __ldg(tw + m);
    return make_float2(w.x, -w.y);
  }
  const float2 w = __ldg(tw + (m - half));
  return make_float2(-w.x, w.y);
}

// The whole chain for stream s, in the buffer z.
__device__ __forceinline__ void corr_search_row(const Params& P, int s, float2* z,
                                                float* warp_tot) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int n = P.n, wl = P.wcap;
  int start = 0;
  if (P.starts != nullptr) start = min(max(P.starts[s], 0), P.src_len - wl);
  const float* work = P.src + (long long)s * P.src_len + start;
  const float* tm = P.tmpl + (long long)s * P.tmpl_len;
  const long long o0 = (long long)s * P.out_len;

  // 1. exact sliding sums from the window's prefix sums
  if (P.sums) {
    float* a = reinterpret_cast<float*>(z);
    float* b = a + (wl + 1);
    for (int j = t; j < wl; j += nt) {
      const float v = work[j];
      a[j + 1] = v;
      b[j + 1] = v * v;
    }
    if (t == 0) a[0] = b[0] = 0.f;
    __syncthreads();
    block_prefix2(a, b, wl, warp_tot);
    const int kl = min(max(P.klen[s], 0), wl + 1 - P.out_len);
    for (int o = t; o < P.out_len; o += nt) {
      P.sx[o0 + o] = a[o + kl] - a[o];
      P.sxx[o0 + o] = b[o + kl] - b[o];
    }
    if (t == 0) {
      const int w = P.wlen[s];
      const float total = (w >= 0 && w <= wl) ? a[w] : 0.f;
      P.wmean[s] = total / fmaxf((float)w, 1.f);
    }
    __syncthreads();
  }

  // 2. work + i * tmpl, then the power of two that balances them
  const int nw = min(wl, n), ntm = min(P.tmpl_len, n);
  float mw = 0.f, mt = 0.f;
  for (int j = t; j < n; j += nt) {
    const float w = j < nw ? work[j] : 0.f;
    const float v = j < ntm ? tm[j] : 0.f;
    z[j] = make_float2(w, v);
    mw = fmaxf(mw, fabsf(w));
    mt = fmaxf(mt, fabsf(v));
  }
  const float2 peaks = block_max2(mw, mt, warp_tot);
  int e = 0;
  if (peaks.x > 0.f && peaks.y > 0.f) e = min(max(ilogbf(peaks.x) - ilogbf(peaks.y), -64), 64);
  if (e != 0) {
    for (int j = t; j < n; j += nt) z[j].y = ldexpf(z[j].y, e);
  }
  __syncthreads();

  // 3. forward transform
  fft_dif4(z, P.log2n, 1, P.tw, P.log2n, false);

  // 4. W conj(T) times the anchor phase, on the bit-reversed spectrum
  const int half = n >> 1;
  const int sh = P.shift[s];
  const unsigned rshift = 32u - (unsigned)P.log2n;
  for (int k = t; k <= half; k += nt) {
    const int km = (n - k) & (n - 1);
    const int pk = (int)(__brev((unsigned)k) >> rshift);
    const int pm = (int)(__brev((unsigned)km) >> rshift);
    const float2 zk = z[pk], zm = z[pm];
    const float wr = 0.5f * (zk.x + zm.x), wi = 0.5f * (zk.y - zm.y);
    const float tr = 0.5f * (zk.y + zm.y), ti = -0.5f * (zk.x - zm.x);
    const float2 c = make_float2(wr * tr + wi * ti, wi * tr - wr * ti);
    int m = (int)(((long long)k * sh) % n);
    if (m < 0) m += n;
    const float2 p = cmul(c, phase_plus(P.tw, m, half));
    z[pk] = p;
    z[pm] = make_float2(p.x, -p.y);
  }
  __syncthreads();

  // 5. the half-length inverse over the even slots
  const unsigned rshift2 = rshift + 1u;
  for (int r = t; r < half; r += nt) {
    const int k = (int)(__brev((unsigned)r) >> rshift2);
    const float2 lo = z[2 * r], hi = z[2 * r + 1];
    const float2 d = cmul(phase_plus(P.tw, k, half), csub(lo, hi));
    z[2 * r] = make_float2(lo.x + hi.x - d.y, lo.y + hi.y + d.x);
  }
  __syncthreads();
  fft_dit4(z, P.log2n - 1, 1, P.tw, P.log2n, true, 1);

  // 6. y[2m] and y[2m + 1] are the real and imaginary parts of slot 2m
  const float scale = ldexpf(1.f, -(e + P.log2n));
  for (int o = t; o < P.out_len; o += nt) {
    const float2 w = z[o & ~1];
    P.dots[o0 + o] = ((o & 1) ? w.y : w.x) * scale;
  }
}

// kScratch false: one block per stream, its buffer in shared memory.  True:
// each block's buffer is its scratch row, and the blocks take the streams
// in turn.
template <bool kScratch>
__global__ void __launch_bounds__(THREADS) corr_search_kernel(const Params P) {
  extern __shared__ __align__(16) float2 smem[];  // [words]
  __shared__ float warp_tot[64];
  if (!kScratch) {
    corr_search_row(P, blockIdx.x, smem, warp_tot);
    return;
  }
  float2* z = P.scratch + blockIdx.x * P.words;
  for (int s = blockIdx.x; s < P.rows; s += gridDim.x) {
    corr_search_row(P, s, z, warp_tot);
    __syncthreads();  // the next stream overwrites z
  }
}

}  // namespace

// Host entry on `stream`.  Without `scratch`, one block per stream with its
// buffer in shared memory; with it (`grid` rows of max(n, wcap + 1) float2),
// `grid` blocks with their buffers there.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int corr_search_launch(
    const float* src, const int* starts, const float* tmpl,
    const int* klen, const int* wlen, const int* shift, const float* tw,
    float* dots, float* sx, float* sxx, float* wmean, float* scratch, int grid,
    int rows, int src_len, int wcap, int tmpl_len, int n, int out_len, int sums,
    void* stream) {
  if (rows == 0) return 0;
  int log2n = 0;
  while (log2n < 30 && (1 << log2n) < n) ++log2n;
  const size_t words = (size_t)(sums && wcap + 1 > n ? wcap + 1 : n);
  const size_t smem = scratch != nullptr ? 0 : sizeof(float2) * words;
  if (n < 16 || (1 << log2n) != n || smem > (size_t)MAX_SMEM || out_len < 1 || out_len > n ||
      wcap < 1 || wcap > src_len || tmpl_len < 1 || (sums && out_len > wcap + 1) ||
      (scratch != nullptr && grid < 1))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.src = src; P.starts = starts; P.tmpl = tmpl;
  P.klen = klen; P.wlen = wlen; P.shift = shift;
  P.tw = reinterpret_cast<const float2*>(tw);
  P.dots = dots; P.sx = sx; P.sxx = sxx; P.wmean = wmean;
  P.scratch = reinterpret_cast<float2*>(scratch);
  P.words = (long long)words;
  P.rows = rows; P.src_len = src_len; P.wcap = wcap; P.tmpl_len = tmpl_len;
  P.n = n; P.log2n = log2n; P.out_len = out_len; P.sums = sums;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    corr_search_kernel<true><<<grid, THREADS, 0, st>>>(P);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      corr_search_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  corr_search_kernel<false><<<rows, THREADS, smem, st>>>(P);
  return (int)cudaGetLastError();
}
