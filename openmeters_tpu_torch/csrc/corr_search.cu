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
// S = 8192 and 3.35 TB/s).  The kernel is bound instead by the instructions
// of its transforms (an n-point forward, an n/2-point inverse) and the
// shared-memory passes they make.  They run on fft_block.cuh: passes of up
// to 16 points in registers (MAXB = 4), one barrier a pass, over its
// swizzled layout (bit-reversed and power-of-two-strided access free of
// bank conflicts), each plan reading its own twiddle table in order
// (ops/block_fft.py).  At n = 8192 the forward runs 4 passes and the
// inverse 3, with the butterflies and twiddle values of radix-2 passes, so
// the transforms round as radix-2 passes do.
//
// Design.  One block per stream, the whole chain in one buffer of
// max(n, wcap + 1) float2 in shared memory up to n = 16384 (96 kHz).  Up to
// n = 8192 a block has 256 threads and an SM holds three (64 KB and at most
// 85 registers each: ptxas gives 80 registers and ~150 bytes of spills,
// which measured faster than two blocks of 256 or 512 threads without
// them); at n = 16384, 512 threads (115 registers) and one block an SM.
// The steps:
//   1. the window (all of it with sums, else its first n points) into
//      registers, 8192 / threads a thread, every load in flight at once:
//      the window is read from device memory once;
//   2. (sums) from those registers, (x, x^2) into the buffer as float2 and
//      an inclusive prefix scan over them (a serial chunk a thread, odd in
//      length so that a half-warp's chunks start in distinct banks; warp
//      shuffles across chunks): sx and sxx are differences of the prefix at
//      o + klen and o, wmean the prefix at wlen -- the JAX package's own
//      cumsum formulation;
//   3. the template into registers, and the window and the template packed
//      as one complex signal work + i * 2^e * tmpl in the swizzled layout,
//      where the power of two 2^e (exact) brings the template's peak to the
//      window's, so that separating the two spectra loses no more precision
//      to the larger one than it must.  At n = 8192 a thread's registers
//      hold whole groups of the forward's first pass, which runs on them
//      before the first store (no packing pass);
//   4. the forward n-point transform (decimation in frequency, natural
//      order in, bit-reversed out);
//   5. per k in [1, n/4] the four bins {k, n - k, k + n/2, n/2 - k}: W and
//      T of the pairs (k, n - k) and (k + n/2, n/2 - k) by Hermitian
//      symmetry, P = W conj(T) e^{+2 pi i k shift / n} (the angle reduced
//      mod n in exact integers, then sincospif of the exact argument
//      2 m / n: no table read at a scattered index), and at once the
//      half-length inverse's input
//        Q[k] = (P[k] + P[k + n/2]) + i e^{2 pi i k / n} (P[k] - P[k + n/2])
//      for k and n/2 - k (P[n - j] = conj P[j]; the twist read in order
//      from the forward plan's table); k = 0 pairs bins 0 and
//      n/2.  The four bins sit at bit-reversed positions 2r, 2r + 1, 2r',
//      2r' + 1 and Q[k], Q[n/2 - k] go to r, r': compacted into points
//      0 .. n/2 - 1 in the inverse's bit-reversed order, read into
//      registers, one barrier, then written;
//   6. the n/2-point inverse (decimation in time, natural order out) of
//      the Hermitian spectrum's real result: point m holds
//      y[2m] + i y[2m + 1];
//   7. dots[o] = y[o] * 2^-e / n for o < out_len.  The inverse is not
//      pruned: its last pass writes all n/2 points, of which the first
//      out_len / 2 are read.
// At n = 32768 (192 kHz) the buffer (256 KB) outgrows shared memory: it
// lives in a global scratch row per block, a grid of one block of 512
// threads per SM taking the streams in turn so that the scratch stays in
// L2, and shared memory holds the prefix sums (wcap + 1 float2) and then
// the half-length inverse's input (128 KB): the forward's 4 passes run over
// L2, the scan and the inverse's 4 passes over shared memory (beyond 227 KB
// either stays in the scratch row).  No six-step layout, no tile grid and
// no separate Nyquist term: those were the TPU's.  All arithmetic is plain
// f32 (no fast math).
#include <cuda_runtime.h>

#include "fft_block.cuh"

namespace {

// Threads a block: 256 up to n = 8192, three blocks an SM (64 KB of shared
// memory and at most 85 registers each); 512 above, one block an SM.
constexpr int SMALL_THREADS = 256, SMALL_BLOCKS = 3;
constexpr int LARGE_THREADS = 512;
constexpr int MAXB = 4;           // radix-2 stages a pass: 16 points in registers
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may opt into
constexpr int MAX_DYN = MAX_SMEM - 256;  // of them dynamic, beside warp_tot

struct Params {
  const float* src;      // [S, src_len]: ring rows or work rows
  const int* starts;     // [S] window starts into src, or null (0)
  const float* tmpl;     // [S, tmpl_len]
  const int* klen;       // [S]
  const int* wlen;       // [S]
  const int* shift;      // [S]
  const float2* dif_tw;  // the n-point forward plan's table (ops/block_fft.py)
  const float2* dit_tw;  // the n/2-point inverse plan's table
  float* dots;           // [S, out_len]
  float* sx;             // [S, out_len]
  float* sxx;            // [S, out_len]
  float* wmean;          // [S]
  float2* scratch;       // [gridDim.x, stride] buffers in global memory, or null (shared)
  long long words, stride;
  int ab_shared, q_shared;  // with scratch: the prefix sums, the inverse's input in shared memory
  int rows, src_len, wcap, tmpl_len, n, log2n, out_len, sums;
};

// Inclusive prefix sums in place over ab[1..len], both components (ab[0]
// holds 0).  Each thread sums one contiguous chunk of an odd number of
// points, so that 16 threads' float2 reads fall in 16 distinct bank pairs;
// the chunk totals are scanned across the block, and each thread rewrites
// its chunk.
__device__ __forceinline__ void block_prefix2(float2* ab, int len, float* warp_tot) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const int chunk = ((len + nt - 1) / nt) | 1;
  const int lo = min(1 + t * chunk, len + 1);
  const int hi = min(lo + chunk, len + 1);
  float sa = 0.f, sb = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float2 v = ab[i];
    sa += v.x;
    sb += v.y;
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
    const float2 v = ab[i];
    oa += v.x;
    ob += v.y;
    ab[i] = make_float2(oa, ob);
  }
  __syncthreads();
}

// Block-wide maxima of two non-negative values, returned to every thread.
__device__ __forceinline__ float2 block_max2(float x, float y, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, d));
    y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, d));
  }
  __syncthreads();  // warp_tot and the buffer may still be read by a previous step
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

// W conj(T) of the bin pair (Z[k], Z[n - k]) of work + i tmpl.
__device__ __forceinline__ float2 cross(float2 zk, float2 zm) {
  const float wr = 0.5f * (zk.x + zm.x), wi = 0.5f * (zk.y - zm.y);
  const float tr = 0.5f * (zk.y + zm.y), ti = -0.5f * (zk.x - zm.x);
  return make_float2(wr * tr + wi * ti, wi * tr - wr * ti);
}

// The half-length inverse's input from lo = P[k], hi = P[k + n/2] and the
// twist e^{+2 pi i k / n}: (lo + hi) + i tw (lo - hi).
__device__ __forceinline__ float2 fold(float2 lo, float2 hi, float2 tw) {
  const float2 d = bmul(tw, bsub(lo, hi));
  return make_float2(lo.x + hi.x - d.y, lo.y + hi.y + d.x);
}

// Step 5 for k in [1, n/4]: Q[k] and Q[n/2 - k] (to points
// bit_reverse(k, L) >> 1 and bit_reverse(n - k, L) >> 1).  The twist
// e^{+2 pi i k / n} is the conjugate of the forward plan's entry k: the
// plan's first stage (span n) lists exp(-2 pi i k / n), k < n/2, in order.
__device__ __forceinline__ void split_item(const float2* z, const float2* dif_tw, int k, int n, int L,
                                           int sh, float sgn, float two_n, float2& qa, float2& qb) {
  const int ra = bit_reverse(k, L), rb = bit_reverse(n - k, L);
  const float2 za = z[slot_of(ra)], za2 = z[slot_of(ra + 1)];   // Z[k], Z[k + n/2]
  const float2 zb = z[slot_of(rb)], zb2 = z[slot_of(rb - 1)];   // Z[n - k], Z[n/2 - k]
  float s1, c1;
  const unsigned m = ((unsigned)k * (unsigned)sh) & (unsigned)(n - 1);  // (k shift) mod n
  sincospif((float)m * two_n, &s1, &c1);
  const float2 w = __ldg(dif_tw + k);
  const float c2 = w.x, s2 = -w.y;
  const float2 pk = bmul(cross(za, zb), make_float2(c1, s1));
  const float2 pk2 = bmul(cross(za2, zb2), make_float2(sgn * c1, sgn * s1));  // e^{i pi shift}
  qa = fold(pk, pk2, make_float2(c2, s2));
  qb = fold(make_float2(pk2.x, -pk2.y), make_float2(pk.x, -pk.y), make_float2(-c2, s2));
}

__device__ __forceinline__ void split_store(float2* q, int k, int n, int L, float2 qa, float2 qb) {
  q[slot_of(bit_reverse(k, L) >> 1)] = qa;
  if (k != n >> 2) q[slot_of(bit_reverse(n - k, L) >> 1)] = qb;
}

// Step 3 and the forward's first pass at n = 8192 (4 stages, Q = 512): a
// thread's registers hold whole groups of that pass -- group g = t + h
// kThreads is the points g + 512 j, held at it = h + j (512 / kThreads) --
// so the packed signal goes through the pass's butterflies before its
// first store.
template <int kThreads, int PER>
__device__ __forceinline__ void pack_first_pass(float2* z, const float (&wv)[PER], const float (&tv)[PER],
                                                int nw, float bal, const float2* ptw) {
  constexpr int G = 512 / kThreads, Q = 512;
  static_assert(PER == 16 * G, "registers hold whole groups");
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const int g = threadIdx.x + h * kThreads;
    float2 x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) x[j] = make_float2(g + j * Q < nw ? wv[h + j * G] : 0.f, tv[h + j * G] * bal);
    dif_group<4, false>(x, g, Q, ptw);
#pragma unroll
    for (int j = 0; j < 16; ++j) z[slot_of(g + j * Q)] = x[j];
  }
  __syncthreads();
}

// The whole chain for stream s: the buffer z, the prefix sums ab, the
// inverse's input q.  kStage > 0: ab and q are z, and step 5 stages its
// results in registers (kStage items a thread) across a barrier; 0: q is a
// separate buffer.
template <int kThreads, int kStage>
__device__ __forceinline__ void corr_search_row(const Params& P, int s, float2* z, float2* ab,
                                                float2* q, float* warp_tot) {
  constexpr int PER = 8192 / kThreads;  // window and template points a thread holds
  const int t = threadIdx.x;
  const int n = P.n, L = P.log2n, wl = P.wcap;
  int start = 0;
  if (P.starts != nullptr) start = min(max(P.starts[s], 0), P.src_len - wl);
  const float* work = P.src + (long long)s * P.src_len + start;
  const float* tm = P.tmpl + (long long)s * P.tmpl_len;
  const long long o0 = (long long)s * P.out_len;
  const int nw = min(wl, n), ntm = min(P.tmpl_len, n);

  // 1. the window into registers (points past 8192 are read where they
  //    are used)
  const int lim = P.sums ? wl : nw;
  float wv[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int j = t + it * kThreads;
    wv[it] = j < lim ? __ldg(work + j) : 0.f;
  }
  float mw = 0.f, mt = 0.f;
#pragma unroll
  for (int it = 0; it < PER; ++it)
    if (t + it * kThreads < nw) mw = fmaxf(mw, fabsf(wv[it]));
#pragma unroll 4
  for (int j = t + 8192; j < nw; j += kThreads) mw = fmaxf(mw, fabsf(work[j]));

  // 2. exact sliding sums from the window's prefix sums
  if (P.sums) {
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int j = t + it * kThreads;
      if (j < wl) ab[j + 1] = make_float2(wv[it], wv[it] * wv[it]);
    }
#pragma unroll 4
    for (int j = t + 8192; j < wl; j += kThreads) {
      const float v = work[j];
      ab[j + 1] = make_float2(v, v * v);
    }
    if (t == 0) ab[0] = make_float2(0.f, 0.f);
    __syncthreads();
    block_prefix2(ab, wl, warp_tot);
    const int kl = min(max(P.klen[s], 0), wl + 1 - P.out_len);
    for (int o = t; o < P.out_len; o += kThreads) {
      const float2 hi = ab[o + kl], lo = ab[o];
      P.sx[o0 + o] = hi.x - lo.x;
      P.sxx[o0 + o] = hi.y - lo.y;
    }
    if (t == 0) {
      const int w = P.wlen[s];
      const float total = (w >= 0 && w <= wl) ? ab[w].x : 0.f;
      P.wmean[s] = total / fmaxf((float)w, 1.f);
    }
  }

  // 3-4. the template into registers, work + i 2^e tmpl in the swizzled
  //      layout, and the forward transform (block_max2's barriers end step
  //      2's reads of the buffer)
  float tv[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int j = t + it * kThreads;
    tv[it] = j < ntm ? __ldg(tm + j) : 0.f;
    mt = fmaxf(mt, fabsf(tv[it]));
  }
#pragma unroll 4
  for (int j = t + 8192; j < ntm; j += kThreads) mt = fmaxf(mt, fabsf(tm[j]));
  const float2 peaks = block_max2(mw, mt, warp_tot);
  int e = 0;
  if (peaks.x > 0.f && peaks.y > 0.f) e = min(max(ilogbf(peaks.x) - ilogbf(peaks.y), -64), 64);
  const float bal = ldexpf(1.f, e);
  if (n == 8192) {
    pack_first_pass<kThreads>(z, wv, tv, nw, bal, P.dif_tw);
    block_fft_dif<MAXB, false>(z, L, 1, P.dif_tw, 1);
  } else {
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int j = t + it * kThreads;
      if (j < n) z[slot_of(j)] = make_float2(j < nw ? wv[it] : 0.f, tv[it] * bal);
    }
#pragma unroll 4
    for (int j = t + 8192; j < n; j += kThreads)
      z[slot_of(j)] = make_float2(j < nw ? work[j] : 0.f, j < ntm ? tm[j] * bal : 0.f);
    __syncthreads();
    block_fft_dif<MAXB, false>(z, L, 1, P.dif_tw);
  }

  // 5. the products and the half-length inverse's input
  const int sh = P.shift[s];
  const float sgn = (sh & 1) ? -1.f : 1.f;
  const float two_n = ldexpf(1.f, 1 - L);
  const int quarter = n >> 2;
  float2 q0 = make_float2(0.f, 0.f);
  if (t == 0) {  // k = 0: bins 0 and n/2, each its own pair, at positions 0 and 1
    const float2 p0 = cross(z[0], z[0]), p1 = cross(z[1], z[1]);
    q0 = fold(p0, make_float2(sgn * p1.x, sgn * p1.y), make_float2(1.f, 0.f));
  }
  if constexpr (kStage > 0) {
    float2 qa[kStage], qb[kStage];
#pragma unroll
    for (int it = 0; it < kStage; ++it) {
      const int k = 1 + t + it * kThreads;
      if (k <= quarter) split_item(z, P.dif_tw, k, n, L, sh, sgn, two_n, qa[it], qb[it]);
    }
    __syncthreads();
    if (t == 0) q[0] = q0;
#pragma unroll
    for (int it = 0; it < kStage; ++it) {
      const int k = 1 + t + it * kThreads;
      if (k <= quarter) split_store(q, k, n, L, qa[it], qb[it]);
    }
  } else {
    if (t == 0) q[0] = q0;
    for (int k = 1 + t; k <= quarter; k += kThreads) {
      float2 qa, qb;
      split_item(z, P.dif_tw, k, n, L, sh, sgn, two_n, qa, qb);
      split_store(q, k, n, L, qa, qb);
    }
  }
  __syncthreads();

  // 6. the half-length inverse
  block_fft_dit<MAXB, true>(q, L - 1, 1, P.dit_tw);

  // 7. y[2m] and y[2m + 1] are the real and imaginary parts of point m
  const float scale = ldexpf(1.f, -(e + L));
  for (int o = t; o < P.out_len; o += kThreads) {
    const float2 y = q[slot_of(o >> 1)];
    P.dots[o0 + o] = ((o & 1) ? y.y : y.x) * scale;
  }
}

// kStage > 0: one block per stream, its buffer in shared memory, kStage
// items a thread staged in step 5 (n/4 over the threads).  0: each block's
// buffer is its scratch row, the inverse's input in shared memory (or
// behind the buffer in the row), and the blocks take the streams in turn.
template <int kThreads, int kBlocks, int kStage>
__global__ void __launch_bounds__(kThreads, kBlocks) corr_search_kernel(const Params P) {
  extern __shared__ __align__(16) float2 smem[];
  __shared__ float warp_tot[64];
  if constexpr (kStage > 0) {
    corr_search_row<kThreads, kStage>(P, blockIdx.x, smem, smem, smem, warp_tot);
  } else {
    float2* z = P.scratch + blockIdx.x * P.stride;
    float2* ab = P.ab_shared ? smem : z;
    float2* q = P.q_shared ? smem : z + P.words;
    for (int s = blockIdx.x; s < P.rows; s += gridDim.x) {
      corr_search_row<kThreads, 0>(P, s, z, ab, q, warp_tot);
      __syncthreads();  // the next stream overwrites z, ab and q
    }
  }
}

template <int kThreads, int kBlocks, int kStage>
int launch(const Params& P, int grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(corr_search_kernel<kThreads, kBlocks, kStage>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  corr_search_kernel<kThreads, kBlocks, kStage><<<grid, kThreads, smem, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry on `stream`.  Without `scratch`, one block per stream with its
// buffer in shared memory; with it (`grid` rows of max(n, wcap + 1) float2,
// plus n/2 where the inverse's input outgrows shared memory), `grid` blocks
// with their buffers there.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int corr_search_launch(
    const float* src, const int* starts, const float* tmpl,
    const int* klen, const int* wlen, const int* shift, const float* dif_tw, const float* dit_tw,
    float* dots, float* sx, float* sxx, float* wmean, float* scratch, int grid,
    int rows, int src_len, int wcap, int tmpl_len, int n, int out_len, int sums,
    void* stream) {
  if (rows == 0) return 0;
  int log2n = 0;
  while (log2n < 30 && (1 << log2n) < n) ++log2n;
  const size_t words = (size_t)(sums && wcap + 1 > n ? wcap + 1 : n);
  const bool q_shared = sizeof(float2) * (size_t)(n / 2) <= (size_t)MAX_DYN;
  const bool ab_shared = sums && sizeof(float2) * (size_t)(wcap + 1) <= (size_t)MAX_DYN;
  size_t smem = sizeof(float2) * words;
  if (scratch != nullptr) {
    smem = q_shared ? sizeof(float2) * (size_t)(n / 2) : 0;
    if (ab_shared && sizeof(float2) * (size_t)(wcap + 1) > smem) smem = sizeof(float2) * (size_t)(wcap + 1);
  }
  if (n < 16 || (1 << log2n) != n || smem > (size_t)MAX_DYN || out_len < 1 || out_len > n ||
      wcap < 1 || wcap > src_len || tmpl_len < 1 || (sums && out_len > wcap + 1) ||
      (scratch != nullptr && grid < 1))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.src = src; P.starts = starts; P.tmpl = tmpl;
  P.klen = klen; P.wlen = wlen; P.shift = shift;
  P.dif_tw = reinterpret_cast<const float2*>(dif_tw);
  P.dit_tw = reinterpret_cast<const float2*>(dit_tw);
  P.dots = dots; P.sx = sx; P.sxx = sxx; P.wmean = wmean;
  P.scratch = reinterpret_cast<float2*>(scratch);
  P.words = (long long)words;
  P.stride = (long long)words + (q_shared ? 0 : n / 2);
  P.ab_shared = ab_shared;
  P.q_shared = q_shared;
  P.rows = rows; P.src_len = src_len; P.wcap = wcap; P.tmpl_len = tmpl_len;
  P.n = n; P.log2n = log2n; P.out_len = out_len; P.sums = sums;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) return launch<LARGE_THREADS, 1, 0>(P, grid, smem, st);
  if (n <= 8192) return launch<SMALL_THREADS, SMALL_BLOCKS, 2048 / SMALL_THREADS>(P, rows, smem, st);
  return launch<LARGE_THREADS, 1, 4096 / LARGE_THREADS>(P, rows, smem, st);
}
