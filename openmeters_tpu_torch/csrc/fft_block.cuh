// Register-resident complex f32 FFTs for one thread block, over a buffer in
// shared memory.
//
// Used by reassigned_columns.cu (B3), sliding_hop.cu (B1b) and
// corr_search.cu (B4-B6).  A pass takes r radix-2 stages at once (r <= MAXB,
// a template argument of the plan): each thread loads a group of 2^r points
// into registers, runs the r stages' butterflies and twiddles there, and
// writes them back, so a transform of 2^L points takes ceil(L / MAXB)
// passes, each ending in one __syncthreads().  The butterflies are those of
// the radix-2 transforms, in the same order and with the same twiddles, so
// the rounding is that of radix-2 passes.  The buffer may be in shared or
// in global memory: the barrier orders both within the block.
//
// Layout.  Point i of the buffer lives at slot_of(i): its low four bits
// XOR the fold of the higher nibbles, (i ^ i>>4 ^ i>>8 ^ i>>12) & 15, so
// that 16 points at any power-of-two stride -- a half-warp's reads in every
// pass, and 16 consecutive indices in bit-reversed order -- fall in 16
// distinct float2 slots of the 32 banks, with no padding: a buffer of N
// points takes N float2.
//
// Twiddles.  Each plan reads its own table (ops/block_fft.py,
// plan_twiddles): for every pass, stage and butterfly j' of the stage, the
// Q values exp(-2 pi i (q + j' Q) / span) of the group offsets q < Q, q
// innermost, so a warp's threads (consecutive q) read consecutive entries
// where a strided read of one full table would touch a cache line each.
// The values are computed in double on the host and stored as f32, equal
// to the entries of the full table exp(-2 pi i k / T) (no __sinf/__cosf,
// no fast math); the inverse conjugates them.  Each call runs `count`
// consecutive transforms (transform c at points [c N, (c + 1) N)).
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int slot_of(int i) { return i ^ (((i >> 4) ^ (i >> 8) ^ (i >> 12)) & 15); }

__device__ __forceinline__ float2 bmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 badd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 bsub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

template <bool kInverse>
__device__ __forceinline__ float2 block_twiddle(const float2* ptw, int k) {
  float2 w = __ldg(ptw + k);
  if (kInverse) w.y = -w.y;
  return w;
}

// r stages of decimation in frequency on one group in registers: x[j] is
// point b + j Q, q = b mod Q, ptw the pass's table.
template <int r, bool kInverse>
__device__ __forceinline__ void dif_group(float2 (&x)[1 << r], int q, int Q, const float2* ptw) {
  constexpr int R = 1 << r;
  int off = q;  // stage s, butterfly j': entry off + j' Q
#pragma unroll
  for (int s = 0; s < r; ++s) {
    const int half = R >> (s + 1);  // the span 2 Q half
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & half) continue;
      const float2 w = block_twiddle<kInverse>(ptw, off + (j & (half - 1)) * Q);
      const float2 u = x[j], v = x[j + half];
      x[j] = badd(u, v);
      x[j + half] = bmul(bsub(u, v), w);
    }
    off += half * Q;
  }
}

// r stages of decimation in frequency, half-spans 2^(lq + r - 1) down to
// 2^lq: group {b + j Q}, Q = 2^lq, j < 2^r.
template <int r, bool kInverse>
__device__ void dif_pass(float2* z, int lq, int groups, const float2* ptw) {
  constexpr int R = 1 << r;
  const int Q = 1 << lq;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int q = g & (Q - 1);
    const int b = ((g >> lq) << (lq + r)) | q;
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = z[slot_of(b + j * Q)];
    dif_group<r, kInverse>(x, q, Q, ptw);
#pragma unroll
    for (int j = 0; j < R; ++j) z[slot_of(b + j * Q)] = x[j];
  }
  __syncthreads();
}

// r stages of decimation in time, half-spans 2^l0 up to 2^(l0 + r - 1):
// group {b + j Q}, Q = 2^l0, j < 2^r.
template <int r, bool kInverse>
__device__ void dit_pass(float2* z, int l0, int groups, const float2* ptw) {
  constexpr int R = 1 << r;
  const int Q = 1 << l0;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int q = g & (Q - 1);
    const int b = ((g >> l0) << (l0 + r)) | q;
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = z[slot_of(b + j * Q)];
    int off = q;  // stage s, butterfly j': entry off + j' Q
#pragma unroll
    for (int s = 0; s < r; ++s) {
      const int half = 1 << s;  // the span 2 Q half
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j & half) continue;
        const float2 w = block_twiddle<kInverse>(ptw, off + (j & (half - 1)) * Q);
        const float2 t = bmul(x[j + half], w);
        const float2 u = x[j];
        x[j] = badd(u, t);
        x[j + half] = bsub(u, t);
      }
      off += half * Q;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) z[slot_of(b + j * Q)] = x[j];
  }
  __syncthreads();
}

// The stages of pass i of a plan: log2N split into ceil(log2N / MAXB)
// passes, the first ones one stage longer where it does not divide.
template <int MAXB>
__device__ __forceinline__ int pass_bits(int log2N, int i) {
  const int passes = (log2N + MAXB - 1) / MAXB;
  return log2N / passes + (i < log2N % passes ? 1 : 0);
}

// `count` transforms of 2^log2N points: natural order in, bit-reversed out.
// ptw: the plan's table, plan_twiddles(log2N, MAXB, dit=False).  The first
// `done` passes are skipped (the caller ran them).
template <int MAXB, bool kInverse>
__device__ void block_fft_dif(float2* z, int log2N, int count, const float2* ptw, int done = 0) {
  static_assert(MAXB >= 1 && MAXB <= 4, "passes of 2 to 16 points");
  if (log2N <= 0) return;
  const int passes = (log2N + MAXB - 1) / MAXB;
  int top = log2N;  // stages left, from the largest span down
  for (int i = 0; i < passes; ++i) {
    const int r = pass_bits<MAXB>(log2N, i);
    const int lq = top - r;
    const int groups = count << (log2N - r);
    if (i >= done) switch (r) {
      case 1: dif_pass<1, kInverse>(z, lq, groups, ptw); break;
      case 2: dif_pass<2, kInverse>(z, lq, groups, ptw); break;
      case 3: if constexpr (MAXB >= 3) dif_pass<3, kInverse>(z, lq, groups, ptw); break;
      default: if constexpr (MAXB >= 4) dif_pass<4, kInverse>(z, lq, groups, ptw); break;
    }
    ptw += ((1 << r) - 1) << lq;
    top = lq;
  }
}

// `count` transforms of 2^log2N points: bit-reversed order in, natural out.
// ptw: the plan's table, plan_twiddles(log2N, MAXB, dit=True).
template <int MAXB, bool kInverse>
__device__ void block_fft_dit(float2* z, int log2N, int count, const float2* ptw) {
  static_assert(MAXB >= 1 && MAXB <= 4, "passes of 2 to 16 points");
  if (log2N <= 0) return;
  const int passes = (log2N + MAXB - 1) / MAXB;
  int l0 = 0;  // stages done, from the smallest span up
  for (int i = 0; i < passes; ++i) {
    const int r = pass_bits<MAXB>(log2N, i);
    const int groups = count << (log2N - r);
    switch (r) {
      case 1: dit_pass<1, kInverse>(z, l0, groups, ptw); break;
      case 2: dit_pass<2, kInverse>(z, l0, groups, ptw); break;
      case 3: if constexpr (MAXB >= 3) dit_pass<3, kInverse>(z, l0, groups, ptw); break;
      default: if constexpr (MAXB >= 4) dit_pass<4, kInverse>(z, l0, groups, ptw); break;
    }
    ptw += ((1 << r) - 1) << l0;
    l0 += r;
  }
}

// The bit reversal of i < 2^bits.
__device__ __forceinline__ int bit_reverse(int i, int bits) {
  return bits ? (int)(__brev((unsigned)i) >> (32 - bits)) : 0;
}

}  // namespace
