// Radix-2 complex FFTs over a buffer in shared memory, for one thread block.
//
// Used by reassigned_columns.cu and corr_search.cu.  Two stages go in one
// pass over the buffer, each thread taking a group of four points through
// both stages' butterflies in registers; an odd last stage runs alone.
// Each call runs `count` consecutive transforms of 2^log2N points (log2N
// >= 2).  Twiddles come from a table tw[k] = exp(-2 pi i k / h), k < h/2,
// computed in double on the host and stored as f32; a transform of 2^log2N
// points reads it at stride h / 2^log2N.  Every pass ends in
// __syncthreads().  Plain f32 arithmetic.  The buffer may be in shared or
// in global memory: the barrier orders both within the block.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

__device__ __forceinline__ float2 twiddle(const float2* tw, int k, bool inverse) {
  float2 w = __ldg(tw + k);
  if (inverse) w.y = -w.y;
  return w;
}

// Radix-2 decimation in frequency: natural order in, bit-reversed order
// out.  For spans 2h and h, each group of four points {a, a + h, a + 2h,
// a + 3h} goes through both stages in registers.
__device__ void fft_dif4(float2* z, int log2N, int count, const float2* tw, int log2h,
                         bool inverse) {
  const int groups = count << (log2N - 2);
  int lh = log2N - 1;
  for (; lh >= 1; lh -= 2) {  // spans 2^lh and 2^(lh - 1)
    const int h = 1 << (lh - 1);
    const int s1 = log2h - lh - 1;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int pos = g & (h - 1);
      const int a0 = ((g >> (lh - 1)) << (lh + 1)) | pos;
      const int a1 = a0 + h, a2 = a1 + h, a3 = a2 + h;
      const float2 wa = twiddle(tw, pos << s1, inverse);
      const float2 wb = twiddle(tw, (pos + h) << s1, inverse);
      const float2 wc = twiddle(tw, pos << (s1 + 1), inverse);
      const float2 x0 = z[a0], x1 = z[a1], x2 = z[a2], x3 = z[a3];
      const float2 y0 = cadd(x0, x2), y2 = cmul(csub(x0, x2), wa);
      const float2 y1 = cadd(x1, x3), y3 = cmul(csub(x1, x3), wb);
      z[a0] = cadd(y0, y1);
      z[a1] = cmul(csub(y0, y1), wc);
      z[a2] = cadd(y2, y3);
      z[a3] = cmul(csub(y2, y3), wc);
    }
    __syncthreads();
  }
  if (lh == 0) {  // span 1: the twiddle is 1
    for (int b = threadIdx.x; b < 2 * groups; b += blockDim.x) {
      const float2 u = z[2 * b], v = z[2 * b + 1];
      z[2 * b] = cadd(u, v);
      z[2 * b + 1] = csub(u, v);
    }
    __syncthreads();
  }
}

// Radix-2 decimation in time: bit-reversed order in, natural order out;
// spans h and 2h per group of four points.  `ls` spreads the transforms
// over every 2^ls-th element of z (point i at z[i << ls]).
__device__ void fft_dit4(float2* z, int log2N, int count, const float2* tw, int log2h,
                         bool inverse, int ls) {
  const int groups = count << (log2N - 2);
  int lh = 0;
  for (; lh + 1 < log2N; lh += 2) {  // spans 2^lh and 2^(lh + 1)
    const int h = 1 << lh;
    const int s1 = log2h - lh - 1;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int pos = g & (h - 1);
      const int a0 = ((g >> lh) << (lh + 2)) | pos;
      const int i0 = a0 << ls, i1 = (a0 + h) << ls, i2 = (a0 + 2 * h) << ls, i3 = (a0 + 3 * h) << ls;
      const float2 wc = twiddle(tw, pos << s1, inverse);
      const float2 wa = twiddle(tw, pos << (s1 - 1), inverse);
      const float2 wb = twiddle(tw, (pos + h) << (s1 - 1), inverse);
      const float2 x0 = z[i0], x1 = cmul(z[i1], wc), x2 = z[i2], x3 = cmul(z[i3], wc);
      const float2 y0 = cadd(x0, x1), y1 = csub(x0, x1);
      const float2 y2 = cmul(cadd(x2, x3), wa), y3 = cmul(csub(x2, x3), wb);
      z[i0] = cadd(y0, y2);
      z[i2] = csub(y0, y2);
      z[i1] = cadd(y1, y3);
      z[i3] = csub(y1, y3);
    }
    __syncthreads();
  }
  if (lh < log2N) {  // the last span, 2^lh
    const int half = 1 << lh;
    const int shift = log2h - lh - 1;
    for (int b = threadIdx.x; b < 2 * groups; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i = ((b >> lh) << (lh + 1)) | pos;
      const float2 w = twiddle(tw, pos << shift, inverse);
      const float2 u = z[i << ls];
      const float2 v = cmul(z[(i + half) << ls], w);
      z[i << ls] = cadd(u, v);
      z[(i + half) << ls] = csub(u, v);
    }
    __syncthreads();
  }
}

}  // namespace
