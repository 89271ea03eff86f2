// Per-column reassigned-spectrogram transform for Hopper (sm_90a).
//
// Replaces openmeters_tpu/ops/pallas_reassigned.py::reassigned_columns
// (_build_kernel).  One thread block per h-sample raw frame (h = 2n, the
// Hilbert length) runs the whole chain in shared memory, with no trip to
// device memory between stages:
//
//   1. the h-point FFT of the real frame, decimation in frequency: natural
//      order in, bit-reversed order out;
//   2. the analytic selection on the bit-reversed spectrum: DC and the
//      negative bins (k > h/2) zeroed, bins 1..h/2 kept without doubling;
//   3. the inverse h-point FFT, decimation in time: bit-reversed in,
//      natural out (so neither transform needs a permutation pass);
//   4. the centre n-sample crop, scaled by 1/h, written bit-reversed as the
//      inputs of U = FFT_n(crop) at [0, n) and V = FFT_n(ramp * crop) at
//      [n, 2n) -- back into the same buffer;
//   5. both n-point FFTs, decimation in time, natural order out;
//   6. per bin k in [0, n/2]: the window stencil B and the time-weighted
//      window stencil T (circular over all n bins), the derivative window
//      D = sum_j i pi j a_j / n (U[k-j] - U[k+j]), and the corrections
//        freq  = k fs/n - (Im D Re B - Re D Im B)/|B|^2 * fs/2pi
//        time  = (Re T Re B + Im T Im B)/|B|^2 / hop - latency
//        power = |B|^2 norm[k]
//
// What bounds it: shared-memory traffic.  Each pass of two radix-2
// stages reads and writes the whole complex buffer once; at n = 8192
// (h = 16384) that is 7 + 7 + 7 passes over 128 KB, ~5.5 MB of
// shared-memory traffic per frame against 64 KB in and 48 KB out of
// device memory.
//
// Design.  The complex f32 h-buffer is the block's only shared memory:
// 128 KB at h = 16384, so one block fits in Hopper's 227 KB and the crop
// and U and V reuse it.  Twiddles exp(-2 pi i k/h), k < h/2, come from a
// table computed in double on the host and stored as f32; the n-point
// transforms read it at stride h/n.  Threads: h/8, from 32 to 1024.  All
// arithmetic is plain f32 (no fast math).  The radix-2 stages are in
// fft_radix2.cuh.
#include <cuda_runtime.h>

#include "fft_radix2.cuh"

namespace {

constexpr int MAXJ = 3;      // stencil terms beyond a0
constexpr int MAX_PER = 8;   // crop samples per thread: n / threads

struct Params {
  const float* frames;  // [rows, h]
  const float2* tw;     // [h/2]
  const float* norm;    // [bins]
  float* freq;          // [rows, bins]
  float* time;
  float* power;
  int n, h, log2n, log2h, bins, nterms;
  float a0, halves[MAXJ], gs[MAXJ];
  float bin_hz, inv_2pi, inv_hop, latency_hops;
};

__global__ void reassigned_columns_kernel(const Params P) {
  extern __shared__ __align__(16) float2 z[];  // [h]
  const int t = threadIdx.x, nt = blockDim.x;
  const int n = P.n, h = P.h;
  const float* frame = P.frames + (long long)blockIdx.x * h;

  // 1. forward h-point FFT of the real frame
  for (int i = t; i < h; i += nt) z[i] = make_float2(frame[i], 0.f);
  __syncthreads();
  fft_dif4(z, P.log2h, 1, P.tw, P.log2h, false);

  // 2. analytic selection: position p holds bin rev(p)
  for (int p = t; p < h; p += nt) {
    const int k = (int)(__brev((unsigned)p) >> (32 - P.log2h));
    if (k == 0 || k > h / 2) z[p] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  // 3. inverse h-point FFT (unscaled)
  fft_dit4(z, P.log2h, 1, P.tw, P.log2h, true, 0);

  // 4. the centre crop, scaled, into the bit-reversed inputs of U and V
  const int center = (h - n) / 2;
  const float inv_h = 1.0f / (float)h;
  const float c = 0.5f * (float)(n - 1);
  float2 a[MAX_PER];
#pragma unroll
  for (int it = 0; it < MAX_PER; ++it) {
    const int m = t + it * nt;
    if (m < n) {
      const float2 v = z[center + m];
      a[it] = make_float2(v.x * inv_h, v.y * inv_h);
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < MAX_PER; ++it) {
    const int m = t + it * nt;
    if (m < n) {
      const int r = (int)(__brev((unsigned)m) >> (32 - P.log2n));
      const float ramp = (float)m - c;
      z[r] = a[it];
      z[n + r] = make_float2(a[it].x * ramp, a[it].y * ramp);
    }
  }
  __syncthreads();

  // 5. U and V
  fft_dit4(z, P.log2n, 2, P.tw, P.log2h, false, 0);

  // 6. stencils and corrections
  const float2* U = z;
  const float2* V = z + n;
  const int mask = n - 1;
  const long long o0 = (long long)blockIdx.x * P.bins;
  for (int k = t; k < P.bins; k += nt) {
    const float2 u0 = U[k], v0 = V[k];
    float br = P.a0 * u0.x, bi = P.a0 * u0.y;
    float tr = P.a0 * v0.x, ti = P.a0 * v0.y;
    float dr = 0.f, di = 0.f;
#pragma unroll
    for (int j = 1; j <= MAXJ; ++j) {
      if (j >= P.nterms) break;
      const float hv = P.halves[j - 1], gv = P.gs[j - 1];
      const float2 ul = U[(k - j) & mask], uh = U[(k + j) & mask];
      const float2 vl = V[(k - j) & mask], vh = V[(k + j) & mask];
      br = br + hv * (ul.x + uh.x);
      bi = bi + hv * (ul.y + uh.y);
      tr = tr + hv * (vl.x + vh.x);
      ti = ti + hv * (vl.y + vh.y);
      dr = dr - gv * (ul.y - uh.y);
      di = di + gv * (ul.x - uh.x);
    }
    const float pow_raw = br * br + bi * bi;
    const float inv_pow = 1.0f / fmaxf(pow_raw, 1e-38f);
    const float d_omega = -(di * br - dr * bi) * inv_pow;
    P.freq[o0 + k] = (float)k * P.bin_hz + d_omega * P.inv_2pi;
    P.time[o0 + k] = (tr * br + ti * bi) * inv_pow * P.inv_hop - P.latency_hops;
    P.power[o0 + k] = pow_raw * P.norm[k];
  }
}

}  // namespace

// Host entry: launches one block per frame on `stream` and returns
// cudaGetLastError().
extern "C" int reassigned_columns_launch(
    const float* frames, const float* tw, const float* norm,
    float* freq, float* time, float* power,
    int rows, int n, int nterms, float a0, float h1, float h2, float h3,
    float g1, float g2, float g3,
    float bin_hz, float inv_2pi, float inv_hop, float latency_hops, void* stream) {
  if (rows == 0) return 0;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const int h = 2 * n;
  const int threads = h / 8 < 32 ? 32 : (h / 8 > 1024 ? 1024 : h / 8);
  if (n < 16 || (1 << log2n) != n || nterms < 1 || nterms > MAXJ + 1 ||
      n > MAX_PER * threads)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.frames = frames;
  P.tw = reinterpret_cast<const float2*>(tw);
  P.norm = norm;
  P.freq = freq; P.time = time; P.power = power;
  P.n = n; P.h = h; P.log2n = log2n; P.log2h = log2n + 1;
  P.bins = n / 2 + 1; P.nterms = nterms;
  P.a0 = a0;
  P.halves[0] = h1; P.halves[1] = h2; P.halves[2] = h3;
  P.gs[0] = g1; P.gs[1] = g2; P.gs[2] = g3;
  P.bin_hz = bin_hz; P.inv_2pi = inv_2pi; P.inv_hop = inv_hop;
  P.latency_hops = latency_hops;

  const size_t smem = sizeof(float2) * (size_t)h;
  cudaError_t err = cudaFuncSetAttribute(
      reassigned_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  reassigned_columns_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
