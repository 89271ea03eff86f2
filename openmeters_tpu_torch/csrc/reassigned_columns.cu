// Per-column reassigned-spectrogram transform for Hopper (sm_90a).
//
// Replaces openmeters_tpu/ops/pallas_reassigned.py::reassigned_columns
// (_build_kernel).  One thread block per h-sample raw frame (h = 2n, the
// Hilbert length) runs the whole chain in shared memory, with no trip to
// device memory between stages:
//
//   1. the frame's h-point real FFT as one n-point complex FFT of
//      z[m] = x[2m] + i x[2m+1] (decimation in frequency: natural order in,
//      bit-reversed out), then the split step
//        X[k] = E + W^k O,  X[n-k] = conj(E - W^k O),  W = exp(-2 pi i/h),
//        E = (Z[k] + conj Z[n-k]) / 2,  O = (Z[k] - conj Z[n-k]) / 2i;
//   2. the analytic selection (DC and bins past h/2 zeroed, bins 1..h/2
//      kept without doubling) and the inverse h-point FFT, pruned: the h/2
//      zero bins drop out by splitting the outputs by parity,
//        a[2s]   = sum_{k=1..n} X[k]          e^{2 pi i k s/n},
//        a[2s+1] = sum_{k=1..n} X[k] W^{-k}   e^{2 pi i k s/n},
//      two n-point inverse FFTs (bin n at index 0), run as one call of two
//      transforms, decimation in time from the split's bit-reversed writes;
//   3. the centre n-sample crop (a[n/2 + m]: s in [n/4, 3n/4) of each
//      parity), scaled by 1/h, written bit-reversed as the inputs of
//      U = FFT_n(crop) and V = FFT_n(ramp * crop);
//   4. U and V, one call of two n-point transforms, natural order out;
//   5. per bin k in [0, n/2]: the window stencil B and the time-weighted
//      window stencil T (circular over all n bins), the derivative window
//      D = sum_j i pi j a_j / n (U[k-j] - U[k+j]), and the corrections
//        freq  = k fs/n - (Im D Re B - Re D Im B)/|B|^2 * fs/2pi
//        time  = (Re T Re B + Im T Im B)/|B|^2 / hop - latency
//        power = |B|^2 norm[k]
//
// What bounds it: at n = 8192 the chain is five n-point transforms a frame
// (~2.7 MFLOP) against 64 KB in and 48 KB out of device memory, so the
// passes over shared memory and the instructions they issue bound it, one
// block an SM, not device memory.  The transforms run on fft_block.cuh:
// register-resident passes of up to 16 points (4 radix-2 stages, one
// barrier), so 13 stages take 4 passes; with the real-input split and the
// pruned inverse the chain runs 12 passes where the radix-2 chain ran 21,
// over the same radix-2 butterflies and twiddle values (the rounding of the
// radix-2 chain, which chip_smoke.py phase 7 holds against float64).
//
// Design.  Two n-point buffers in fft_block.cuh's swizzled layout (the
// bit-reversed writes of the split and the crop free of bank conflicts),
// 128 KB at n = 8192: one block per SM.  Twiddles come from tables computed
// in double on the host and stored as f32: the n-point plans' own tables
// (read in order across a warp), and exp(-2 pi i k/h), k < h/2, for the
// split step and the odd parity's twist.  Threads: n/8 clamped to [32,
// 512].  All arithmetic is plain f32 (no fast math).
#include <cuda_runtime.h>

#include "fft_block.cuh"

namespace {

constexpr int MAXJ = 3;       // stencil terms beyond a0
constexpr int THREADS = 512;  // at most, a block
constexpr int MAX_PER = 16;   // crop samples per thread: n / threads
constexpr int MAXB = 4;       // radix-2 stages a pass: 16 points in registers

struct Params {
  const float* frames;  // [rows, h]
  const float2* tw;     // [h/2], exp(-2 pi i k/h): the split's and the odd parity's
  const float2* dif_tw; // the n-point plans' tables (ops/block_fft.py)
  const float2* dit_tw;
  const float* norm;    // [bins]
  float* freq;          // [rows, bins]
  float* time;
  float* power;
  int n, h, log2n, bins, nterms;
  float a0, halves[MAXJ], gs[MAXJ];
  float bin_hz, inv_2pi, inv_hop, latency_hops;
};

__global__ void __launch_bounds__(THREADS) reassigned_columns_kernel(const Params P) {
  extern __shared__ __align__(16) float2 z[];  // two n-point buffers
  const int t = threadIdx.x, nt = blockDim.x;
  const int n = P.n, L = P.log2n;
  const float2* frame = reinterpret_cast<const float2*>(P.frames + (long long)blockIdx.x * P.h);

  // 1. the real frame as n complex points (every load in flight at once),
  //    and their FFT (bit-reversed out)
  {
    float2 f[MAX_PER];
#pragma unroll
    for (int it = 0; it < MAX_PER; ++it) {
      const int m = t + it * nt;
      if (m < n) f[it] = frame[m];
    }
#pragma unroll
    for (int it = 0; it < MAX_PER; ++it) {
      const int m = t + it * nt;
      if (m < n) z[slot_of(m)] = f[it];
    }
  }
  __syncthreads();
  block_fft_dif<MAXB, false>(z, L, 1, P.dif_tw);

  // 1-2. split into X[k], k = 1..n, and the parity transforms' inputs
  //      Y0[k] = X[k], Y1[k] = X[k] W^{-k} (k < n), Y0[0] = X[n], Y1[0] = -X[n],
  //      each at its bit-reversed position (Y0 in place of Z, Y1 in the
  //      second transform's points [n, 2n))
  for (int k = t; k <= n / 2; k += nt) {
    const int rk = bit_reverse(k, L);
    const int pk = slot_of(rk), pk1 = slot_of(n + rk);
    if (k == 0) {
      const float2 z0 = z[pk];
      const float xn = z0.x - z0.y;  // X[n]; X[0] is dropped
      z[pk] = make_float2(xn, 0.f);
      z[pk1] = make_float2(-xn, 0.f);
      continue;
    }
    const int rc = bit_reverse(n - k, L);
    const int pc = slot_of(rc), pc1 = slot_of(n + rc);
    const float2 zk = z[pk], zc = z[pc];  // Z[k], Z[n-k]
    const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
    const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float2 wk = __ldg(P.tw + k);
    const float2 wo = bmul(wk, o);
    const float2 xk = badd(e, wo);
    const float2 xc = make_float2(e.x - wo.x, wo.y - e.y);  // X[n-k]
    const float2 wc = __ldg(P.tw + (n - k));
    z[pk] = xk;
    z[pk1] = bmul(xk, make_float2(wk.x, -wk.y));
    if (k != n / 2) {
      z[pc] = xc;
      z[pc1] = bmul(xc, make_float2(wc.x, -wc.y));
    }
  }
  __syncthreads();

  // 2. both parities' inverse n-point FFTs (unscaled), natural order out
  block_fft_dit<MAXB, true>(z, L, 2, P.dit_tw);

  // 3. the centre crop a[n/2 + m] = parity (m & 1), index n/4 + m/2; scaled,
  //    into the bit-reversed inputs of U (points [0, n)) and V ([n, 2n))
  const float inv_h = 1.0f / (float)P.h;
  const float c = 0.5f * (float)(n - 1);
  float2 a[MAX_PER];
#pragma unroll
  for (int it = 0; it < MAX_PER; ++it) {
    const int m = t + it * nt;
    if (m < n) {
      const float2 v = z[slot_of((m & 1) * n + n / 4 + (m >> 1))];
      a[it] = make_float2(v.x * inv_h, v.y * inv_h);
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < MAX_PER; ++it) {
    const int m = t + it * nt;
    if (m < n) {
      const int r = bit_reverse(m, L);
      const float ramp = (float)m - c;
      z[slot_of(r)] = a[it];
      z[slot_of(n + r)] = make_float2(a[it].x * ramp, a[it].y * ramp);
    }
  }
  __syncthreads();

  // 4. U and V
  block_fft_dit<MAXB, false>(z, L, 2, P.dit_tw);

  // 5. stencils and corrections
  const int mask = n - 1;  // U at points [0, n), V at [n, 2n)
  const long long o0 = (long long)blockIdx.x * P.bins;
  for (int k = t; k < P.bins; k += nt) {
    const float2 u0 = z[slot_of(k)], v0 = z[slot_of(n + k)];
    float br = P.a0 * u0.x, bi = P.a0 * u0.y;
    float tr = P.a0 * v0.x, ti = P.a0 * v0.y;
    float dr = 0.f, di = 0.f;
#pragma unroll
    for (int j = 1; j <= MAXJ; ++j) {
      if (j >= P.nterms) break;
      const float hv = P.halves[j - 1], gv = P.gs[j - 1];
      const int lo = (k - j) & mask, hi = (k + j) & mask;
      const float2 ul = z[slot_of(lo)], uh = z[slot_of(hi)];
      const float2 vl = z[slot_of(n + lo)], vh = z[slot_of(n + hi)];
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
    const float* frames, const float* tw, const float* dif_tw, const float* dit_tw,
    const float* norm,
    float* freq, float* time, float* power,
    int rows, int n, int nterms, float a0, float h1, float h2, float h3,
    float g1, float g2, float g3,
    float bin_hz, float inv_2pi, float inv_hop, float latency_hops, void* stream) {
  if (rows == 0) return 0;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const int threads = n / 8 < 32 ? 32 : (n / 8 > THREADS ? THREADS : n / 8);
  if (n < 16 || (1 << log2n) != n || nterms < 1 || nterms > MAXJ + 1 ||
      n > MAX_PER * threads)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.frames = frames;
  P.tw = reinterpret_cast<const float2*>(tw);
  P.dif_tw = reinterpret_cast<const float2*>(dif_tw);
  P.dit_tw = reinterpret_cast<const float2*>(dit_tw);
  P.norm = norm;
  P.freq = freq; P.time = time; P.power = power;
  P.n = n; P.h = 2 * n; P.log2n = log2n;
  P.bins = n / 2 + 1; P.nterms = nterms;
  P.a0 = a0;
  P.halves[0] = h1; P.halves[1] = h2; P.halves[2] = h3;
  P.gs[0] = g1; P.gs[1] = g2; P.gs[2] = g3;
  P.bin_hz = bin_hz; P.inv_2pi = inv_2pi; P.inv_hop = inv_hop;
  P.latency_hops = latency_hops;

  const size_t smem = sizeof(float2) * 2 * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      reassigned_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  reassigned_columns_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
