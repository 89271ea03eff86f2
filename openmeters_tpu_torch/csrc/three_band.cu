// Three-band crossover for Hopper (sm_90a): the stereometer's and the
// waveform's per-sample biquad recurrence.
//
// Replaces the JAX package's openmeters_tpu/ops/iir.py::three_band_scan, a
// lax.scan over the block's samples (no pallas_call there).  Per lane, for
// each sample t in order:
//
//   low  = LP_lo(x[t]);  al = HP_lo(x[t]);  mid = LP_hi(al);
//   high = HP_hi(kHighFromAl ? al : x[t])
//
// each filter a cascade of CN identical direct-form-II-transposed biquads,
// and each biquad, on a non-finite output, resets its two states and emits 0.
//
// What bounds it: the recurrence is serial in time, so a lane is one
// dependency chain of ~4 * CN * 8 operations a sample; the bytes (x once,
// three bands out, the state in and out) are ~64 MB a hop at S=8192 stereo,
// ~20 us of memory traffic.  Design: one thread per (stream, channel) lane,
// all 4 * CN * 2 states in registers for the whole block, x read and the
// bands written coalesced ([T, lanes] and [T, 3, lanes], neighbouring lanes
// on neighbouring addresses); the loads of later samples do not depend on
// the chain and are issued ahead by the unrolled loop.  Every product and
// sum is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: no FMA
// contraction) in the order of the plain version, so the two agree to the
// bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

struct Biquad {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ float biquad(const Biquad& c, float x, float& z0,
                                        float& z1) {
  const float y = __fadd_rn(__fmul_rn(c.b0, x), z0);
  const float nz0 =
      __fadd_rn(__fsub_rn(__fmul_rn(c.b1, x), __fmul_rn(c.a1, y)), z1);
  const float nz1 = __fsub_rn(__fmul_rn(c.b2, x), __fmul_rn(c.a2, y));
  const bool ok = isfinite(y);
  z0 = ok ? nz0 : 0.f;
  z1 = ok ? nz1 : 0.f;
  return ok ? y : 0.f;
}

template <int CN, bool kHighFromAl>
__global__ void __launch_bounds__(THREADS) three_band_kernel(
    const float* __restrict__ x, const float* __restrict__ state,
    const float* __restrict__ coeffs, float* __restrict__ bands,
    float* __restrict__ state_out, int T, int L) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;
  Biquad c[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    c[f] = {coeffs[5 * f], coeffs[5 * f + 1], coeffs[5 * f + 2],
            coeffs[5 * f + 3], coeffs[5 * f + 4]};
  }
  float z[4][CN][2];  // state [4][CN][2][L]
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        z[f][j][q] = state[((long long)(f * CN + j) * 2 + q) * L + l];

#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const float xt = x[(long long)t * L + l];
    float low = xt, al = xt;
#pragma unroll
    for (int j = 0; j < CN; ++j) low = biquad(c[0], low, z[0][j][0], z[0][j][1]);
#pragma unroll
    for (int j = 0; j < CN; ++j) al = biquad(c[1], al, z[1][j][0], z[1][j][1]);
    float mid = al, high = kHighFromAl ? al : xt;
#pragma unroll
    for (int j = 0; j < CN; ++j) mid = biquad(c[2], mid, z[2][j][0], z[2][j][1]);
#pragma unroll
    for (int j = 0; j < CN; ++j) high = biquad(c[3], high, z[3][j][0], z[3][j][1]);
    float* o = bands + (long long)t * 3 * L + l;
    o[0] = low;
    o[L] = mid;
    o[2 * (long long)L] = high;
  }

#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        state_out[((long long)(f * CN + j) * 2 + q) * L + l] = z[f][j][q];
}

template <int CN, bool kHighFromAl>
int launch(const float* x, const float* state, const float* coeffs,
           float* bands, float* state_out, int T, int L, cudaStream_t stream) {
  three_band_kernel<CN, kHighFromAl>
      <<<(L + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
          x, state, coeffs, bands, state_out, T, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry: x [T, L], state [4, cascade_n, 2, L], coeffs [4, 5] (b0 b1 b2
// a1 a2 of LP_lo, HP_lo, LP_hi, HP_hi), bands [T, 3, L].  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int three_band_launch(const float* x, const float* state,
                                 const float* coeffs, float* bands,
                                 float* state_out, int T, int L, int cascade_n,
                                 int high_from_al, void* stream) {
  if (L == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (cascade_n == 1)
    return high_from_al ? launch<1, true>(x, state, coeffs, bands, state_out, T, L, st)
                        : launch<1, false>(x, state, coeffs, bands, state_out, T, L, st);
  if (cascade_n == 2)
    return high_from_al ? launch<2, true>(x, state, coeffs, bands, state_out, T, L, st)
                        : launch<2, false>(x, state, coeffs, bands, state_out, T, L, st);
  return (int)cudaErrorInvalidValue;
}
