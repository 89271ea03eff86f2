// Per-column classic spectrogram for Hopper (sm_90a).
//
// The classic spectrogram's columns, each from its own frame, as upstream
// computes them: for each stream and each of `cols` columns, straight from
// the framing ring (ops/framing.py: a mirrored ring, so every window is one
// contiguous row segment),
//
//   1. x = the column's N-sample frame, its mean removed, times the window
//   2. X = rfft(x), as the N/2-point complex FFT of z[m] = x[2m] + i x[2m+1]
//      (fft_block.cuh, decimation in frequency: natural order in,
//      bit-reversed out) and the split step
//        X[k] = E + W^k O,  X[N/2-k] = conj(E - W^k O),  W = exp(-2 pi i/N),
//        E = (Z[k] + conj Z[N/2-k]) / 2,  O = (Z[k] - conj Z[N/2-k]) / 2i,
//      X[0] = Re Z[0] + Im Z[0], X[N/2] = Re Z[0] - Im Z[0]
//   3. p = |X|^2 norm, packed as
//      code = clip(rint((max(ln(max(p, 1e-45)) LN_TO_DB, floor) + 144)
//                  * 65535/156), 0, 65535) uint16
//
// and writes the columns [S, cols, N/2 + 1].  Column k reads the window at
// ring offset base + min(k, ready - 1) hop (clipped to the ring), as
// FrameBuffer.extract does: columns past `ready` repeat the last ready one.
//
// Why per column.  The sliding DFT (B1a, B1b) applies the window in the
// frequency domain to an unwindowed f32 state, so a loud section's rounding,
// ~1e-7 of it at full weight, stays in the state after the section has left
// the window and lands on the quiet columns that follow, dozens of codes off
// within 60 dB of their peak.  Here the window weights each sample before
// any rounding of the transform, and every column starts from its samples.
//
// What bounds it: bytes.  At the flagship shape (S = 8192, 4 columns of
// 2048 at hop 64) a hop reads each stream's 2240 ring samples (73 MB, the
// four overlapping windows served from L2) and writes 67 MB of codes:
// 0.042 ms at 3.35 TB/s, against ~1.7 GFLOP of transforms.
//
// Design.  One block per (stream, column), N/16 threads clamped to [32,
// 512]: the frame goes to shared memory as N/2 complex points in
// fft_block.cuh's swizzled layout (N/2 float2: 8 KB at N = 2048, up to 128
// KB at N = 32768), summed as it is loaded; the block's sum gives the mean,
// which is removed and the window applied in place; then the block FFT, and
// each thread splits a bin pair and writes its two codes.  Passes of three
// radix-2 stages keep a thread at 56 registers with no spills: at N = 2048
// the kernel took 0.333 ms on an H100 (700 W), against 0.489 ms with passes
// of four stages (100 registers, a third of the threads resident), 0.344
// with two, and 0.425 with twice the threads a block.  It stays far from
// the byte bound: each block's ten stages run in four passes, each ending
// in a barrier, over a frame of 8 KB.  Twiddles and the window come from
// tables computed in double on the host and stored as f32.  All arithmetic
// is plain f32 (no fast math: logf, no flush to zero).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_block.cuh"

namespace {

constexpr int THREADS = 512;  // at most, a block
constexpr int MAXB = 3;       // radix-2 stages a pass: 8 points in registers
constexpr int MAX_N = 32768;  // N/2 complex f32 points fill 128 KB of shared memory
constexpr float LN_TO_DB = 4.3429448f;
constexpr float STORE_LO = -144.0f;

struct Params {
  const float* ring;     // [S, ring_len]
  const float* window;   // [N]
  const float2* tw;      // [N/2], exp(-2 pi i k/N): the split step's
  const float2* dif_tw;  // the N/2-point plan's table (ops/block_fft.py)
  const float* norm;     // [N/2 + 1]
  uint16_t* out;         // [S, cols, N/2 + 1]
  int ring_len, base, hop, ready, cols, n_fft, n, log2n;
  float floor_db, store_scale;
};

__device__ __forceinline__ uint16_t db_code(float p, float floor_db, float scale) {
  const float db = fmaxf(logf(fmaxf(p, 1e-45f)) * LN_TO_DB, floor_db);
  const float code = rintf((db - STORE_LO) * scale);  // half to even
  return (uint16_t)fminf(fmaxf(code, 0.f), 65535.f);
}

__global__ void __launch_bounds__(THREADS) classic_columns_kernel(const Params P) {
  extern __shared__ __align__(16) float2 z[];  // N/2 points
  __shared__ float part[THREADS / 32];
  const int t = threadIdx.x, nt = blockDim.x, n = P.n;
  const int s = blockIdx.x / P.cols, k = blockIdx.x - s * P.cols;
  const int keff = min(k, max(P.ready - 1, 0));
  const int start = min(max(P.base + keff * P.hop, 0), P.ring_len - P.n_fft);
  const float* frame = P.ring + (long long)s * P.ring_len + start;

  // 1. the frame as N/2 complex points, summed as it lands
  float acc = 0.f;
  for (int m = t; m < n; m += nt) {
    const float x0 = __ldg(frame + 2 * m), x1 = __ldg(frame + 2 * m + 1);
    z[slot_of(m)] = make_float2(x0, x1);
    acc += x0 + x1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((t & 31) == 0) part[t >> 5] = acc;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < (nt >> 5); ++i) total += part[i];
  const float mean = total / (float)P.n_fft;
  const float2* w2 = reinterpret_cast<const float2*>(P.window);
  for (int m = t; m < n; m += nt) {  // the points this thread wrote
    const float2 v = z[slot_of(m)], w = __ldg(w2 + m);
    z[slot_of(m)] = make_float2((v.x - mean) * w.x, (v.y - mean) * w.y);
  }
  __syncthreads();

  // 2. the N/2-point FFT (bit-reversed out)
  block_fft_dif<MAXB, false>(z, P.log2n, 1, P.dif_tw);

  // 2-3. split, power, codes: bin pairs (kk, n - kk)
  const long long o0 = (long long)blockIdx.x * (n + 1);
  for (int kk = t; kk <= n / 2; kk += nt) {
    if (kk == 0) {
      const float2 z0 = z[slot_of(0)];
      const float x0 = z0.x + z0.y, xn = z0.x - z0.y;
      P.out[o0] = db_code(x0 * x0 * __ldg(P.norm), P.floor_db, P.store_scale);
      P.out[o0 + n] = db_code(xn * xn * __ldg(P.norm + n), P.floor_db, P.store_scale);
      continue;
    }
    const float2 zk = z[slot_of(bit_reverse(kk, P.log2n))];
    const float2 zc = z[slot_of(bit_reverse(n - kk, P.log2n))];
    const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
    const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float2 wo = bmul(__ldg(P.tw + kk), o);
    const float2 xk = badd(e, wo);
    const float2 xc = make_float2(e.x - wo.x, wo.y - e.y);  // X[n - kk]
    P.out[o0 + kk] = db_code((xk.x * xk.x + xk.y * xk.y) * __ldg(P.norm + kk), P.floor_db, P.store_scale);
    if (kk != n - kk)
      P.out[o0 + n - kk] =
          db_code((xc.x * xc.x + xc.y * xc.y) * __ldg(P.norm + n - kk), P.floor_db, P.store_scale);
  }
}

}  // namespace

// Host entry: launches one block per (stream, column) on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for shapes the
// kernel does not take.
extern "C" int classic_columns_launch(
    const float* ring, const float* window, const float* tw, const float* dif_tw, const float* norm,
    void* out, int streams, int ring_len, int base, int hop, int ready, int cols, int n_fft,
    float floor_db, float store_scale, void* stream) {
  if (streams == 0) return 0;
  int log2n = 0;
  while ((1 << log2n) < n_fft / 2) ++log2n;
  if (n_fft < 64 || n_fft > MAX_N || (2 << log2n) != n_fft || ring_len < n_fft || cols < 1 ||
      hop < 1 || (long long)streams * cols > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int n = n_fft / 2;
  const int threads = n / 8 < 32 ? 32 : (n / 8 > THREADS ? THREADS : n / 8);
  Params P;
  P.ring = ring;
  P.window = window;
  P.tw = reinterpret_cast<const float2*>(tw);
  P.dif_tw = reinterpret_cast<const float2*>(dif_tw);
  P.norm = norm;
  P.out = static_cast<uint16_t*>(out);
  P.ring_len = ring_len; P.base = base; P.hop = hop; P.ready = ready; P.cols = cols;
  P.n_fft = n_fft; P.n = n; P.log2n = log2n;
  P.floor_db = floor_db; P.store_scale = store_scale;

  const size_t smem = sizeof(float2) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      classic_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  classic_columns_kernel<<<streams * cols, threads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
