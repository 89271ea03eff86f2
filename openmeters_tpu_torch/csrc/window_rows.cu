// Per-row window copy for Hopper (sm_90a).
//
// Replaces openmeters_tpu/ops/pallas_rows.py::_window_rows_tpu:
//   out[s, w, j] = x[s, clip(starts[s, w], 0, n - length) + j],  j < length.
//
// What bounds it: bytes.  Each window is read once and written once
// (2 * length * 4 bytes), so at S = 8192 and length 4800 one call moves
// 315 MB: 0.094 ms at 3.35 TB/s.
//
// Design.  One block per (row, window); its threads copy the window with
// consecutive threads on consecutive addresses, so loads and stores
// coalesce whatever the start.  The TPU kernel's 128-aligned slice and lane
// roll existed only for the TPU's layout and are not carried over.  The
// copy is exact.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
window_rows_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                   float* __restrict__ out, int n, int windows, int length) {
  const long long row = blockIdx.x;  // s * windows + w
  const long long s = row / windows;
  const int st = min(max(starts[row], 0), n - length);
  const float* src = x + s * n + st;
  float* dst = out + row * length;
  for (int j = threadIdx.x; j < length; j += THREADS) dst[j] = __ldg(src + j);
}

}  // namespace

// Host entry: one block per window on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int window_rows_launch(const float* x, const int* starts, float* out,
                                  int rows, int n, int windows, int length, void* stream) {
  if (rows == 0 || windows == 0 || length == 0) return 0;
  if (length < 0 || length > n || windows < 0 || (long long)rows * windows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  window_rows_kernel<<<rows * windows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, starts, out, n, windows, length);
  return (int)cudaGetLastError();
}
