// A hop's sample rows gathered from the transport's ring arena, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's serving loop has the host
// assembler copy each stream's row into a batch, then sends the batch to the
// device.  Here the assembler writes a descriptor a row (ingest/transport.cpp,
// om_assemble_desc) and the card reads the samples itself, over the host
// link, from the rings: mapped pinned host memory.
//
//   desc[r] = {off0, n0, off1, n1} (int64):
//     out[r, j] = arena[off0 + j]            j < n0
//               = arena[off1 + j - n0]       n0 <= j < n0 + n1
//               = 0                          otherwise
//   desc[r] = {0, -1, 0, 0}: out[r, :] = staging[r, :] (a row the host copied).
//
// What bounds it: the host link.  Each sample crosses it once (S * B * C * 4
// bytes, 16.8 MB a hop at S = 8192, B = 256, C = 2, plus 32 bytes of
// descriptor a row), and is written once to device memory.  Reads of host
// memory take microseconds, so the design keeps many bytes in flight rather
// than many threads busy: a warp a row, each lane with all of its loads of
// the row (eight 8-byte loads for a 512-sample row) issued before its first
// store, and a modest grid (a few blocks of eight warps a multiprocessor at
// most) that loops over the rows, so the step running beside it on the
// compute stream keeps its multiprocessors.  Segments start on 8-byte
// boundaries only (a clip's last push may hold an odd number of frames), so
// loads are 8 bytes wide; a row whose offsets or lengths are odd takes
// 4-byte loads.  The copy is exact.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks of eight warps: enough reads of host memory in flight for the host
// link (16 to 264 blocks gather alike at S = 8192), few enough to leave the
// step beside it its multiprocessors; more rows loop
constexpr int BLOCKS = 64;
constexpr int UNROLL = 8;
constexpr unsigned FULL = 0xffffffffu;

// dst[j] for j < len: a[j] below na, b[j - na] below na + nb, else 0, in
// elements of T (float2 or float).
template <class T>
__device__ __forceinline__ void copy_row(T* __restrict__ dst, const T* a, long long na,
                                         const T* b, long long nab, int len, int lane) {
  for (int base = 0; base < len; base += 32 * UNROLL) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * 32 + lane;
      v[u] = T{};
      if (j < na)
        v[u] = a[j];
      else if (j < nab)
        v[u] = b[j - na];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * 32 + lane;
      if (j < len) dst[j] = v[u];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ring_gather_kernel(const float* __restrict__ arena, const float* __restrict__ staging,
                   const long long* __restrict__ desc, float* __restrict__ out, int rows,
                   int row_len) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < rows; r += stride) {
    const long long word = lane < 4 ? desc[4LL * r + lane] : 0;
    const long long off0 = __shfl_sync(FULL, word, 0);
    long long n0 = __shfl_sync(FULL, word, 1);
    const long long off1 = __shfl_sync(FULL, word, 2);
    long long n1 = __shfl_sync(FULL, word, 3);
    const float* a = arena + off0;
    const float* b = arena + off1;
    if (n0 < 0) {  // staged on the host
      a = b = staging + (long long)r * row_len;
      n0 = row_len;
      n1 = 0;
    }
    float* dst = out + (long long)r * row_len;
    const bool even = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 7) == 0 &&
                      ((n0 | n1 | row_len) & 1) == 0;
    if (even)
      copy_row(reinterpret_cast<float2*>(dst), reinterpret_cast<const float2*>(a), n0 / 2,
               reinterpret_cast<const float2*>(b), (n0 + n1) / 2, row_len / 2, lane);
    else
      copy_row(dst, a, n0, b, n0 + n1, row_len, lane);
  }
}

}  // namespace

// Host entry: rows [row0, row0 + rows) of the descriptors and the staging
// rows into out [rows, row_len] on `stream`.  arena, staging and desc are the
// device's addresses of mapped pinned host memory (ring_host_device_pointer).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for shapes the kernel
// does not take.
extern "C" int ring_gather_launch(const float* arena, const float* staging, const long long* desc,
                                  float* out, long long row0, int rows, int row_len, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || row_len <= 0 || row0 < 0) return (int)cudaErrorInvalidValue;
  const int need = (rows + WARPS - 1) / WARPS;
  ring_gather_kernel<<<BLOCKS < need ? BLOCKS : need, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      arena, staging + row0 * row_len, desc + 4 * row0, out, rows, row_len);
  return (int)cudaGetLastError();
}

// The current device's address of mapped pinned host memory at `host`
// (registered with ring_host_register, or allocated pinned) into *dev.
extern "C" int ring_host_device_pointer(void* host, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, host, 0);
}

// Pin `bytes` of host memory at `ptr` for every card, mapped into their
// address spaces (the transport's ring arena).
extern "C" int ring_host_register(void* ptr, unsigned long long bytes) {
  return (int)cudaHostRegister(ptr, bytes, cudaHostRegisterMapped | cudaHostRegisterPortable);
}

extern "C" int ring_host_unregister(void* ptr) { return (int)cudaHostUnregister(ptr); }
