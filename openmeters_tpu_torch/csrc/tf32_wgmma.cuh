// 3xTF32 products on Hopper's tensor cores (sm_90a): the pieces shared by
// the two sliding hops that multiply sample deltas by DFT update matrices
// (sliding_hop_deltas.cu, reassigned_hop.cu).
//
// The split.  An f32 value x is carried as hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest (cvt.rna.tf32.f32), and a product as
// a_lo b_hi + a_hi b_lo + a_hi b_hi, each term on the tensor cores with f32
// accumulation.  The dropped a_lo b_lo term and the lo parts' own rounding
// sit near 2^-22 of the product, so the sum keeps f32's accuracy, where one
// TF32 product keeps 11 bits -- as long as the accumulator is not a long
// chain: the tensor cores truncate as they add into it, so the kernels sum
// each chunk of KC values of K from zero and add the chunks in f32
// (mma_chunk).
//
// The layout.  wgmma takes TF32 operands from shared memory K-major only.  A
// tile of R rows by KC = 16 columns of K is kept in the canonical layout
// without swizzle: core matrices of 8 rows by 4 values (128 contiguous
// bytes), the KC / 4 core matrices of an 8-row group side by side, the row
// groups one after another.  So a row's 16 values are four 16-byte pieces,
// each at a core matrix's row, and one k8 step of wgmma reads two core
// matrices per row group: leading byte offset 128 (the next core matrix in
// K), stride byte offset KC * 32 (the next row group).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

constexpr int KC = 16;  // K values per staged chunk: two k8 steps

// float offset of element (r, k), k < KC, in a K-major core-matrix tile
__device__ __forceinline__ int core_offset(int r, int k) {
  return (((r >> 3) * (KC / 4) + (k >> 2)) << 5) + ((r & 7) << 2) + (k & 3);
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - hi);
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// shared-memory matrix descriptor of a tile in the layout above
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((KC * 32) >> 4) << 32);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// thread writes to shared memory become visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d[64 x 64] = a[64 x 8] b[8 x 64] + (scale_d ? d : 0), both operands K-major
// in shared memory
__device__ __forceinline__ void mma_m64n64k8(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_begin() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// One staged chunk of K for one warpgroup, e = A B in 3xTF32 (e's old value
// is dropped): A = the chunk's 64 rows (hi and lo tiles), B = this
// warpgroup's 64 rows of the update tile (hi and lo).  The tensor cores sum
// into their accumulator with truncation, so a chain over all of K drifts
// further from the exact product than an f32 FMA chain (by 4.5 times, rms,
// at K = 128 on an H100; tools/tf32_accumulation_probe.py), and a chain per
// chunk added in f32 lands closer than the FMA chain (0.7 times): the
// caller adds e into its sum in f32 after each chunk, and fences, commits
// and waits around this call.
__device__ __forceinline__ void mma_chunk(float (&e)[32], const float* a_hi, const float* a_lo,
                                          const float* b_hi, const float* b_lo) {
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    const int o = j * 64;  // two core matrices further along K
    mma_m64n64k8(e, desc(a_lo + o), desc(b_hi + o), j > 0);
    mma_m64n64k8(e, desc(a_hi + o), desc(b_lo + o), 1);
    mma_m64n64k8(e, desc(a_hi + o), desc(b_hi + o), 1);
  }
}

// Writes a warpgroup's m64n64 accumulators to row-major shared memory
// (`pitch` floats a row) at column `col0`: thread (warp w, lane l) holds rows
// 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) and the next, j < 8.
__device__ __forceinline__ void store_acc(const float (&d)[32], float* out, int pitch, int col0) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int r = 16 * w + lane / 4, c = col0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + r * pitch + c + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (r + 8) * pitch + c + 8 * j) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

}  // namespace tf32mma
