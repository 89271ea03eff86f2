// Sliding-DFT hop from sample deltas for Hopper (sm_90a), "B1a".
//
// Replaces openmeters_tpu/ops/pallas_sliding.py::sliding_hop, its
// whole-row variant (_build).  For each stream and each of `cols` columns,
// in order:
//
//   1. D_k = d_k . upd                  the column's `hop` sample deltas
//                                       against the [hop, bins] DFT update
//                                       matrices (re and im)
//   2. F = rot * (F + D_k)              only if k < ready, else F is held
//   3. W = a0 F[b] + sum_j a_j/2 (F[b-j] + F[b+j]), hermitian reflection at
//      bin 0 and at Nyquist (the cosine-sum window as a frequency stencil)
//   4. W -= (F[0] / n) dc_corr          (DC removal, post-slide bin 0)
//   5. p = |W|^2 norm, emitted as float32 or (kCodes) as
//      code = clip(rint((max(ln(max(p, 1e-45)) LN_TO_DB, floor) + 144)
//                  * 65535/156), 0, 65535) uint16
//
// and writes the new state (fr, fi) and the columns [S, cols, bins].
//
// What bounds it.  At the flagship shape (S=8192, cols=4, hop=64, bins=1025)
// the products are 4.3 GFMA a hop: 0.128 ms at the card's f32 CUDA-core
// rate (67 TFLOP/s), 0.052 ms as 3xTF32 on the tensor cores (25.8 GFLOP at
// 495 TFLOP/s), against ~0.21 GB of device-memory traffic (the state in and
// out, the deltas, the columns out): 0.063 ms at 3.35 TB/s.  On the tensor
// cores, bytes bind.
//
// Design.  The products are a GEMM, A = the block's deltas [TS streams x CC
// columns = 64 rows, K = hop], B = the block's update tile [K, re | im x EXT
// bins], run on the tensor cores in 3xTF32 (tf32_wgmma.cuh).  Grid = (bin
// tile, stream tile).  A block of two warpgroups slides EXT = 128
// consecutive bins -- TILE = 122 output bins plus a HALO of 3 on each side,
// recomputed rather than exchanged -- for TS = 16 streams.  Per pass over CC
// = 4 columns (M = 64, one wgmma tile; rows of columns past `cols` are zero):
//
//   - GEMM phase, once for each half tile of 64 bins (wgmma m64n64k8;
//     warpgroup 0 computes the real parts, warpgroup 1 the imaginary): K,
//     padded to a multiple of KC = 16 with zeros, streams through two
//     shared-memory stages.  Each thread requests its share of chunk kc+2
//     (one float4 of deltas, two of the update tile) into registers while
//     chunk kc's products run, and splits chunk kc+1, requested one step
//     earlier, into the hi / lo tiles of the other stage.  Each chunk's products
//     start from zero and are added into the sum in f32: the tensor cores
//     truncate as they accumulate, and a chain over all of K would land
//     further from the exact product than an f32 FMA chain.  The update
//     tile comes in f32, K-major in the stage's own layout
//     (ops/update_tiles.py), and is split here as it is staged: it is read
//     from L2 once per 64 delta rows, and a split made in advance would
//     double those bytes.  Halves keep the two accumulators of a thread at
//     32 registers each.
//   - Epilogue: the two halves' products go to shared memory (the second
//     over the ring); then, column by column, each thread slides its own bin
//     for 8 streams (the state stays in registers across the hop), the slid
//     values go through shared memory for the stencil, and the DC / power /
//     pack run as before.
//
// The re-anchor (ops/sliding_stft.py) subtracts d_0 . upd computed by
// torch.matmul in full f32, and this kernel adds its own product back, so
// the anchor lands exactly only to the two products' rounding: 3xTF32
// summed a chunk at a time keeps that residual at f32's level
// (tools/tf32_accumulation_probe.py).  All other arithmetic is full f32
// (no fast math: logf, no flush to zero).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

using tf32mma::KC;

constexpr int HALO = 3;                // max stencil reach, len(coeffs) - 1
constexpr int EXT = 128;               // bins slid per block
constexpr int TILE = EXT - 2 * HALO;   // output bins per block
constexpr int TSN = 8;                 // streams per thread
constexpr int TS = 2 * TSN;            // streams per block
constexpr int NTHREADS = 2 * EXT;      // two warpgroups, one bin a thread each
constexpr int CC = 4;                  // columns per GEMM pass
constexpr int ROWS = TS * CC;          // delta rows per pass
constexpr int HALF = EXT / 2;          // bins of a half tile: one wgmma N of 64
constexpr int NB = 2 * HALF;           // update-tile rows of a half: re and im
constexpr int STAGE = 2 * ROWS * KC + 2 * NB * KC;  // floats: A hi, A lo, B hi, B lo
constexpr int APITCH = NB + 8;         // staged accumulator row of a half, padded
constexpr float LN_TO_DB = 4.3429448f;
constexpr float STORE_LO = -144.0f;
static_assert(ROWS == 64, "one wgmma M tile per pass");
static_assert(ROWS * APITCH <= 2 * STAGE, "the second half's accumulators fit over the ring");

struct Params {
  const float* fr;
  const float* fi;
  const float* deltas;  // [S, cols, hop]
  const float* tiles;   // [bin tiles, 2 halves, nk, NB x KC] f32 update tiles
  const float* rot_r;   // [bins]
  const float* rot_i;
  const float* dc_corr;
  const float* norm;
  float* fr_out;
  float* fi_out;
  void* out;            // [S, cols, bins] uint16 codes or float32 power
  int S, cols, hop, bins, ready, nk, reach, dc_bins;
  float inv_n, a0, halves[3], floor_db, store_scale;
};

template <bool kCodes>
__global__ void __launch_bounds__(NTHREADS, 2) sliding_hop_deltas_kernel(const Params P) {
  extern __shared__ __align__(128) float smem[];
  float* acc0 = smem;                  // [ROWS][APITCH] the first half's products
  float* ring = acc0 + ROWS * APITCH;  // two K stages; then the second half's products
  float* sre = ring + 2 * STAGE;       // [TS][EXT] slid real parts
  float* sim = sre + TS * EXT;         // [TS][EXT] slid imaginary parts

  const int t = threadIdx.x;
  const int lb = t % EXT;              // this thread's local bin
  const int sg = t / EXT;              // its stream group and warpgroup
  const int cols = P.cols, hop = P.hop, bins = P.bins;
  const int tile0 = blockIdx.x * TILE;  // first output bin of the block
  const int g = tile0 - HALO + lb;      // this thread's bin
  const bool in_range = g >= 0 && g < bins;
  const bool emits = lb >= HALO && lb < HALO + TILE && g < bins;
  const int s0 = blockIdx.y * TS;
  const float* tiles = P.tiles + (long long)blockIdx.x * 2 * P.nk * NB * KC;
  // the staged products of this thread's bin: row r at acc[r * APITCH], im HALF further
  const float* acc = (lb < HALF ? acc0 : ring) + lb % HALF;

  float xr[TSN], xi[TSN];
  float rr = 0.f, ri = 0.f;
  if (in_range) {
    rr = P.rot_r[g];
    ri = P.rot_i[g];
  }
#pragma unroll
  for (int q = 0; q < TSN; ++q) {
    const int s = s0 + sg * TSN + q;
    const bool ok = in_range && s < P.S;
    xr[q] = ok ? P.fr[(long long)s * bins + g] : 0.f;
    xi[q] = ok ? P.fi[(long long)s * bins + g] : 0.f;
  }

  // this thread's share of a chunk: deltas row ar (stream ar / CC, column
  // ar % CC of the pass), values ak .. ak+3; two float4 of the update tile
  const int ar = t >> 2, ak = (t & 3) * 4;
  const int as = s0 + ar / CC;

  for (int c0 = 0; c0 < cols; c0 += CC) {
    if (c0 < P.ready) {  // uniform across the block
      // delta products of columns c0 .. c0+CC-1, one half tile at a time
      const int ac = c0 + ar % CC;
      const bool arow = as < P.S && ac < cols;
      const float* asrc = P.deltas + ((long long)as * cols + ac) * hop;
      for (int h = 0; h < 2; ++h) {
        const float* src = tiles + (long long)h * P.nk * NB * KC;
        float d[32], e[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        float4 av, bv[2];
        auto load = [&](int kc) {
          const int k = kc * KC + ak;  // hop % 4 == 0: a float4 is all in or all out
          av = arow && k < hop ? *reinterpret_cast<const float4*>(asrc + k)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4* b = reinterpret_cast<const float4*>(src + (long long)kc * NB * KC);
#pragma unroll
          for (int i = 0; i < 2; ++i) bv[i] = __ldg(b + t + i * NTHREADS);
        };
        auto store = [&](float* st) {
          float4 hi, lo;
          tf32mma::split4(av, hi, lo);
          const int o = tf32mma::core_offset(ar, ak);
          *reinterpret_cast<float4*>(st + o) = hi;
          *reinterpret_cast<float4*>(st + ROWS * KC + o) = lo;
          float4* bh = reinterpret_cast<float4*>(st + 2 * ROWS * KC);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tf32mma::split4(bv[i], hi, lo);
            bh[t + i * NTHREADS] = hi;
            bh[NB * KC / 4 + t + i * NTHREADS] = lo;
          }
        };

        // chunk kc+2 is in flight from global memory while chunk kc+1 goes into
        // the stage that chunk kc-1 left and chunk kc's products run
        load(0);
        store(ring);
        if (P.nk > 1) load(1);
        for (int kc = 0; kc < P.nk; ++kc) {
          tf32mma::fence_proxy();
          __syncthreads();  // stage kc is written; the products of kc-1 are done
          const float* st = ring + (kc & 1) * STAGE;
          const float* b = st + 2 * ROWS * KC + sg * HALF * KC;  // re or im
          tf32mma::fence_operands(e);
          tf32mma::mma_begin();
          tf32mma::mma_chunk(e, st, st + ROWS * KC, b, b + NB * KC);
          tf32mma::mma_commit();
          if (kc + 1 < P.nk) store(ring + ((kc + 1) & 1) * STAGE);
          if (kc + 2 < P.nk) load(kc + 2);
          tf32mma::mma_wait();
          tf32mma::fence_operands(e);
#pragma unroll
          for (int i = 0; i < 32; ++i) d[i] += e[i];
        }
        __syncthreads();  // both warpgroups are done with the ring
        tf32mma::store_acc(d, h ? ring : acc0, APITCH, sg * HALF);
      }
      __syncthreads();
    }

    for (int kk = 0; kk < CC; ++kk) {
      const int k = c0 + kk;
      if (k >= cols) break;  // uniform across the block
      if (k < P.ready) {
#pragma unroll
        for (int q = 0; q < TSN; ++q) {
          const float* a = acc + ((sg * TSN + q) * CC + kk) * APITCH;
          const float tr = xr[q] + a[0];
          const float ti = xi[q] + a[HALF];
          xr[q] = tr * rr - ti * ri;
          xi[q] = tr * ri + ti * rr;
        }
      }
#pragma unroll
      for (int q = 0; q < TSN; ++q) {
        sre[(sg * TSN + q) * EXT + lb] = xr[q];
        sim[(sg * TSN + q) * EXT + lb] = xi[q];
      }
      __syncthreads();

      if (emits) {
        const float nrm = P.norm[g];
        const float dc = g < P.dc_bins ? P.dc_corr[g] : 0.f;
#pragma unroll
        for (int q = 0; q < TSN; ++q) {
          const int s = s0 + sg * TSN + q;
          if (s >= P.S) break;
          const float* pr = sre + (sg * TSN + q) * EXT;
          const float* pi = sim + (sg * TSN + q) * EXT;
          float wr = P.a0 * xr[q];
          float wi = P.a0 * xi[q];
#pragma unroll
          for (int j = 1; j <= HALO; ++j) {
            if (j > P.reach) break;
            float lr, li, hr, hi;
            if (g - j >= 0) {
              lr = pr[lb - j];
              li = pi[lb - j];
            } else {  // F[-m] = conj(F[m])
              const int loc = (j - g) - tile0 + HALO;
              lr = pr[loc];
              li = -pi[loc];
            }
            if (g + j <= bins - 1) {
              hr = pr[lb + j];
              hi = pi[lb + j];
            } else {  // F[N - m] = conj(F[m]) past Nyquist
              const int loc = (2 * (bins - 1) - (g + j)) - tile0 + HALO;
              hr = pr[loc];
              hi = -pi[loc];
            }
            wr = wr + P.halves[j - 1] * (lr + hr);
            wi = wi + P.halves[j - 1] * (li + hi);
          }
          if (g < P.dc_bins) {  // only bins < len(coeffs), all in tile 0
            const float mean = pr[HALO - tile0] * P.inv_n;
            wr = wr - mean * dc;
          }
          const float p = (wr * wr + wi * wi) * nrm;
          const long long o = ((long long)s * cols + k) * bins + g;
          if constexpr (kCodes) {
            const float db = fmaxf(logf(fmaxf(p, 1e-45f)) * LN_TO_DB, P.floor_db);
            float code = rintf((db - STORE_LO) * P.store_scale);  // half to even
            code = fminf(fmaxf(code, 0.f), 65535.f);
            static_cast<uint16_t*>(P.out)[o] = (uint16_t)code;
          } else {
            static_cast<float*>(P.out)[o] = p;
          }
        }
      }
      __syncthreads();  // the next column overwrites sre/sim, the next pass the ring
    }
  }

  if (emits) {
#pragma unroll
    for (int q = 0; q < TSN; ++q) {
      const int s = s0 + sg * TSN + q;
      if (s < P.S) {
        P.fr_out[(long long)s * bins + g] = xr[q];
        P.fi_out[(long long)s * bins + g] = xi[q];
      }
    }
  }
}

template <bool kCodes>
int launch(const Params& P, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * APITCH + 2 * (size_t)STAGE + 2 * (size_t)TS * EXT);
  cudaError_t err = cudaFuncSetAttribute(sliding_hop_deltas_kernel<kCodes>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P.bins + TILE - 1) / TILE, (P.S + TS - 1) / TS);
  sliding_hop_deltas_kernel<kCodes><<<grid, NTHREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// Host entry: launches on `stream` and returns cudaGetLastError().  `tiles`
// is the update matrices' tile image (ops/update_tiles.py: parts re | im,
// EXT = 128, HALO = 3); `out` is uint16 codes when emit_codes is nonzero,
// else float32 power.
extern "C" int sliding_hop_launch(
    const float* fr, const float* fi, const float* deltas, const float* tiles,
    const float* rot_r, const float* rot_i, const float* dc_corr, const float* norm,
    float* fr_out, float* fi_out, void* out,
    int S, int cols, int hop, int bins, int ready,
    float inv_n, float a0, float h1, float h2, float h3, int reach, int dc_bins,
    float floor_db, float store_scale, int emit_codes, void* stream) {
  if (S == 0 || cols == 0) return 0;
  if (reach > HALO || hop < 4 || hop % 4 != 0 || dc_bins > TILE)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.fr = fr; P.fi = fi; P.deltas = deltas; P.tiles = tiles;
  P.rot_r = rot_r; P.rot_i = rot_i; P.dc_corr = dc_corr; P.norm = norm;
  P.fr_out = fr_out; P.fi_out = fi_out; P.out = out;
  P.S = S; P.cols = cols; P.hop = hop; P.bins = bins; P.ready = ready;
  P.nk = (hop + KC - 1) / KC; P.reach = reach; P.dc_bins = dc_bins;
  P.inv_n = inv_n; P.a0 = a0;
  P.halves[0] = h1; P.halves[1] = h2; P.halves[2] = h3;
  P.floor_db = floor_db; P.store_scale = store_scale;
  const auto st = static_cast<cudaStream_t>(stream);
  return emit_codes ? launch<true>(P, st) : launch<false>(P, st);
}
