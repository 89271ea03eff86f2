// Sliding-analytic reassigned spectrogram hop for Hopper (sm_90a).
//
// Replaces openmeters_tpu/ops/pallas_sliding_reassigned.py::
// reassigned_sliding_hop (_build).  Per stream the hop carries eight
// one-sided [bins] states: U and V (the unwindowed and the ramp-weighted
// spectrum) of the raw signal x and of its Hilbert transform hx, real and
// imaginary parts, in the order uxr uxi uhr uhi vxr vxi vhr vhi.  For each of
// `cols` columns, in order:
//
//   1. deltas  [dU_re dU_im dV_re dV_im] = d_k . upd   for d = dx and d = dh
//      (upd is the fused [2*hop, 4*bins] matrix, rows [new; old] samples)
//   2. slide   U' = rot (U + dU),  V' = rot (V - hop U + dV)
//      only if k < ready, else the states are held
//   3. the complex analytic spectra U = Ux + i Uhx and V on bins
//      [-reach, half + reach]: past bin 0 and Nyquist both halves reflect
//      hermitian, Z[-m] = (xr[m] + hi[m]) + i (hr[m] - xi[m])
//   4. stencils  B = a0 U + sum_j a_j/2 (U[b-zj] + U[b+zj])     (window)
//                T = the same over V                             ((t-c) window)
//                D = sum_j i pi j a_j / n (U[b-zj] - U[b+zj])   (derivative)
//   5. corrections  freq = freqb + Im(D conj B)/|B|^2 * fs/2pi (sign as below)
//                   time = Re(T conj B)/|B|^2 / hop - latency
//                   power = |B|^2 * normq
//
// What bounds it.  At the stock shape (S=8192, cols=4, hop=64, bins=1025)
// the delta products are S * cols * 2 signals * 2*hop * 4*bins = 34.4 GFMA
// a hop: 1.03 ms at the card's f32 CUDA-core rate (67 TFLOP/s), 0.42 ms as
// 3xTF32 on the tensor cores (206 GFLOP at 495 TFLOP/s), against ~0.98 GB
// of device-memory traffic (the states in and out, dx, dh, the constants,
// freq / time / power): 0.29 ms at 3.35 TB/s.  Operations bind, on the
// tensor cores too.
//
// Design.  The products are a GEMM, A = the block's deltas [TSB streams x
// CC columns x 2 signals = 64 rows, K = 2*hop], B = the block's update tile
// [K, 4 parts x EXT bins], run on the tensor cores in 3xTF32
// (tf32_wgmma.cuh).  Grid = (bin tile, stream tile).  A block of 512
// threads, four warpgroups, slides EXT = 128 consecutive bins (TILE = 116
// output bins plus a HALO of 6 each side, recomputed rather than exchanged:
// zpf 2 times 3 stencil terms) for TSB = 8 streams.  Per pass over CC = 4
// columns (rows of columns past `cols` are zero):
//
//   - GEMM phase, once for each half tile of 64 bins (wgmma m64n64k8;
//     warpgroup p computes part p, dU_re dU_im dV_re dV_im, of all 64
//     rows): K, padded to a multiple of KC = 16 with zeros, streams through
//     two shared-memory stages.  Each thread requests its share of chunk
//     kc+2 (two delta values, two float4 of the update tile) into registers
//     while chunk kc's products run, and splits chunk kc+1, requested one
//     step earlier, into the hi / lo tiles of the other stage.  Each
//     chunk's products start from zero and are added into the sum in f32:
//     the tensor cores truncate as they accumulate, and a chain over all of
//     K would land further from the exact product than an f32 FMA chain.
//     The update tile comes in f32, K-major in the stage's own layout
//     (ops/update_tiles.py), and is split here as it is staged: each block
//     reads its 256 KB from L2 once per 64 delta rows, and a split made in
//     advance would double those bytes.  Halves keep the two accumulators
//     of a thread at 32 registers each.
//   - Epilogue: the two halves' products go to shared memory (the second
//     over the ring); then, column by column, thread t slides bin t % 128
//     for the TSN = 2 streams of its stream group t / 128 (the states live
//     in shared memory, where the stencil reads its neighbours), and steps
//     3-5 run as before.
//
// The re-anchor (ops/sliding_reassigned.py) subtracts dx_0 . upd computed
// by torch.matmul in full f32, and this kernel adds its own product back,
// so the anchor lands exactly only to the two products' rounding.  3xTF32
// summed a chunk at a time keeps that residual at f32's level: its products
// land closer to the exact ones than an f32 FMA chain's
// (tools/tf32_accumulation_probe.py), and one hop of this kernel lands
// closer to the float64 plain version than the f32 plain version does
// (chip_smoke.py phase 6 prints both).  All other arithmetic is plain f32
// on the CUDA cores (no fast math).
#include <cuda_runtime.h>

#include "tf32_wgmma.cuh"

namespace {

using tf32mma::KC;

constexpr int HALO = 6;                // max stencil reach: zpf (<= 2) * 3
constexpr int EXT = 128;               // bins slid per block
constexpr int TILE = EXT - 2 * HALO;   // output bins per block
constexpr int SG = 4;                  // stream groups per block
constexpr int TSN = 2;                 // streams per thread
constexpr int TSB = SG * TSN;          // streams per block
constexpr int NTHREADS = EXT * SG;     // four warpgroups
constexpr int CC = 4;                  // columns per GEMM pass
constexpr int ROWS = TSB * CC * 2;     // delta rows per pass: streams x columns x signals
constexpr int HALF = EXT / 2;          // bins of a half tile: one wgmma N of 64
constexpr int NB = 4 * HALF;           // update-tile rows of a half: 4 parts
constexpr int STAGE = 2 * ROWS * KC + 2 * NB * KC;  // floats: A hi, A lo, B hi, B lo
constexpr int APITCH = NB + 8;         // staged accumulator row of a half, padded
constexpr int MAXJ = 3;                // stencil terms beyond a0
static_assert(ROWS == 64, "one wgmma M tile per pass");
static_assert(ROWS * APITCH <= 2 * STAGE, "the second half's accumulators fit over the ring");

struct Params {
  const float* st[8];
  float* st_out[8];
  const float* dx;     // [S, cols, 2*hop]
  const float* dh;
  const float* tiles;  // [bin tiles, 2 halves, nk, NB x KC] f32 update tiles
  const float* rot_r;  // [bins]
  const float* rot_i;
  const float* normq;
  const float* freqb;
  float* freq;         // [S, cols, bins]
  float* time;
  float* power;
  int S, cols, hop, bins, ready, zpf, nterms, nk;
  float a0, halves[MAXJ], gs[MAXJ];
  float inv_2pi, inv_hop, latency_hops;
};

// complex U (base 0) or V (base 4) at global bin p, with the analytic edge
// reflection; `row` points at the stream's 8 state rows in shared memory
__device__ __forceinline__ float2 spectrum_at(const float* row, int base, int p,
                                              int half, int tile0) {
  const float* xr = row + (base + 0) * EXT;
  const float* xi = row + (base + 1) * EXT;
  const float* hr = row + (base + 2) * EXT;
  const float* hi = row + (base + 3) * EXT;
  int m = p;
  bool mirrored = false;
  if (p < 0) {
    m = -p;
    mirrored = true;
  } else if (p > half) {
    m = 2 * half - p;
    mirrored = true;
  }
  const int loc = m - tile0 + HALO;
  if (mirrored) return make_float2(xr[loc] + hi[loc], hr[loc] - xi[loc]);
  return make_float2(xr[loc] - hi[loc], xi[loc] + hr[loc]);
}

__global__ void __launch_bounds__(NTHREADS, 1) reassigned_hop_kernel(const Params P) {
  extern __shared__ __align__(128) float smem[];
  const int cols = P.cols, two_hop = 2 * P.hop, bins = P.bins;
  float* acc0 = smem;                           // [ROWS][APITCH] the first half's products
  float* ring = acc0 + ROWS * APITCH;           // K stages; then the second half's products
  float* sst = ring + 2 * STAGE;           // [TSB][8][EXT]

  const int t = threadIdx.x;
  const int lb = t % EXT;                       // this thread's local bin
  const int sg = t / EXT;                       // its stream group and warpgroup
  const int tile0 = blockIdx.x * TILE;          // first output bin of the block
  const int g = tile0 - HALO + lb;              // its global bin
  const bool in_range = g >= 0 && g < bins;
  const bool emits = lb >= HALO && lb < HALO + TILE && g < bins;
  const int s0 = blockIdx.y * TSB;
  const int half = bins - 1;
  const float* tiles = P.tiles + (long long)blockIdx.x * 2 * P.nk * NB * KC;
  // the staged products of this thread's bin: row r, part v at acc[r * APITCH + v * HALF]
  const float* acc = (lb < HALF ? acc0 : ring) + lb % HALF;

  // the block's states, halo included, copied in while the products run
  for (int i = t; i < TSB * 8 * EXT; i += NTHREADS) {
    const int s = i / (8 * EXT);
    const int v = (i / EXT) % 8;
    const int b = tile0 - HALO + i % EXT;
    const bool ok = b >= 0 && b < bins && s0 + s < P.S;
    const float* src = ok ? P.st[v] + (long long)(s0 + s) * bins + b : P.st[v];
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(sst + i))),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const float rr = in_range ? P.rot_r[g] : 0.f;
  const float ri = in_range ? P.rot_i[g] : 0.f;
  const float fhop = (float)P.hop;

  for (int c0 = 0; c0 < cols; c0 += CC) {
    if (c0 < P.ready) {  // uniform across the block
      // delta products of columns c0 .. c0+CC-1, one half tile at a time;
      // row r = (stream * CC + column) * 2 + signal, signal 0 = x, 1 = hx
      for (int h = 0; h < 2; ++h) {
        const float* src = tiles + (long long)h * P.nk * NB * KC;
        float d[32], e[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        float av[2];
        float4 bv[2];
        auto load = [&](int kc) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int el = t + i * NTHREADS;  // element (el / KC, el % KC) of the chunk's A
            const int r = el / KC, k = kc * KC + el % KC;
            const int s = s0 + r / (2 * CC), c = c0 + (r / 2) % CC;
            av[i] = s < P.S && c < cols && k < two_hop
                        ? __ldg((r & 1 ? P.dh : P.dx) + ((long long)s * cols + c) * two_hop + k)
                        : 0.f;
          }
          const float4* b = reinterpret_cast<const float4*>(src + (long long)kc * NB * KC);
#pragma unroll
          for (int i = 0; i < 2; ++i) bv[i] = __ldg(b + t + i * NTHREADS);
        };
        auto store = [&](float* st) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int el = t + i * NTHREADS;
            const int o = tf32mma::core_offset(el / KC, el % KC);
            tf32mma::split(av[i], st[o], st[ROWS * KC + o]);
          }
          float4* bh = reinterpret_cast<float4*>(st + 2 * ROWS * KC);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float4 hi, lo;
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
          const float* b = st + 2 * ROWS * KC + sg * HALF * KC;  // this warpgroup's part
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
        __syncthreads();  // every warpgroup is done with the ring
        tf32mma::store_acc(d, h ? ring : acc0, APITCH, sg * HALF);
      }
      __syncthreads();
    }

    asm volatile("cp.async.wait_all;" ::: "memory");  // the states are in
    __syncthreads();
    for (int cc = 0; cc < CC; ++cc) {
      const int k = c0 + cc;
      if (k >= cols) break;  // uniform
      if (k < P.ready) {     // uniform: slide and rotate the own bin's states
#pragma unroll
        for (int q = 0; q < TSN; ++q) {
          float* row = sst + (sg * TSN + q) * 8 * EXT + lb;
          // the products: x dUr dUi dVr dVi, then hx the same
          const float* ax = acc + ((sg * TSN + q) * CC + cc) * 2 * APITCH;
          const float* ah = ax + APITCH;
          const float uxr = row[0 * EXT], uxi = row[1 * EXT];
          const float uhr = row[2 * EXT], uhi = row[3 * EXT];
          const float vxr = row[4 * EXT], vxi = row[5 * EXT];
          const float vhr = row[6 * EXT], vhi = row[7 * EXT];
          float re, im;
          re = uxr + ax[0 * HALF]; im = uxi + ax[1 * HALF];
          row[0 * EXT] = re * rr - im * ri; row[1 * EXT] = re * ri + im * rr;
          re = uhr + ah[0 * HALF]; im = uhi + ah[1 * HALF];
          row[2 * EXT] = re * rr - im * ri; row[3 * EXT] = re * ri + im * rr;
          re = (vxr - fhop * uxr) + ax[2 * HALF]; im = (vxi - fhop * uxi) + ax[3 * HALF];
          row[4 * EXT] = re * rr - im * ri; row[5 * EXT] = re * ri + im * rr;
          re = (vhr - fhop * uhr) + ah[2 * HALF]; im = (vhi - fhop * uhi) + ah[3 * HALF];
          row[6 * EXT] = re * rr - im * ri; row[7 * EXT] = re * ri + im * rr;
        }
      }
      __syncthreads();

      if (emits) {
        const float nq = P.normq[g];
        const float fb = P.freqb[g];
#pragma unroll
        for (int q = 0; q < TSN; ++q) {
          const int s = s0 + sg * TSN + q;
          if (s >= P.S) break;
          const float* row = sst + (sg * TSN + q) * 8 * EXT;
          const float2 u0 = spectrum_at(row, 0, g, half, tile0);
          const float2 v0 = spectrum_at(row, 4, g, half, tile0);
          float br = P.a0 * u0.x, bi = P.a0 * u0.y;
          float tr = P.a0 * v0.x, ti = P.a0 * v0.y;
          float dr = 0.f, di = 0.f;
#pragma unroll
          for (int j = 1; j <= MAXJ; ++j) {
            if (j >= P.nterms) break;
            const int jz = P.zpf * j;
            const float hv = P.halves[j - 1], gv = P.gs[j - 1];
            const float2 ul = spectrum_at(row, 0, g - jz, half, tile0);
            const float2 uh = spectrum_at(row, 0, g + jz, half, tile0);
            const float2 vl = spectrum_at(row, 4, g - jz, half, tile0);
            const float2 vh = spectrum_at(row, 4, g + jz, half, tile0);
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
          const long long o = ((long long)s * cols + k) * bins + g;
          P.freq[o] = fb + d_omega * P.inv_2pi;
          P.time[o] = (tr * br + ti * bi) * inv_pow * P.inv_hop - P.latency_hops;
          P.power[o] = pow_raw * nq;
        }
      }
      __syncthreads();  // the next column rewrites the states, the next pass the ring
    }
  }

  if (emits) {
#pragma unroll
    for (int q = 0; q < TSN; ++q) {
      const int s = s0 + sg * TSN + q;
      if (s >= P.S) break;
      const float* row = sst + (sg * TSN + q) * 8 * EXT + lb;
#pragma unroll
      for (int v = 0; v < 8; ++v) P.st_out[v][(long long)s * bins + g] = row[v * EXT];
    }
  }
}

}  // namespace

// Host entry: launches on `stream` and returns cudaGetLastError().  `tiles`
// is the fused update matrix's tile image (ops/update_tiles.py: parts
// U_re | U_im | V_re | V_im, EXT = 128, HALO = 6).
extern "C" int reassigned_hop_launch(
    const float* uxr, const float* uxi, const float* uhr, const float* uhi,
    const float* vxr, const float* vxi, const float* vhr, const float* vhi,
    float* uxr_o, float* uxi_o, float* uhr_o, float* uhi_o,
    float* vxr_o, float* vxi_o, float* vhr_o, float* vhi_o,
    const float* dx, const float* dh, const float* tiles,
    const float* rot_r, const float* rot_i, const float* normq, const float* freqb,
    float* freq, float* time, float* power,
    int S, int cols, int hop, int bins, int ready, int zpf, int nterms,
    float a0, float h1, float h2, float h3, float g1, float g2, float g3,
    float inv_2pi, float inv_hop, float latency_hops, void* stream) {
  if (S == 0 || cols == 0) return 0;
  if (nterms < 1 || nterms > MAXJ + 1 || zpf < 1 || zpf * (nterms - 1) > HALO || hop < 1)
    return (int)cudaErrorInvalidValue;
  Params P;
  const float* in[8] = {uxr, uxi, uhr, uhi, vxr, vxi, vhr, vhi};
  float* out[8] = {uxr_o, uxi_o, uhr_o, uhi_o, vxr_o, vxi_o, vhr_o, vhi_o};
  for (int v = 0; v < 8; ++v) {
    P.st[v] = in[v];
    P.st_out[v] = out[v];
  }
  P.dx = dx; P.dh = dh; P.tiles = tiles;
  P.rot_r = rot_r; P.rot_i = rot_i; P.normq = normq; P.freqb = freqb;
  P.freq = freq; P.time = time; P.power = power;
  P.S = S; P.cols = cols; P.hop = hop; P.bins = bins; P.ready = ready;
  P.zpf = zpf; P.nterms = nterms; P.nk = (2 * hop + KC - 1) / KC;
  P.a0 = a0;
  P.halves[0] = h1; P.halves[1] = h2; P.halves[2] = h3;
  P.gs[0] = g1; P.gs[1] = g2; P.gs[2] = g3;
  P.inv_2pi = inv_2pi; P.inv_hop = inv_hop; P.latency_hops = latency_hops;

  const size_t smem = sizeof(float) * ((size_t)ROWS * APITCH + 2 * (size_t)STAGE + (size_t)TSB * 8 * EXT);
  cudaError_t err = cudaFuncSetAttribute(
      reassigned_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((bins + TILE - 1) / TILE, (S + TSB - 1) / TSB);
  reassigned_hop_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
