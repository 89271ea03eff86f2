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
// What bounds it: the delta products.  At the stock shape (S=8192, cols=4,
// hop=64, bins=1025) they are S * cols * 2 signals * 2*hop * 4*bins = 34.4
// GFMA a hop, 8x the classic hop's, against ~0.4 GB of device-memory
// traffic: f32 FMA issue bound.
//
// Design.  Grid = (bin tile, stream tile).  A block of 512 threads slides
// EXT = 128 consecutive bins (TILE = 116 output bins plus a HALO of 6 each
// side, recomputed rather than exchanged: zpf 2 times 3 stencil terms) for
// TSB = 8 streams.  Thread t owns bin t % 128 for the TSN = 2 streams of its
// stream group t / 128.  The deltas of the block's streams are staged in
// shared memory and read as float4 broadcasts; the update matrix is staged
// in chunks of JC = 32 rows x 4 x 128 bins, each element read from device
// memory once per block and feeding 2 signals x CCH columns x TSB streams
// FMAs.  The accumulators of CCH = 4 columns x 2 streams x 8 parts (64
// registers) live across the pass over the rows.  The states live in shared
// memory, where the stencil reads its neighbours.  All arithmetic is plain
// f32 on the CUDA cores (no fast math, no TF32).
#include <cuda_runtime.h>

namespace {

constexpr int HALO = 6;                // max stencil reach: zpf (<= 2) * 3
constexpr int EXT = 128;               // bins slid per block
constexpr int TILE = EXT - 2 * HALO;   // output bins per block
constexpr int SG = 4;                  // stream groups per block
constexpr int TSN = 2;                 // streams per thread
constexpr int TSB = SG * TSN;          // streams per block
constexpr int NTHREADS = EXT * SG;
constexpr int CCH = 4;                 // columns whose deltas share a pass
constexpr int JC = 32;                 // update-matrix rows staged at a time
constexpr int MAXJ = 3;                // stencil terms beyond a0

struct Params {
  const float* st[8];
  float* st_out[8];
  const float* dx;     // [S, cols, 2*hop]
  const float* dh;
  const float* upd;    // [2*hop, 4*bins]
  const float* rot_r;  // [bins]
  const float* rot_i;
  const float* normq;
  const float* freqb;
  float* freq;         // [S, cols, bins]
  float* time;
  float* power;
  int S, cols, hop, bins, ready, zpf, nterms, pitch;
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
  extern __shared__ __align__(16) float smem[];
  const int cols = P.cols, two_hop = 2 * P.hop, pitch = P.pitch, bins = P.bins;
  float* sdx = smem;                            // [TSB][cols][pitch]
  float* sdh = sdx + TSB * cols * pitch;        // [TSB][cols][pitch]
  float* supd = sdh + TSB * cols * pitch;       // [JC][4][EXT]
  float* sst = supd + JC * 4 * EXT;             // [TSB][8][EXT]

  const int t = threadIdx.x;
  const int lb = t % EXT;                       // this thread's local bin
  const int sg = t / EXT;                       // its stream group
  const int tile0 = blockIdx.x * TILE;          // first output bin of the block
  const int g = tile0 - HALO + lb;              // its global bin
  const bool in_range = g >= 0 && g < bins;
  const bool emits = lb >= HALO && lb < HALO + TILE && g < bins;
  const int s0 = blockIdx.y * TSB;
  const int half = bins - 1;

  // stage the block's deltas (rows padded to a multiple of 4 with zeros)
  for (int i = t; i < TSB * cols * pitch; i += NTHREADS) {
    const int s = i / (cols * pitch);
    const int r = i - s * cols * pitch;
    const int k = r / pitch;
    const int j = r - k * pitch;
    float vx = 0.f, vh = 0.f;
    if (j < two_hop && s0 + s < P.S) {
      const long long src = ((long long)(s0 + s) * cols + k) * two_hop + j;
      vx = P.dx[src];
      vh = P.dh[src];
    }
    sdx[i] = vx;
    sdh[i] = vh;
  }
  // the block's states, halo included
  for (int i = t; i < TSB * 8 * EXT; i += NTHREADS) {
    const int s = i / (8 * EXT);
    const int v = (i / EXT) % 8;
    const int b = tile0 - HALO + i % EXT;
    const bool ok = b >= 0 && b < bins && s0 + s < P.S;
    sst[i] = ok ? P.st[v][(long long)(s0 + s) * bins + b] : 0.f;
  }
  const float rr = in_range ? P.rot_r[g] : 0.f;
  const float ri = in_range ? P.rot_i[g] : 0.f;
  const float fhop = (float)P.hop;
  __syncthreads();

  for (int c0 = 0; c0 < cols; c0 += CCH) {
    // delta products of columns c0 .. c0+CCH-1 (only those that slide)
    float acc[CCH][TSN][8];
#pragma unroll
    for (int cc = 0; cc < CCH; ++cc)
#pragma unroll
      for (int q = 0; q < TSN; ++q)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[cc][q][v] = 0.f;

    if (c0 < P.ready) {  // uniform across the block
      for (int j0 = 0; j0 < pitch; j0 += JC) {
        __syncthreads();  // the previous chunk is consumed
        for (int i = t; i < JC * 4 * EXT; i += NTHREADS) {
          const int row = i / (4 * EXT);
          const int part = (i / EXT) % 4;
          const int b = tile0 - HALO + i % EXT;
          const int jr = j0 + row;
          supd[i] = (jr < two_hop && b >= 0 && b < bins)
                        ? __ldg(P.upd + (long long)jr * 4 * bins + part * bins + b)
                        : 0.f;
        }
        __syncthreads();
        const int jn = min(JC, pitch - j0);
        for (int jj = 0; jj < jn; jj += 4) {
          float u[4][4];  // [row][part]
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int p = 0; p < 4; ++p) u[r][p] = supd[((jj + r) * 4 + p) * EXT + lb];
#pragma unroll
          for (int cc = 0; cc < CCH; ++cc) {
            const int k = c0 + cc;
            if (k < cols && k < P.ready) {
#pragma unroll
              for (int q = 0; q < TSN; ++q) {
                const int sl = sg * TSN + q;
                const float4 a = *reinterpret_cast<const float4*>(
                    sdx + (sl * cols + k) * pitch + j0 + jj);
                const float4 e = *reinterpret_cast<const float4*>(
                    sdh + (sl * cols + k) * pitch + j0 + jj);
                const float ax[4] = {a.x, a.y, a.z, a.w};
                const float eh[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                  for (int p = 0; p < 4; ++p) {
                    acc[cc][q][p] = fmaf(ax[r], u[r][p], acc[cc][q][p]);
                    acc[cc][q][4 + p] = fmaf(eh[r], u[r][p], acc[cc][q][4 + p]);
                  }
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int cc = 0; cc < CCH; ++cc) {
      const int k = c0 + cc;
      if (k >= cols) break;  // uniform
      if (k < P.ready) {     // uniform: slide and rotate the own bin's states
#pragma unroll
        for (int q = 0; q < TSN; ++q) {
          float* row = sst + (sg * TSN + q) * 8 * EXT + lb;
          const float uxr = row[0 * EXT], uxi = row[1 * EXT];
          const float uhr = row[2 * EXT], uhi = row[3 * EXT];
          const float vxr = row[4 * EXT], vxi = row[5 * EXT];
          const float vhr = row[6 * EXT], vhi = row[7 * EXT];
          // acc parts: x dUr dUi dVr dVi, then hx the same
          float re, im;
          re = uxr + acc[cc][q][0]; im = uxi + acc[cc][q][1];
          row[0 * EXT] = re * rr - im * ri; row[1 * EXT] = re * ri + im * rr;
          re = uhr + acc[cc][q][4]; im = uhi + acc[cc][q][5];
          row[2 * EXT] = re * rr - im * ri; row[3 * EXT] = re * ri + im * rr;
          re = (vxr - fhop * uxr) + acc[cc][q][2]; im = (vxi - fhop * uxi) + acc[cc][q][3];
          row[4 * EXT] = re * rr - im * ri; row[5 * EXT] = re * ri + im * rr;
          re = (vhr - fhop * uhr) + acc[cc][q][6]; im = (vhi - fhop * uhi) + acc[cc][q][7];
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
      __syncthreads();  // the next column rewrites the states
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

// Host entry: launches on `stream` and returns cudaGetLastError().
extern "C" int reassigned_hop_launch(
    const float* uxr, const float* uxi, const float* uhr, const float* uhi,
    const float* vxr, const float* vxi, const float* vhr, const float* vhi,
    float* uxr_o, float* uxi_o, float* uhr_o, float* uhi_o,
    float* vxr_o, float* vxi_o, float* vhr_o, float* vhi_o,
    const float* dx, const float* dh, const float* upd,
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
  P.dx = dx; P.dh = dh; P.upd = upd;
  P.rot_r = rot_r; P.rot_i = rot_i; P.normq = normq; P.freqb = freqb;
  P.freq = freq; P.time = time; P.power = power;
  P.S = S; P.cols = cols; P.hop = hop; P.bins = bins; P.ready = ready;
  P.zpf = zpf; P.nterms = nterms; P.pitch = (2 * hop + 3) / 4 * 4;
  P.a0 = a0;
  P.halves[0] = h1; P.halves[1] = h2; P.halves[2] = h3;
  P.gs[0] = g1; P.gs[1] = g2; P.gs[2] = g3;
  P.inv_2pi = inv_2pi; P.inv_hop = inv_hop; P.latency_hops = latency_hops;

  const size_t smem = sizeof(float) * ((size_t)2 * TSB * cols * P.pitch +
                                       (size_t)JC * 4 * EXT + (size_t)TSB * 8 * EXT);
  cudaError_t err = cudaFuncSetAttribute(
      reassigned_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((bins + TILE - 1) / TILE, (S + TSB - 1) / TSB);
  reassigned_hop_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
