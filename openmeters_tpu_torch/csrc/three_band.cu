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
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction) in the order of the plain version, so the
// two agree to the bit; each filter's recurrence stays serial, in the
// registers of one thread.
//
// What bounds it: the bytes (x once, three bands out, the state in and out),
// ~64 MB a hop at S=8192 stereo, ~20 us at 3.35 TB/s; and, for long blocks,
// the serial chain: a lane's T samples at ~4 * CN * 15 issued instructions
// each.  A kernel that loads as it goes, one thread a lane, waits on the
// memory's latency instead: a warp has only its unrolled loads in flight,
// and 128 lanes a block leave SMs idle at 192 kHz (S=2048: 32 blocks).
//
// Design.  A block is one tile of 32 lanes and three warps:
//  - warp 0 moves the data.  It keeps IN_STAGES chunks of CHUNK samples of
//    the tile's input in flight into a ring in shared memory, by 4-byte
//    cp.async (any L, any alignment: one 128-byte row a warp instruction),
//    each chunk completing on an mbarrier; and it drains each finished
//    chunk of bands from shared memory with coalesced row stores, which the
//    chain never waits on.
//  - warp 1 runs LP_lo and HP_lo: low into the chunk's band tile, al into
//    a ring that hands it to warp 2.
//  - warp 2 runs LP_hi on al and HP_hi on al or x: mid and high.
// The two chain warps split a lane's filters, so a lane's samples issue on
// two schedulers; at 192 kHz (L=4096) the 128 tiles give every SM a tile.
// Coefficients and state are read once a tile and the state written back
// at the end.  (One warp a filter, five warps a block, was slower at every
// shape measured; PERF.md.)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LANES = 32;        // lanes a tile: one warp
constexpr int CHUNK = 16;        // samples a chunk
constexpr int IN_STAGES = 8;     // input chunks in flight
constexpr int AL_STAGES = 2;     // chunks of al between the chain warps
constexpr int OUT_STAGES = 3;    // chunks of bands between the chain warps and the drain
constexpr int THREADS = 3 * 32;  // mover, low stage, high stage

// A whole chunk's length, known to the compiler where it unrolls the chain.
struct FullChunk {
  __device__ constexpr operator int() const { return CHUNK; }
};

struct Smem {
  float in[IN_STAGES][CHUNK][LANES];
  float al[AL_STAGES][CHUNK][LANES];
  float out[OUT_STAGES][CHUNK][3][LANES];  // a chunk of bands [t][band][lane]
  uint64_t in_full[IN_STAGES];             // 32 async arrivals: the mover's copies landed
  uint64_t al_full[AL_STAGES];             // the low stage wrote al
  uint64_t al_free[AL_STAGES];             // the high stage read al
  uint64_t done[OUT_STAGES];               // both chain warps finished the chunk
  uint64_t out_free[OUT_STAGES];           // the mover drained the chunk's bands
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.shared::cta.b64 st, [%0]; }" ::"r"(smem(b))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem(b);
  uint32_t ok = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)), "l"(src) : "memory");
}

// Arrives on `b` once every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem(b)) : "memory");
}

// A position in a ring of N slots and the parity of its barriers' phase.
template <int N>
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == N) {
      slot = 0;
      phase ^= 1;
    }
  }
};

struct Biquad {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ Biquad load_biquad(const float* coeffs, int f) {
  return {coeffs[5 * f], coeffs[5 * f + 1], coeffs[5 * f + 2], coeffs[5 * f + 3], coeffs[5 * f + 4]};
}

__device__ __forceinline__ float biquad(const Biquad& c, float x, float& z0, float& z1) {
  const float y = __fadd_rn(__fmul_rn(c.b0, x), z0);
  const float nz0 = __fadd_rn(__fsub_rn(__fmul_rn(c.b1, x), __fmul_rn(c.a1, y)), z1);
  const float nz1 = __fsub_rn(__fmul_rn(c.b2, x), __fmul_rn(c.a2, y));
  const bool ok = isfinite(y);
  z0 = ok ? nz0 : 0.f;
  z1 = ok ? nz1 : 0.f;
  return ok ? y : 0.f;
}

// One filter of a lane: CN sections of the same biquad, states in registers.
template <int CN>
struct Filter {
  Biquad c;
  float z[CN][2];

  __device__ __forceinline__ void load(const float* coeffs, const float* state, int f, int L, int l,
                                       bool valid) {
    c = load_biquad(coeffs, f);
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        z[j][q] = valid ? state[((long long)(f * CN + j) * 2 + q) * L + l] : 0.f;
  }

  __device__ __forceinline__ void store(float* state_out, int f, int L, int l) const {
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) state_out[((long long)(f * CN + j) * 2 + q) * L + l] = z[j][q];
  }

  __device__ __forceinline__ float operator()(float v) {
#pragma unroll
    for (int j = 0; j < CN; ++j) v = biquad(c, v, z[j][0], z[j][1]);
    return v;
  }
};

// Warp 0: input chunks in ahead of the chain, finished bands out.
__device__ __forceinline__ void mover(Smem& sm, const float* __restrict__ x, float* __restrict__ bands,
                                      int T, int L, int l, bool valid, int lane) {
  const int chunks = (T + CHUNK - 1) / CHUNK;
  Ring<IN_STAGES> load_at;
  auto load = [&](int c) {
    const int n = min(CHUNK, T - c * CHUNK);
    if (valid) {
      const float* src = x + (long long)c * CHUNK * L + l;
      float* dst = &sm.in[load_at.slot][0][lane];
      for (int t = 0; t < n; ++t) cp_async4(dst + t * LANES, src + (long long)t * L);
    }
    cp_async_arrive(&sm.in_full[load_at.slot]);
    load_at.next();
  };
  for (int c = 0; c < min(IN_STAGES, chunks); ++c) load(c);
  Ring<OUT_STAGES> o;
  for (int c = 0; c < chunks; ++c) {
    bar_wait(&sm.done[o.slot], o.phase);  // chunk c read, its bands written
    if (c + IN_STAGES < chunks) load(c + IN_STAGES);  // into chunk c's input slot
    const int n = min(CHUNK, T - c * CHUNK);
    const float* src = &sm.out[o.slot][0][0][lane];
    float* dst = bands + (long long)c * CHUNK * 3 * L + l;  // row r = 3 t + band
    if (valid) {
      if (n == CHUNK) {
#pragma unroll
        for (int r = 0; r < 3 * CHUNK; ++r) dst[(long long)r * L] = src[r * LANES];
      } else {
        for (int r = 0; r < 3 * n; ++r) dst[(long long)r * L] = src[r * LANES];
      }
    }
    __syncwarp();
    bar_arrive(&sm.out_free[o.slot]);
    o.next();
  }
}

// One chunk of a chain warp: step(t, load(t)) for its samples in order.  A
// whole chunk reads all its inputs into registers first: its stores could
// alias them, so a load left beside its use would wait on every store
// before it.
template <class Load, class Step>
__device__ __forceinline__ void run_chunk(FullChunk, Load load, Step step) {
  decltype(load(0)) v[CHUNK];
#pragma unroll
  for (int t = 0; t < CHUNK; ++t) v[t] = load(t);
#pragma unroll
  for (int t = 0; t < CHUNK; ++t) step(t, v[t]);
}

template <class Load, class Step>
__device__ __forceinline__ void run_chunk(int n, Load load, Step step) {
  for (int t = 0; t < n; ++t) step(t, load(t));
}

// Warp 1: low = LP_lo(x) into the bands, al = HP_lo(x) to warp 2.
template <int CN>
__device__ __forceinline__ void low_stage(Smem& sm, Filter<CN>& lp, Filter<CN>& hp, int T, int lane) {
  Ring<IN_STAGES> in;
  Ring<AL_STAGES> a;
  Ring<OUT_STAGES> o;
  auto chunk = [&](auto n) {
    bar_wait(&sm.in_full[in.slot], in.phase);
    bar_wait(&sm.al_free[a.slot], a.phase ^ 1);
    bar_wait(&sm.out_free[o.slot], o.phase ^ 1);
    const float* xs = &sm.in[in.slot][0][lane];
    float* als = &sm.al[a.slot][0][lane];
    float* outs = &sm.out[o.slot][0][0][lane];
    run_chunk(
        n, [&](int t) { return xs[t * LANES]; },
        [&](int t, float xt) {
          outs[3 * t * LANES] = lp(xt);
          als[t * LANES] = hp(xt);
        });
    bar_arrive(&sm.al_full[a.slot]);
    bar_arrive(&sm.done[o.slot]);
    in.next();
    a.next();
    o.next();
  };
  const int full = T / CHUNK;
  for (int c = 0; c < full; ++c) chunk(FullChunk{});
  if (full * CHUNK < T) chunk(T - full * CHUNK);
}

// Warp 2: mid = LP_hi(al), high = HP_hi(kHighFromAl ? al : x) into the bands.
template <int CN, bool kHighFromAl>
__device__ __forceinline__ void high_stage(Smem& sm, Filter<CN>& lp, Filter<CN>& hp, int T, int lane) {
  Ring<IN_STAGES> in;
  Ring<AL_STAGES> a;
  Ring<OUT_STAGES> o;
  auto chunk = [&](auto n) {
    bar_wait(&sm.al_full[a.slot], a.phase);
    if (!kHighFromAl) bar_wait(&sm.in_full[in.slot], in.phase);
    bar_wait(&sm.out_free[o.slot], o.phase ^ 1);
    const float* xs = &sm.in[in.slot][0][lane];
    const float* als = &sm.al[a.slot][0][lane];
    float* outs = &sm.out[o.slot][0][1][lane];
    run_chunk(
        n,
        [&](int t) {  // (al, HP_hi's input)
          const float al = als[t * LANES];
          return make_float2(al, kHighFromAl ? al : xs[t * LANES]);
        },
        [&](int t, float2 v) {
          outs[3 * t * LANES] = lp(v.x);
          outs[(3 * t + 1) * LANES] = hp(v.y);
        });
    bar_arrive(&sm.al_free[a.slot]);
    bar_arrive(&sm.done[o.slot]);
    in.next();
    a.next();
    o.next();
  };
  const int full = T / CHUNK;
  for (int c = 0; c < full; ++c) chunk(FullChunk{});
  if (full * CHUNK < T) chunk(T - full * CHUNK);
}

template <int CN, bool kHighFromAl>
__global__ void __launch_bounds__(THREADS) three_band_kernel(
    const float* __restrict__ x, const float* __restrict__ state,
    const float* __restrict__ coeffs, float* __restrict__ bands,
    float* __restrict__ state_out, int T, int L) {
  __shared__ Smem sm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = blockIdx.x * LANES + lane;
  const bool valid = l < L;
  if (threadIdx.x == 0) {
    for (int s = 0; s < IN_STAGES; ++s) bar_init(&sm.in_full[s], 32);
    for (int s = 0; s < AL_STAGES; ++s) {
      bar_init(&sm.al_full[s], 32);
      bar_init(&sm.al_free[s], 32);
    }
    for (int s = 0; s < OUT_STAGES; ++s) {
      bar_init(&sm.done[s], 64);
      bar_init(&sm.out_free[s], 32);
    }
  }
  __syncthreads();
  if (warp == 0) {
    mover(sm, x, bands, T, L, l, valid, lane);
    return;
  }
  // warp 1 holds LP_lo and HP_lo (filters 0, 1), warp 2 LP_hi and HP_hi (2, 3)
  const int f0 = 2 * (warp - 1);
  Filter<CN> lp, hp;
  lp.load(coeffs, state, f0, L, l, valid);
  hp.load(coeffs, state, f0 + 1, L, l, valid);
  if (warp == 1)
    low_stage<CN>(sm, lp, hp, T, lane);
  else
    high_stage<CN, kHighFromAl>(sm, lp, hp, T, lane);
  if (valid) {
    lp.store(state_out, f0, L, l);
    hp.store(state_out, f0 + 1, L, l);
  }
}

template <int CN, bool kHighFromAl>
int launch(const float* x, const float* state, const float* coeffs,
           float* bands, float* state_out, int T, int L, cudaStream_t stream) {
  three_band_kernel<CN, kHighFromAl>
      <<<(L + LANES - 1) / LANES, THREADS, 0, stream>>>(x, state, coeffs, bands, state_out, T, L);
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
