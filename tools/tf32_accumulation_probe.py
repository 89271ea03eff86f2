"""How far 3xTF32 products on the tensor cores land from the exact product,
by how they are accumulated, against an f32 FMA chain.

    python tools/tf32_accumulation_probe.py     (on a CUDA card with nvcc)

One block computes D = A B^T, A [64, 128] and B [64, 128] f32 (K = 128,
the reassigned hop's 2 * hop at hop 64), with ``csrc/tf32_wgmma.cuh``'s
m64n64k8 products in four ways:

- ``chain``: hi/lo products of all of K summed in one accumulator;
- ``chunks``: each chunk of 16 summed from zero, the chunks added in f32
  (what ``sliding_hop_deltas.cu`` and ``reassigned_hop.cu`` do);
- ``1xtf32``: hi products only;
- ``fma``: an f32 FMA chain over K, in order (the CUDA-core kernels' and
  cuBLAS's way).

For three inputs (DFT rows; DFT rows under the reassigned hop's ramp
weights; Gaussian) it prints each way's error against the float64 product,
as a share of the largest |D| of its row: the largest and the root mean
square.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "tf32_wgmma.cuh"
using namespace tf32mma;
constexpr int M = 64, N = 64, K = 128, NK = K / KC;

template <int V>
__global__ void __launch_bounds__(128) probe(const float* A, const float* B, float* D) {
  extern __shared__ __align__(128) float sm[];
  float* ah = sm;
  float* al = ah + M * K;
  float* bh = al + M * K;
  float* bl = bh + N * K;
  const int t = threadIdx.x;
  for (int i = t; i < M * K; i += 128) {
    const int o = (i % K / KC) * M * KC + core_offset(i / K, i % KC);
    split(A[i], ah[o], al[o]);
  }
  for (int i = t; i < N * K; i += 128) {
    const int o = (i % K / KC) * N * KC + core_offset(i / K, i % KC);
    split(B[i], bh[o], bl[o]);
  }
  fence_proxy();
  __syncthreads();
  float d[32], e[32];
  for (int i = 0; i < 32; ++i) d[i] = e[i] = 0.f;
  for (int c = 0; c < NK; ++c) {
    const float *a0 = ah + c * M * KC, *a1 = al + c * M * KC;
    const float *b0 = bh + c * N * KC, *b1 = bl + c * N * KC;
    fence_operands(d);
    fence_operands(e);
    mma_begin();
    if (V == 0) {
      for (int j = 0; j < KC / 8; ++j) {
        mma_m64n64k8(d, desc(a1 + 64 * j), desc(b0 + 64 * j), 1);
        mma_m64n64k8(d, desc(a0 + 64 * j), desc(b1 + 64 * j), 1);
        mma_m64n64k8(d, desc(a0 + 64 * j), desc(b0 + 64 * j), 1);
      }
    } else if (V == 1) {
      mma_chunk(e, a0, a1, b0, b1);
    } else {
      for (int j = 0; j < KC / 8; ++j) mma_m64n64k8(d, desc(a0 + 64 * j), desc(b0 + 64 * j), 1);
    }
    mma_commit();
    mma_wait();
    fence_operands(d);
    fence_operands(e);
    if (V == 1)
      for (int i = 0; i < 32; ++i) d[i] += e[i];
  }
  __syncthreads();
  store_acc(d, sm, N, 0);
  __syncthreads();
  for (int i = t; i < M * N; i += 128) D[i] = sm[i];
}

__global__ void fma_chain(const float* A, const float* B, float* D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(A[i / N * K + k], B[i % N * K + k], s);
  D[i] = s;
}

template <int V>
int run(const float* A, const float* B, float* D) {
  const int smem = 4 * 2 * (M + N) * K;
  cudaFuncSetAttribute(probe<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe<V><<<1, 128, smem>>>(A, B, D);
  return (int)cudaDeviceSynchronize();
}

extern "C" int probe_launch(const float* A, const float* B, float* D, int way) {
  if (way == 0) return run<0>(A, B, D);
  if (way == 1) return run<1>(A, B, D);
  if (way == 2) return run<2>(A, B, D);
  fma_chain<<<M * N / 128, 128>>>(A, B, D);
  return (int)cudaDeviceSynchronize();
}
"""

WAYS = ("chain", "chunks", "1xtf32", "fma")


def main() -> int:
    from openmeters_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    out = _build.BUILD_DIR / "tf32_accumulation_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:5], "-shared", f"-I{_build.CSRC}",
                    "-o", str(out / "probe.so"), str(out / "probe.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "probe.so"))
    lib.probe_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]

    rng = np.random.default_rng(0)
    m, n, k = 64, 64, 128
    j = np.arange(k)[None, :]
    bins = np.arange(n)[:, None] * 16.0 + 3.0
    inputs = {
        "dft": np.cos(2 * np.pi * bins * j / 2048),
        "ramp-dft": (1023.5 + 64 - j) * np.cos(2 * np.pi * bins * j / 2048),
        "gaussian": rng.standard_normal((n, k)),
    }
    for label, b in inputs.items():
        a = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
        b = b.astype(np.float32)
        exact = a.astype(np.float64) @ b.astype(np.float64).T
        scale = np.abs(exact).max(axis=1, keepdims=True)
        da, db = torch.from_numpy(a).cuda(), torch.from_numpy(np.ascontiguousarray(b)).cuda()
        for way, name in enumerate(WAYS):
            d = torch.zeros((m, n), device="cuda")
            rc = lib.probe_launch(da.data_ptr(), db.data_ptr(), d.data_ptr(), way)
            if rc:
                raise RuntimeError(f"cudaError {rc}")
            err = np.abs(d.cpu().numpy().astype(np.float64) - exact) / scale
            print(f"{label:9s} {name:7s} max {err.max():.3e} rms {np.sqrt((err ** 2).mean()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
