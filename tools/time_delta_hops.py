"""Time the two sliding hops whose delta products run on the tensor cores,
B1a (``sliding_hop``) and B2 (``reassigned_sliding_hop``), alone at the
main path's shape: S=8192 streams, 2048/64 Hann, 4 columns, random states
and deltas made on the card from a seed.

    python tools/time_delta_hops.py [PACKAGE_ROOT ...]

Each argument is a directory holding an ``openmeters_tpu_torch`` package
(default: this checkout), so that a variant of the kernels unpacked beside
the tree is timed in the same process run as the tree's own; each builds
its kernels into its own ``build/``.  Prints the card's name and power
limit, then one line per package: the mean of 20 launches of B1a and 10 of
B2 by CUDA events.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_package(root: str) -> str:
    """Import the package under ``root`` in a fresh interpreter and time
    both kernels there."""
    code = f"""
import sys
sys.path.insert(0, {root!r})
import torch
from openmeters_tpu_torch.ops import reassigned_hop as rhop, sliding_hop as thop
from openmeters_tpu_torch.ops.sliding_reassigned import SlidingReassigned
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT
from openmeters_tpu_torch.utils.windows import WindowKind

dev = torch.device("cuda")

def tcuda(fn, reps):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

g = torch.Generator(device=dev).manual_seed(1)
S = 8192
sl = SlidingSTFT(2048, 64, 256, WindowKind.HANN)
fr = torch.randn((S, sl.bins), generator=g, device=dev); fi = torch.randn_like(fr)
deltas = torch.randn((S, 4, 64), generator=g, device=dev)
rr, ri, dc = sl._rows(dev); ur, ui = sl._updates(dev); norm = torch.ones(sl.bins, device=dev)
kw = dict(n=2048, coeffs=(0.5, -0.5), floor_db=-120.0, tiles=sl._tiles(dev))
b1a = tcuda(lambda: thop.sliding_hop(4, fr, fi, deltas, ur, ui, rr, ri, dc, norm, **kw), 20)
rs = SlidingReassigned(2048, 64, 256, WindowKind.HANN, 48000.0)
t = rs._tensors(dev)
st = tuple(torch.randn((S, rs.bins), generator=g, device=dev) for _ in range(8))
dx = torch.randn((S, 4, 128), generator=g, device=dev); dh = torch.randn_like(dx)
rkw = dict(n=2048, zpf=1, coeffs=(0.5, -0.5), inv_2pi=1.0, inv_hop=1 / 64, latency_hops=16.0,
           tiles=t["tiles"])
args = (st, dx, dh, t["upd"], t["rot_r"], t["rot_i"], t["normq"], t["freqb"])
b2 = tcuda(lambda: rhop.reassigned_sliding_hop(4, *args, **rkw), 10)
print(f"{{b1a:.4f}} {{b2:.4f}}")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    b1a, b2 = out.stdout.split()[-2:]
    return f"{root}: B1a {b1a} ms  B2 {b2} ms"


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    for root in sys.argv[1:] or [str(ROOT)]:
        print(time_package(root), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
