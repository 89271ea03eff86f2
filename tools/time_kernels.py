"""Time hand-written kernels of the port alone at the main path's shapes, for
this checkout or for other trees of the package (a parent commit, a variant
of the kernels) in the same run.

    python tools/time_kernels.py KERNEL ... [--root DIR ...]

KERNEL names a set; random states, frames and deltas are made on the card
from a seed, S=8192 streams or frames:

- ``b1a``: ``sliding_hop``, 2048/64 Hann, 4 columns (mean of 20 launches);
- ``b2``: ``reassigned_sliding_hop``, 2048/64 Hann, 4 columns (10);
- ``b3``: ``reassigned_columns``, frames of n 8192 (h 16384) (5), and the
  largest time-correction difference from the float64 plain version at
  bins within 60 dB of their column's peak, in hops (1024 frames);
- ``b1b``: the sliding path of a steady B1b hop at 16384/512 (one column,
  power) and 16384/128 (two columns, codes) (20 each), and the largest
  state difference from the plain version over its row's largest bin.
  Where ``sliding_hop_spectra`` takes the sample deltas the path is the
  kernel alone; in a tree from before that (no ``block_fits``) it is the
  deltas' ``torch.fft.rfft`` and the kernel, whose time alone is printed
  beside it.

Each ``--root`` is a directory holding an ``openmeters_tpu_torch`` package
(default: this checkout), imported in a fresh interpreter, which builds its
kernels into that tree's ``build/``.  Prints the card's name and power
limit, then one line per root and set, times by CUDA events.  Needs a CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETS = ("b1a", "b2", "b3", "b1b")

CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
from openmeters_tpu_torch.ops import sliding_hop as thop
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT
from openmeters_tpu_torch.utils.windows import WindowKind

dev = torch.device("cuda")
S = 8192


def tcuda(fn, reps):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def b1a(g):
    sl = SlidingSTFT(2048, 64, 256, WindowKind.HANN)
    fr = torch.randn((S, sl.bins), generator=g, device=dev); fi = torch.randn_like(fr)
    deltas = torch.randn((S, 4, 64), generator=g, device=dev)
    rr, ri, dc = sl._rows(dev); ur, ui = sl._updates(dev); norm = torch.ones(sl.bins, device=dev)
    kw = dict(n=2048, coeffs=(0.5, -0.5), floor_db=-120.0, tiles=sl._tiles(dev))
    ms = tcuda(lambda: thop.sliding_hop(4, fr, fi, deltas, ur, ui, rr, ri, dc, norm, **kw), 20)
    return f"B1a {ms:.4f} ms"


def b2(g):
    from openmeters_tpu_torch.ops import reassigned_hop as rhop
    from openmeters_tpu_torch.ops.sliding_reassigned import SlidingReassigned

    rs = SlidingReassigned(2048, 64, 256, WindowKind.HANN, 48000.0)
    t = rs._tensors(dev)
    st = tuple(torch.randn((S, rs.bins), generator=g, device=dev) for _ in range(8))
    dx = torch.randn((S, 4, 128), generator=g, device=dev); dh = torch.randn_like(dx)
    kw = dict(n=2048, zpf=1, coeffs=(0.5, -0.5), inv_2pi=1.0, inv_hop=1 / 64, latency_hops=16.0,
              tiles=t["tiles"])
    args = (st, dx, dh, t["upd"], t["rot_r"], t["rot_i"], t["normq"], t["freqb"])
    ms = tcuda(lambda: rhop.reassigned_sliding_hop(4, *args, **kw), 10)
    return f"B2 {ms:.4f} ms"


def b3(g):
    from openmeters_tpu_torch.ops import reassigned_columns as rcols

    t = torch.arange(16384, device=dev, dtype=torch.float32)
    f0 = torch.rand((S, 1), generator=g, device=dev) * 0.4 + 0.01
    frames = (torch.sin(6.283185307 * f0 * t) + 1e-3 * torch.randn((S, 16384), generator=g, device=dev))
    frames = frames.contiguous()
    kw = dict(n=8192, h=16384, coeffs=(0.5, -0.5), sample_rate=48000.0, hop=512)
    ms = tcuda(lambda: rcols.reassigned_columns(frames, **kw), 5)
    _, kt, _ = rcols.reassigned_columns(frames[:1024], **kw)
    _, rt, rp = rcols.reassigned_columns_reference(frames[:1024], **kw)
    held = rp >= rp.amax(dim=-1, keepdim=True) * 1e-6
    return f"B3 {ms:.4f} ms (time {float(((kt - rt).abs() * held).max()):.3e} hop)"


def b1b(g):
    takes_deltas = hasattr(thop, "block_fits")
    out = []
    for n, hop, cols, codes in ((16384, 512, 1, False), (16384, 128, 2, True)):
        sl = SlidingSTFT(n, hop, 512, WindowKind.HANN)
        fr = torch.randn((S, sl.bins), generator=g, device=dev); fi = torch.randn_like(fr)
        deltas = torch.randn((S, cols, hop), generator=g, device=dev)
        rr, ri, dc = sl._rows(dev); norm = torch.ones(sl.bins, device=dev)
        kw = dict(n=n, coeffs=(0.5, -0.5), floor_db=-120.0, emit_codes=codes)
        rows = (rr, ri, dc, norm)
        if takes_deltas:
            path = lambda: thop.sliding_hop_spectra(cols, fr, fi, deltas, *rows, **kw)
            ref = thop.sliding_hop_spectra_reference(cols, fr, fi, deltas, *rows, **kw)
            alone = ""
        else:
            dspec = torch.fft.rfft(deltas, n=n)
            path = lambda: thop.sliding_hop_spectra(cols, fr, fi, torch.fft.rfft(deltas, n=n), *rows, **kw)
            ref = thop.sliding_hop_spectra_reference(cols, fr, fi, dspec, *rows, **kw)
            ms = tcuda(lambda: thop.sliding_hop_spectra(cols, fr, fi, dspec, *rows, **kw), 20)
            alone = f", kernel alone {ms:.4f} ms"
        ms = tcuda(path, 20)
        kr, ki, _ = path()
        pr, pi, _ = ref
        scale = torch.hypot(pr, pi).amax(dim=1, keepdim=True)
        err = float((torch.maximum((kr - pr).abs(), (ki - pi).abs()) / scale).max())
        out.append(f"B1b {n}/{hop} path {ms:.4f} ms{alone} (state {err:.3e})")
        del fr, fi, deltas, kr, ki, pr, pi, ref
        torch.cuda.empty_cache()
    return "  ".join(out)


for name in sys.argv[2:]:
    print(globals()[name](torch.Generator(device=dev).manual_seed(1)), flush=True)
"""


def time_root(root: str, kernels: list[str]) -> str:
    """Run the sets in a fresh interpreter that imports the package under
    ``root``."""
    res = subprocess.run([sys.executable, "-c", CHILD, root, *kernels], capture_output=True, text=True)
    if res.returncode != 0:
        return f"{root}: failed\n{res.stdout}{res.stderr[-3000:]}"
    return "\n".join(f"{root}: {line}" for line in res.stdout.splitlines())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="+", choices=SETS)
    ap.add_argument("--root", action="append", help="a tree holding openmeters_tpu_torch (repeatable)")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    failed = False
    for root in args.root or [str(ROOT)]:
        line = time_root(root, args.kernels)
        failed |= line.endswith("failed") or "failed\n" in line
        print(line, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
