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
  beside it;
- ``b4``: ``corr_dots_sums_ring`` from a ``[8192, 19456]`` ring (template
  4800, window 7200, nfft 8192, 2401 offsets) (10), and at 192 kHz, S=2048
  (ring 77312, template 19200, window 28800, nfft 32768, 9601 offsets)
  (3), each with the dots' largest difference from the plain version over
  their peak;
- ``b6``: ``corr_dots`` on the same windows as rows, S=8192 (10), the same;
- ``three_band``: the crossover ``three_band_scan`` at the blocks of 48,
  44.1, 96 and 192 kHz (``[256, 8192, 2]``, ``[235, 8192, 2]``, ``[512,
  4096, 2]``, ``[1024, 2048, 2]``), both cascade settings, as a CUDA graph
  of 200 launches replayed once (the wrapper's Python is longer than the
  kernel), each checked bit-exact against its plain version; then, from
  each tree's built library, the instructions a sample that the kernel's
  SASS issues on each warp that runs a lane's filters, and the serial
  chain's floor at each shape at the card's highest SM clock.  Shapes,
  graph timing, SASS reader and floor are ``chip_smoke.py``'s (phase 15),
  taken from this checkout.

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
SETS = ("b1a", "b2", "b3", "b1b", "b4", "b6", "three_band")

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


def search_inputs(g, s, lanes, kcap):
    ring = torch.randn((s, lanes), generator=g, device=dev) * 0.3
    starts = torch.randint(0, lanes // 2, (s,), generator=g, device=dev, dtype=torch.int32)
    klen = torch.randint(2 * kcap // 5, kcap + 1, (s,), generator=g, device=dev, dtype=torch.int32)
    off = (kcap - klen) // 2
    kidx = torch.arange(kcap, device=dev, dtype=torch.int32)
    kmask = (kidx[None, :] >= off[:, None]) & (kidx[None, :] < (off + klen)[:, None])
    tmpl = torch.where(kmask, torch.randn((s, kcap), generator=g, device=dev), 0.0)
    search = (torch.rand((s,), generator=g, device=dev) * (klen // 2).float()).to(torch.int32) + 1
    return ring, starts, tmpl, klen, search + klen, (-off).contiguous()


def dots_gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def b4(g):
    from openmeters_tpu_torch.ops import corr

    out = []
    for s, lanes, kcap, wcap, nfft, n_out, reps in ((S, 19456, 4800, 7200, 8192, 2401, 10),
                                                     (2048, 77312, 19200, 28800, 32768, 9601, 3)):
        args = (*search_inputs(g, s, lanes, kcap), nfft, n_out, wcap)
        ms = tcuda(lambda: corr.corr_dots_sums_ring(*args), reps)
        err = dots_gap(corr.corr_dots_sums_ring(*args)[0], corr.corr_dots_sums_ring_reference(*args)[0])
        out.append(f"B4 S={s} nfft {nfft} {ms:.4f} ms (dots {err:.3e})")
        del args
        torch.cuda.empty_cache()
    return "  ".join(out)


def b6(g):
    from openmeters_tpu_torch.ops import corr
    from openmeters_tpu_torch.ops.rows import window_rows_reference

    ring, starts, tmpl, _, _, shift = search_inputs(g, S, 19456, 4800)
    work = window_rows_reference(ring, starts.long(), 7200).contiguous()
    ms = tcuda(lambda: corr.corr_dots(work, tmpl, shift, 8192, 2401), 10)
    err = dots_gap(corr.corr_dots(work, tmpl, shift, 8192, 2401),
                   corr.corr_dots_reference(work, tmpl, shift, 8192, 2401))
    return f"B6 {ms:.4f} ms (dots {err:.3e})"


def three_band(g):
    import importlib.util

    from openmeters_tpu_torch.ops import iir
    from openmeters_tpu_torch.ops._build import library_path

    # this checkout's chip_smoke.py by its path: the tree under test may hold another
    spec = importlib.util.spec_from_file_location("chip_smoke", %(smoke)r)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = []
    for t, s, rate in smoke.THREE_BAND_SHAPES:
        x = torch.randn((t, s, 2), generator=g, device=dev) * 0.3
        x[15, 1, 0], x[16, 2, 1], x[t - 1, s - 1, 1] = float("nan"), float("inf"), float("-inf")
        for cn, high in ((1, False), (2, True)):
            state = torch.randn((4, cn, 2, s, 2), generator=g, device=dev) * 0.1
            kw = dict(cascade_n=cn, cascade_high=high)
            ms = smoke.time_graph(lambda: iir.three_band_scan(x, state, rate, **kw), 200)
            got = iir.three_band_scan(x, state, rate, **kw)
            ref = iir.three_band_scan_reference(x, state, rate, **kw)
            exact = all(torch.equal(a, b) for a, b in zip(got, ref))
            out.append(f"three_band [{t}, {s}, 2] cascade {cn} {ms:.4f} ms ({'bit-exact' if exact else 'DIFFERS'})")
        del x, state
        torch.cuda.empty_cache()
    return "\n".join(out) + f"\nthree_band library {library_path()}"


for name in sys.argv[2:]:
    print(globals()[name](torch.Generator(device=dev).manual_seed(1)), flush=True)
""" % {"smoke": str(ROOT / "chip_smoke.py")}


def three_band_floors(lib: str) -> list[str]:
    """The SASS issue count of each instance of the crossover kernel in the
    library ``lib`` and its chain floor at each shape, by this checkout's
    reader."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import THREE_BAND_SHAPES, max_sm_clock_mhz, three_band_chain_floor_ms, three_band_issue

    clock = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for (cn, high), per_sample in sorted(three_band_issue(lib).items()):
        floors = ", ".join(f"[{t}, {s}, 2] {three_band_chain_floor_ms(t, 2 * s, per_sample, clock, sms):.4f}"
                           for t, s, _ in THREE_BAND_SHAPES)
        out.append(f"three_band<{cn}, {str(high).lower()}> {len(per_sample)} chain warps, "
                   f"{', '.join(f'{n:.1f}' for n in per_sample)} instructions a sample; "
                   f"chain floor ms at {clock:.0f} MHz: {floors}")
    return out


def time_root(root: str, kernels: list[str]) -> str:
    """Run the sets in a fresh interpreter that imports the package under
    ``root``."""
    res = subprocess.run([sys.executable, "-c", CHILD, root, *kernels], capture_output=True, text=True)
    if res.returncode != 0:
        return f"{root}: failed\n{res.stdout}{res.stderr[-3000:]}"
    lines = res.stdout.splitlines()
    for line in list(lines):
        if line.startswith("three_band library "):
            lines += three_band_floors(line.split(" ", 2)[2])
    return "\n".join(f"{root}: {line}" for line in lines)


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
