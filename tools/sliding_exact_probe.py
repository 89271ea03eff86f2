"""How far the port's sliding spectrogram sits from the exact transform, on
the programme audio of ``chip_smoke.py`` phase 24b (tones, noise, both;
levels stepping every 1.6 s, some sections at -85 to -78 dBFS).

    python tools/sliding_exact_probe.py [--streams 12] [--hops 1200] [--device cpu]

Two readings, both by ``chip_smoke.py``'s helpers:

- ``drift``: the flagship (classic 2048/64, each column from its own frame,
  so no state carries rounding from hop to hop) and the reassigned default
  (2048/64, sliding) stepped free-running; on each hop before a re-anchor
  of the sliding path the last column against its exact float64 recompute
  from the rings
  (``exact_errors``), per stream, with the stream's kind and the hops since
  its section's level changed.  Prints each stream and hop that breaks a
  bar of ``exact_bars()`` (codes; frequency, power, time within the
  window, time at the peak).
- ``one_hop``: the reassigned default; every third hop the hop's f32 plain
  version and its float64 plain version (the port's CPU path) from the
  same state, compared by ``reassigned_errors`` with the drift bars, over
  all held bins and over those whose time lies within the window.

On the CPU the reassigned path is the port's float64 plain hop; with
``--device cuda`` the card's kernels.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from openmeters_tpu_torch.engine import MeterEngine, StreamMeta  # noqa: E402
from openmeters_tpu_torch.utils.parity import reassigned_errors  # noqa: E402


def drift(streams: int, hops: int, device: str) -> None:
    for label, cfg in (("flagship", cs.flagship_config()), ("reassigned", cs.reassigned_config())):
        engine = MeterEngine(cfg)
        meta = StreamMeta(*(x.to(device) for x in StreamMeta.default(streams, channels=2, pad_channels=2)))
        prog = cs.CardProgramme(streams, hops, device, kept=1)
        level = 20 * np.log10(prog.gain.cpu().numpy())
        bars = cs.exact_bars()
        carry = engine.init(streams, device=device)
        broken = 0
        for h in range(hops):
            carry, snaps = engine.step(carry, prog.block(h), meta)
            if (h + 1) % 32 or h < 64:
                continue
            for i in range(streams):
                one = {k: type(v)(*(x[i:i + 1] for x in v)) for k, v in snaps.items()}
                err = cs.exact_errors(engine, {"spectrogram": _stream(carry["spectrogram"], i)}, one)
                over = {k: err[k] for k in bars if k in err and err[k] > bars[k]}
                if over:
                    broken += 1
                    j = h // cs.LONG_SECTION
                    step = level[i, j] - level[i, j - 1] if j else 0.0
                    print(f"{label} hop {h} stream {i} (kind {i % 3}): {over}; {h - j * cs.LONG_SECTION} hops "
                          f"after a level change of {step:+.1f} dB (to {level[i, j]:.1f} dBFS)")
        print(f"{label}: {broken} stream-hops off a bar, of {streams * (hops // 32 - 2)}")


def _stream(carry, i: int):
    """Stream ``i`` of a spectrogram carry (its tensors lead with the
    stream dim; its host scalars are shared)."""
    if isinstance(carry, dict):
        return {k: _stream(v, i) for k, v in carry.items()}
    if isinstance(carry, torch.Tensor) and carry.dim() >= 1:
        return carry[i:i + 1]
    return carry


def one_hop(streams: int, hops: int, device: str) -> None:
    engine = MeterEngine(cs.reassigned_config())
    meta = StreamMeta(*(x.to(device) for x in StreamMeta.default(streams, channels=2, pad_channels=2)))
    prog = cs.CardProgramme(streams, hops, device, kept=1)
    carry = engine.init(streams, device=device)
    worst = {"all": 0.0, "inside": 0.0}
    for h in range(hops):
        blk = prog.block(h)
        if h < 64 or h % 3:
            carry, _ = engine.step(carry, blk, meta)
            continue
        with cs.f32_plain_hop():
            _, plain = engine.step(cs._carry_to(carry, device), blk, meta)  # noqa: SLF001
        carry, snaps = engine.step(carry, blk, meta)
        a, b = plain["spectrogram"], snaps["spectrogram"]
        ours, ref = (a.freq_hz, a.time_offset, a.power), (b.freq_hz, b.time_offset, b.power)
        every, _ = reassigned_errors(ours, ref, b.valid, drift=True)
        inside, _ = reassigned_errors(ours, ref, b.valid, drift=True, window_hops=32)
        worst = {"all": max(worst["all"], every["time_over_bar"]),
                 "inside": max(worst["inside"], inside["time_over_bar"])}
        if every["time_over_bar"] > 1.0:
            print(f"one hop at {h}: time {every['time_over_bar']:.2f} of the bar over all held bins, "
                  f"{inside['time_over_bar']:.2f} within the window ({inside['outside']} held bins outside it)")
    print(f"one hop, f32 plain against float64 from the same state: largest time error {worst['all']:.2f} of "
          f"the bar, {worst['inside']:.2f} within the window")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=12)
    ap.add_argument("--hops", type=int, default=1200)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reading", choices=("drift", "one_hop", "both"), default="both")
    args = ap.parse_args()
    if args.reading in ("drift", "both"):
        drift(args.streams, args.hops, args.device)
    if args.reading in ("one_hop", "both"):
        one_hop(args.streams, args.hops, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
