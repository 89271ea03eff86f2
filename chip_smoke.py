"""Drive the PyTorch port's flagship meter path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. the card: name and power limit; f32 matmuls in full precision;
2. build the CUDA kernel library from ``openmeters_tpu_torch/csrc`` (timed);
3. the ``sliding_hop`` kernel against its plain PyTorch version on the same
   card tensors, at the flagship shape and a small Blackman-Harris shape,
   for ready in {0, 1, cols}, plus both versions' times at the flagship
   shape;
4. the flagship engine through the public API on the card against the
   same on the CPU (S=32, 200 hops, two streams reset at hop 90);
5. the flagship engine at S=8192 stereo streams: 40 warm-up hops, then 200
   timed hops with every output consumed, counting kernel launches.

The flagship is ``EngineConfig(spectrogram=SpectrogramConfig(2048, 64,
use_reassignment=False), spectrum=None, oscilloscope=None,
stereometer=None, waveform=None, channels=2)``: BS.1770 loudness plus the
classic 2048/64 Hann spectrogram.  Before the last line it prints one JSON
object with each kernel's launches, error and times, and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

OUT_DIR = Path("chiprun_out")
# Two f32 sliding-DFT implementations agree to 2 u16 codes (0.005 dB) at bins
# within this range of their column's peak; deeper bins sit below the f32
# state's resolution (rounding of ~1e-7 of the row's largest bin, summed
# over the 32 hops between exact re-anchors) and are reported, not held.
RESOLVED_DB = 60.0
SEED = 1234
FLAGSHIP_S = 8192
WARMUP_HOPS = 40
TIMED_HOPS = 200


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def flagship_config():
    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu_torch.engine import EngineConfig

    return EngineConfig(
        spectrogram=SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False),
        spectrum=None, oscilloscope=None, stereometer=None, waveform=None,
        channels=2,
    )


def resolved_bins(codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Valid bins within ``RESOLVED_DB`` of their column's peak."""
    peak = codes.amax(dim=-1, keepdim=True)
    return valid[..., None] & (codes >= peak - round(RESOLVED_DB * 65535 / 156))


def time_cuda(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def hop_inputs(sl, s: int, ready_cols: int, gen: torch.Generator, dev):
    """State and deltas as the engine would hand them to the hop: the
    spectrum of a random frame and the deltas of fresh random samples."""
    n, h = sl.fft_size, sl.hop
    x = torch.randn((s, n + ready_cols * h), generator=gen, device=dev) * 0.1
    spec = torch.fft.rfft(x[:, :n], n=n)
    fr, fi = spec.real.contiguous(), spec.imag.contiguous()
    deltas = torch.stack(
        [x[:, n + k * h : n + (k + 1) * h] - x[:, k * h : (k + 1) * h] for k in range(ready_cols)],
        dim=1,
    ).contiguous()
    return fr, fi, deltas


def phase3_kernel(dev) -> dict:
    from openmeters_tpu_torch.ops.sliding_hop import sliding_hop, sliding_hop_reference
    from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT
    from openmeters_tpu_torch.utils.level import DB_FLOOR
    from openmeters_tpu_torch.utils.windows import WindowKind, fft_bin_normalization, window_coefficients

    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [
        ("flagship", SlidingSTFT(2048, 64, 256, WindowKind.HANN), FLAGSHIP_S),
        ("blackman-harris", SlidingSTFT(256, 32, 256, WindowKind.BLACKMAN_HARRIS), 37),
    ]
    result = {}
    for label, sl, s in shapes:
        cols = sl.frames.cols_cap
        rot_r, rot_i, upd_r, upd_i, dc = sl._tensors(dev)
        norm = torch.from_numpy(
            fft_bin_normalization(window_coefficients(sl.window, sl.fft_size), sl.fft_size)
        ).to(dev)
        coeffs = tuple(float(a) for a in sl._stencil())
        fr, fi, deltas = hop_inputs(sl, s, cols, gen, dev)
        args = (fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm)
        kw = dict(n=sl.fft_size, coeffs=coeffs, floor_db=DB_FLOOR)
        for ready in sorted({0, 1, cols}):
            kr, ki, kc = sliding_hop(ready, *args, **kw)
            rr, ri, rc = sliding_hop_reference(ready, *args, **kw)
            torch.cuda.synchronize()
            scale = torch.clamp_min(torch.amax(torch.hypot(rr, ri), dim=1, keepdim=True), 1e-30)
            state_err = float(torch.amax(torch.maximum((kr - rr).abs(), (ki - ri).abs()) / scale))
            abs_err = float(torch.amax(torch.maximum((kr - rr).abs(), (ki - ri).abs())))
            ref = rc.to(torch.int32)
            d = (kc.to(torch.int32) - ref).abs()
            all_valid = torch.ones(ref.shape[:2], dtype=torch.bool, device=dev)
            code_diff = int((d * resolved_bins(ref, all_valid)).max())
            log(
                f"phase 3 {label} S={s} cols={cols} hop={sl.hop} bins={sl.bins} ready={ready}: "
                f"state max|d|/rowmax {state_err:.3e} (abs {abs_err:.3e}), codes max diff "
                f"{code_diff} within {RESOLVED_DB:g} dB of the column peak ({int(d.max())} over all bins)"
            )
            check(state_err <= 1e-5, f"{label} ready={ready}: state error {state_err}")
            check(code_diff <= 2, f"{label} ready={ready}: codes differ by {code_diff}")
            if label == "flagship" and ready == cols:
                result = {"max_abs_err": abs_err, "max_rel_state_err": state_err, "max_code_diff": code_diff}

        if label == "flagship":
            # plain, kernel, kernel, plain on the same card within this run
            reps = 20
            kern = lambda: sliding_hop(cols, *args, **kw)  # noqa: E731
            plain = lambda: sliding_hop_reference(cols, *args, **kw)  # noqa: E731
            p1, k1, k2, p2 = (time_cuda(f, reps) for f in (plain, kern, kern, plain))
            result["ms"] = (k1 + k2) / 2
            result["plain_ms"] = (p1 + p2) / 2
            log(
                f"phase 3 timing at S={s}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
                f"[{card_line()}]"
            )
    return result


def phase4_slice(dev) -> None:
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine

    s, hops, b = 32, 200, 256
    rng = np.random.default_rng(SEED)
    t = np.arange(hops * b) / 48_000.0
    freqs = rng.uniform(40.0, 8000.0, size=(s, 1, 1))
    audio = 0.3 * np.sin(2 * np.pi * freqs * t[None, :, None]) + 0.05 * rng.standard_normal((s, hops * b, 2))
    audio[3] *= 1e-3  # a quiet stream
    audio = audio.astype(np.float32)
    reset = np.zeros((s,), bool)
    reset[[5, 17]] = True

    engine = MeterEngine(flagship_config())
    sessions = {d: AnalysisSession(engine, s, d) for d in (dev, "cpu")}
    worst = {"codes": 0, "codes_all": 0, "lufs": 0.0, "true_peak": 0.0}
    deep = total = 0
    for i in range(hops):
        blk = audio[:, i * b : (i + 1) * b]
        snaps = {d: sess.feed(blk, reset if i == 90 else None) for d, sess in sessions.items()}
        ga, ca = snaps[dev], snaps["cpu"]
        va, vc = ga["spectrogram"].valid.cpu(), ca["spectrogram"].valid
        check(bool(torch.equal(va, vc)), f"hop {i}: valid masks differ")
        ref = ca["spectrogram"].codes.to(torch.int32)
        d = (ga["spectrogram"].codes.cpu().to(torch.int32) - ref).abs() * vc[..., None]
        held = resolved_bins(ref, vc)
        worst["codes"] = max(worst["codes"], int((d * held).max()))
        worst["codes_all"] = max(worst["codes_all"], int(d.max()))
        deep += int((vc[..., None] & ~held).sum())
        total += int(vc.sum()) * ref.shape[-1]
        la, lc = ga["loudness"], ca["loudness"]
        for f in la._fields:
            e = float((getattr(la, f).cpu() - getattr(lc, f)).abs().max())
            key = "true_peak" if f == "true_peak_db" else "lufs"
            worst[key] = max(worst[key], e)
    log(
        f"phase 4 card vs cpu, S={s}, {hops} hops, reset at hop 90: codes max diff {worst['codes']} "
        f"within {RESOLVED_DB:g} dB of the column peak ({worst['codes_all']} over all valid bins; "
        f"{deep / max(total, 1):.2e} of valid bins deeper), "
        f"loudness max |d| {worst['lufs']:.3e} LU/dB, true peak max |d| {worst['true_peak']:.3e} dB"
    )
    check(worst["codes"] <= 2, f"codes differ by {worst['codes']}")
    check(worst["lufs"] <= 0.01, f"loudness differs by {worst['lufs']}")
    check(worst["true_peak"] <= 1e-3, f"true peak differs by {worst['true_peak']}")


def phase5_flagship(dev) -> int:
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine
    from openmeters_tpu_torch.ops.sliding_hop import sliding_hop

    s, b = FLAGSHIP_S, 256
    engine = MeterEngine(flagship_config())
    torch.cuda.reset_peak_memory_stats()
    session = AnalysisSession(engine, s, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bank = 16  # distinct blocks made on the card, fed in turn
    t = torch.arange(bank * b, device=dev, dtype=torch.float32) / 48_000.0
    freqs = torch.rand((s, 1, 1), generator=gen, device=dev) * 4000.0 + 50.0
    audio = 0.3 * torch.sin(2 * torch.pi * freqs * t[None, :, None]) + 0.05 * torch.randn(
        (s, bank * b, 2), generator=gen, device=dev
    )
    blocks = [audio[:, i * b : (i + 1) * b].contiguous() for i in range(bank)]
    del audio

    sink = torch.zeros((), device=dev, dtype=torch.float64)

    def consume(snaps):
        # fold every output leaf into one device scalar: nothing is dropped
        nonlocal sink
        lo = snaps["loudness"]
        sg = snaps["spectrogram"]
        acc = sum(getattr(lo, f).sum(dtype=torch.float64) for f in lo._fields)
        acc = acc + sg.codes.sum(dtype=torch.float64) + sg.valid.sum(dtype=torch.float64)
        sink = sink + acc

    for i in range(WARMUP_HOPS):
        consume(session.feed(blocks[i % bank]))
    torch.cuda.synchronize()

    sliding_hop.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TIMED_HOPS):
        snaps = session.feed(blocks[(WARMUP_HOPS + i) % bank])
        consume(snaps)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sliding_hop.launches

    ms = start.elapsed_time(stop) / TIMED_HOPS
    realtime = s * (b / 48_000.0) / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated()
    card = card_line()
    log(
        f"phase 5 flagship S={s}: {ms:.4f} ms/hop (CUDA events; host wall {1e3 * wall / TIMED_HOPS:.4f} ms/hop), "
        f"{realtime:.1f} streams realtime, peak memory {peak / 2**30:.3f} GiB [{card}]"
    )
    check(launches == TIMED_HOPS, f"sliding_hop launched {launches} times in {TIMED_HOPS} hops")
    check(bool(torch.isfinite(sink)), "non-finite output")
    lo = snaps["loudness"]
    for f in lo._fields:
        check(bool(torch.isfinite(getattr(lo, f)).all()), f"{f} not finite")
    check(bool((lo.integrated_lufs > engine.config.loudness.floor_db).all()), "integrated loudness at the floor")
    check(bool(snaps["spectrogram"].valid.all()), "spectrogram columns not valid")

    try:
        profile_hops(session, blocks, consume, ms)
    except Exception as e:  # the profile is a diagnostic, not a phase
        log(f"phase 5 profile not taken: {type(e).__name__}: {e}")
    return launches


def profile_hops(session, blocks, consume, ms_per_hop: float, hops: int = 20) -> None:
    """Kernel time by name over a short steady window, into chiprun_out/,
    and the device's busy share: kernel time per hop over the unprofiled
    hop time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(hops):
            consume(session.feed(blocks[i % len(blocks)]))
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.txt").write_text(table)
    busy_us = sum(
        getattr(e, "device_time_total", 0.0)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy_ms = busy_us / 1e3 / hops
    log(
        f"phase 5 kernel time {busy_ms:.4f} ms/hop of {ms_per_hop:.4f} ms/hop: device busy "
        f"{100 * busy_ms / ms_per_hop:.1f} %, idle {100 * (1 - busy_ms / ms_per_hop):.1f} % [{card_line()}]"
    )
    log(f"phase 5 profile over {hops} hops (top rows; full table in chiprun_out/):")
    for line in table.splitlines()[:16]:
        log("  " + line)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    check(torch.get_float32_matmul_precision() == "highest", "f32 matmul precision is not highest")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    from openmeters_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"phase 2 kernel library built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas: " + line.strip())

    kernel = phase3_kernel(dev)
    phase4_slice(dev)
    launches = phase5_flagship(dev)

    print(json.dumps({
        "kernels": [{
            "name": "sliding_hop",
            "route": "cuda",
            "source": "openmeters_tpu_torch/csrc/sliding_hop.cu",
            "replaces": "openmeters_tpu/ops/pallas_sliding.py:381",
            "launches": launches,
            "max_abs_err": kernel["max_abs_err"],
            "ms": kernel["ms"],
            "plain_ms": kernel["plain_ms"],
        }],
    }))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
