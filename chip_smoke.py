"""Drive the PyTorch port's meter paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. the card: name and power limit; f32 matmuls in full precision;
2. build the CUDA kernel library from ``openmeters_tpu_torch/csrc`` (timed)
   and print each kernel's ptxas registers, shared memory and spills, then
   find the tensor-core instructions (``HGMMA`` for ``wgmma``, ``HMMA``
   for ``mma.sync``) in the SASS of the two kernels that run their delta
   products on the tensor cores, B1a and B2 (``cuobjdump -sass``);
3. the ``sliding_hop`` kernel against its plain PyTorch version on the same
   card tensors, at the flagship shape and a small Blackman-Harris shape,
   for ready in {0, 1, cols}, plus both versions' times at the flagship
   shape;
4. the flagship engine through the public API on the card against the
   same on the CPU (S=32, 200 hops, two streams reset at hop 90);
5. the flagship engine at S=8192 stereo streams: 40 warm-up hops, then 200
   timed hops with every output consumed, counting kernel launches, and a
   profile of 20 more;
6. the ``reassigned_sliding_hop`` kernel against its plain version at the
   default reassigned shape (S=8192, n 2048, hop 64, 4 columns, 1025 bins,
   Hann) and a small Blackman-Harris zero-padded shape (stencil reach 6),
   for ready in {0, 1, cols} -- the states against the f32 plain version,
   the corrections against the plain version in float64 and within 1.5
   times the f32 plain version's own distance from it -- plus both
   versions' times;
7. the ``reassigned_columns`` kernel against its plain version at n 8192
   (h 16384; 1024 frames, and the main path's 8192), n 2048 and n 512,
   plus both versions' times;
8. the reassigned slice on the card against the CPU: loudness plus the
   default reassigned 2048/64 spectrogram (S=32, 200 hops, two streams
   reset at hop 90), then the per-column 8192/512 config (S=8, 160 hops);
9. the reassigned slice at S=8192 stereo streams, timed and profiled as in
   phase 5; then the 8192/512 config at S=8192 (80 warm-up hops, its
   window first fills at hop 64), counting the per-column kernel's
   launches (one on each hop with a ready column, every second hop);
10. the correlation-search kernel against its plain versions at the
    oscilloscope's main-path shapes (S=8192, a ``[8192, 19456]`` ring,
    template 4800, window 7200, nfft 8192, 2401 offsets): from the ring
    (``corr_dots_sums_ring``), from given rows (``corr_dots_sums``) and
    dots alone (``corr_dots``), plus kernel, plain and library times; then
    from the ring at 192 kHz (S=2048, nfft 32768, its buffer in global
    scratch), plus kernel, plain and library times there too;
11. the ``window_rows`` kernel bit-exact against ``torch.gather`` at
    ``[8192, 19456]`` into 4800 and 4802 samples and three windows a row,
    plus the times;
12. the oscilloscope slice on the card against the CPU (S=8, 150 hops of
    tones, a glide, an onset and a quiet stream, two streams reset at hop
    90; bars in ``openmeters_tpu_torch/utils/parity.py``);
13. ``EngineConfig(spectrum=None, stereometer=None, waveform=None,
    channels=2)`` -- loudness, the reassigned spectrogram and the
    oscilloscope -- at S=8192 through ``AnalysisSession.feed``: 80 warm-up
    hops (the trigger's history first fills at hop 38), 200 timed with
    every output leaf folded into a device scalar, counting the search's
    launches (one a hop) and ``window_rows``'s (two a hop), and a profile;
14. the ``sliding_hop_spectra`` kernel (B1b: one block a stream's row,
    the delta spectra computed in it) against its plain version at S=8192,
    for every ``ready``: 16384/512 (one column, power), 16384/128 (two
    columns, power and codes), 4096/2048 Blackman-Harris; then
    ``sliding_hop``'s power output at 8192/128, and the bin-tiled route
    past one block's row (32768/1024: the deltas' rFFT and the tiled
    kernel); plus B1b's times at 16384/512, where the kernel alone is the
    whole sliding path of a steady hop, against the direct windowed rFFT;
15. the ``three_band`` crossover kernel against its plain per-sample loop
    at S=8192 x 2 lanes x 256 samples with NaN and infinite samples, both
    cascade settings (bit-exact), plus the times;
16. the spectrum slice on the card against the CPU through
    ``AnalysisSession.feed`` (S=4, 150 spectrum hops, a reset): 16384/512 at
    cadence 2 with each averaging mode, 16384/128 dual trace, the stock
    16384/1024 at cadence 4;
17. the stereometer (full band; LR4 bands with band points) and the
    waveform (bands; RMS history) on the card against the CPU (S=8, 150
    hops, a reset, NaN and infinite samples);
18. the literal ``EngineConfig()`` -- all six analyzers, 8 channels -- at
    S=8192 through ``AnalysisSession.feed``, timed and profiled as phase 13
    (18a; the stock spectrum at cadence 4 takes the direct rFFT), then the
    same with ``SpectrumConfig(hop_size=512)`` (18b; cadence 2, B1b on every
    second hop: 100 launches in 200); after each, the profiled device time
    of each analyzer alone (18b: the spectrum);
19. ``MeterServer`` on the card against one on the CPU (S=8, the literal
    ``EngineConfig()`` at 2 channels, ``fetch="full"``, 150 advances of
    pushed PCM with a glide and NaN samples): a generation reset on two
    streams at advance 40, an ``apply_settings_async`` (loudness floor,
    oscilloscope cadence, spectrum averaging) adopted at advance 60, a
    checkpoint at advance 100 restored by a fresh card server that runs on
    beside the uninterrupted one; meters, spectra and traces held by the
    bars of ``utils/parity.py``, the restored server against the
    uninterrupted one reported (bit-equal or its largest difference);
20. ``MeterServer`` at S=8192 stereo streams on the card, the C++ ``Feeder``
    pushing flat out: the literal ``EngineConfig()`` (20a), then the
    flagship (20b); 40 warm-up advances, 200 timed to the last drained
    fetch: ``report()``, host ms per advance by stage, the device's busy
    share from a profile, peak device memory, the transport's host bytes,
    and the launches of the path's kernels (each must launch).

The flagship is ``EngineConfig(spectrogram=SpectrogramConfig(2048, 64,
use_reassignment=False), spectrum=None, oscilloscope=None,
stereometer=None, waveform=None, channels=2)``: BS.1770 loudness plus the
classic 2048/64 Hann spectrogram.  The reassigned slice is the same with
the default ``SpectrogramConfig()`` (reassigned 2048/64 Hann).  Before the
last line it prints one JSON object with each kernel's launches on its
main path, error, times, least possible time (``bound_ms``: the larger of
its bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s, from this
run's inputs; for B1a and B2, whose products run on the tensor cores, the
larger of the bytes' time and 3xTF32's operations over 495 TFLOP/s, with
all three bounds beside it) and the time of the PyTorch call or chain
computing the same function (``library_ms``), then the card's
``nvidia-smi`` name and power limit; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
# the H100 SXM's published peaks: HBM bytes a second, f32 (non-tensor) FLOP a second
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, tensor cores


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fft_flops(n: int, count: int) -> float:
    """Operations of ``count`` complex ``n``-point FFTs, 5 n log2 n each."""
    return 5.0 * n * math.log2(n) * count


def bound(moved: float, flops: float, tensor_cores: bool = False) -> dict:
    """The least time the card could take: bytes moved over its memory
    rate, or operations over its f32 rate, whichever is larger.  With
    ``tensor_cores`` the operations are products run in 3xTF32 (three TF32
    products each): the bound is then the larger of the bytes' time and
    ``3 * flops`` over the TF32 rate, and all three bounds are kept."""
    by_bytes = moved / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    out = {}
    if tensor_cores:
        out = {"bound_f32_ms": by_ops, "bound_tf32_ms": 3 * flops / PEAK_TF32_FLOPS * 1e3,
               "bound_bytes_ms": by_bytes}
        by_ops = out["bound_tf32_ms"]
    if by_bytes >= by_ops:
        return {**out, "bound_ms": by_bytes, "bound_by": "bytes"}
    return {**out, "bound_ms": by_ops, "bound_by": "operations"}


def fmt_bound(k: dict) -> str:
    text = f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})"
    if "bound_tf32_ms" in k:
        text += (f" = max(bytes {k['bound_bytes_ms']:.4f}, 3xTF32 {k['bound_tf32_ms']:.4f}); "
                 f"f32 CUDA-core bound {k['bound_f32_ms']:.4f} ms")
    return text


# the kernels whose delta products run on the tensor cores, by symbol
TENSOR_CORE_KERNELS = ("sliding_hop_deltas_kernel", "reassigned_hop_kernel")


def tensor_core_sass(lib_path) -> dict:
    """``{kernel: tensor-core opcodes}`` from ``cuobjdump -sass`` of the
    built library, for each of ``TENSOR_CORE_KERNELS`` (every instance of a
    template); fails if one shows none."""
    from openmeters_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        for kernel in TENSOR_CORE_KERNELS:
            if kernel in name:
                ops = {w.split(".")[0] for w in part.split() if w.startswith(("HGMMA", "HMMA"))}
                check(bool(ops), f"{name}: no tensor-core instruction in its SASS")
                found.setdefault(kernel, set()).update(ops)
    check(set(found) == set(TENSOR_CORE_KERNELS), f"kernels not found in the SASS: {found}")
    return {k: sorted(v) for k, v in found.items()}


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
        rot_r, rot_i, dc = sl._rows(dev)
        upd_r, upd_i = sl._updates(dev)
        norm = torch.from_numpy(
            fft_bin_normalization(window_coefficients(sl.window, sl.fft_size), sl.fft_size)
        ).to(dev)
        coeffs = tuple(float(a) for a in sl._stencil())
        fr, fi, deltas = hop_inputs(sl, s, cols, gen, dev)
        args = (fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm)
        kw = dict(n=sl.fft_size, coeffs=coeffs, floor_db=DB_FLOOR)
        tiles = sl._tiles(dev)  # the kernel's staging of upd, kept as the engine keeps it
        for ready in sorted({0, 1, cols}):
            kr, ki, kc = sliding_hop(ready, *args, **kw, tiles=tiles)
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
            kern = lambda: sliding_hop(cols, *args, **kw, tiles=tiles)  # noqa: E731
            plain = lambda: sliding_hop_reference(cols, *args, **kw)  # noqa: E731
            p1, k1, k2, p2 = (time_cuda(f, reps) for f in (plain, kern, kern, plain))
            result["ms"] = (k1 + k2) / 2
            result["plain_ms"] = (p1 + p2) / 2
            # each delta sample times a complex update coefficient: 2 FMA a bin
            out = kern()
            result.update(bound(nbytes(*args, *out), 4.0 * s * cols * sl.hop * sl.bins, tensor_cores=True))
            # the library call: one rFFT of the hop's windowed frames
            frames = torch.randn((s, cols, sl.fft_size), generator=gen, device=dev)
            result["library_ms"] = time_cuda(lambda: torch.fft.rfft(frames), reps)  # noqa: B023
            del frames, out
            log(
                f"phase 3 timing at S={s}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                f"rfft of the windowed frames {result['library_ms']:.4f} ms, {fmt_bound(result)} "
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

    profile_hops("phase 5", session, blocks, consume, ms)
    return launches


def profiled(run_hop, hops: int):
    """``run_hop(i)`` for ``hops`` hops under the profiler.  Returns the
    device's kernel time per hop (ms): the device-side records alone (the
    table's CPU-side rows, "Command Buffer Full" among them, carry the time
    of the kernels under them again), and the table of time by name.  A
    profile that records no device time fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(hops):
            run_hop(i)
        torch.cuda.synchronize()
    busy_us = sum(
        getattr(e, "device_time_total", 0.0)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    check(busy_us > 0.0, "the profile recorded no device time")
    return busy_us / 1e3 / hops, prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)


def profile_hops(label: str, session, blocks, consume, ms_per_hop: float, hops: int = 20) -> None:
    """Kernel time by name over a short steady window, into ``OUT_DIR``,
    and the device's busy share: kernel time per hop over the unprofiled
    hop time."""
    busy_ms, table = profiled(lambda i: consume(session.feed(blocks[i % len(blocks)])), hops)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"chip_smoke_profile_{label.replace(' ', '')}.txt").write_text(table)
    log(
        f"{label} kernel time {busy_ms:.4f} ms/hop of {ms_per_hop:.4f} ms/hop: device busy "
        f"{100 * busy_ms / ms_per_hop:.1f} %, idle {100 * (1 - busy_ms / ms_per_hop):.1f} % [{card_line()}]"
    )
    log(f"{label} profile over {hops} hops (top rows; full table in chiprun_out/):")
    for line in table.splitlines()[:16]:
        log("  " + line)


# -- the reassigned spectrogram ---------------------------------------------


def reassigned_config(fft: int = 2048, hop: int = 64):
    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu_torch.engine import EngineConfig

    return EngineConfig(
        spectrogram=SpectrogramConfig(fft_size=fft, hop_size=hop),
        spectrum=None, oscilloscope=None, stereometer=None, waveform=None,
        channels=2,
    )


def reassigned_errors(ours, ref, valid, *, drift: bool, label: str):
    """Largest errors of ``(freq, time, power)`` ``[..., bins]`` against
    ``ref`` at valid bins within 60 dB of their column's peak, checked
    against the bars of ``openmeters_tpu_torch/utils/parity.py`` (with
    ``drift`` where each side slid its own states over a run).  Returns
    ``(errors, held mask)``."""
    from openmeters_tpu_torch.utils.parity import check_reassigned
    from openmeters_tpu_torch.utils.parity import reassigned_errors as errors_of

    err, held = errors_of(ours, ref, valid, drift=drift)
    check_reassigned(err, label)
    return err, held


def fmt_errors(err: dict) -> str:
    return (
        f"max |d freq| {err['freq_hz']:.3e} Hz, |d time| {err['time_hops']:.3e} hop "
        f"({err['time_over_bar']:.2f} of its bar; {err['time_at_peak']:.2e} at the peak), "
        f"|d power|/power {err['power_rel']:.3e}"
    )


def analytic_frames(s: int, length: int, gen, dev):
    """``[2, s, length]`` float32: per stream two sines (0.4 and 0.1) plus
    faint noise, and their Hilbert transform (minus cosines) plus faint
    noise, made on the card from ``gen``."""
    t = torch.arange(length, device=dev, dtype=torch.float64) / 48_000.0
    f0 = torch.rand((2, s, 1), generator=gen, device=dev, dtype=torch.float64) * 15_800.0 + 200.0
    ph = torch.rand((2, s, 1), generator=gen, device=dev, dtype=torch.float64) * 2 * np.pi
    amp = torch.tensor([0.4, 0.1], device=dev, dtype=torch.float64).view(2, 1, 1)
    arg = 2 * np.pi * f0 * t + ph
    x = torch.stack([(amp * torch.sin(arg)).sum(0), -(amp * torch.cos(arg)).sum(0)])
    noise = torch.randn(x.shape, generator=gen, device=dev, dtype=torch.float64)
    return (x + 0.005 * noise).float()


def phase6_reassigned_hop(dev) -> dict:
    from openmeters_tpu_torch.ops.reassigned_hop import (
        reassigned_sliding_hop,
        reassigned_sliding_hop_reference,
    )
    from openmeters_tpu_torch.ops.sliding_reassigned import SlidingReassigned
    from openmeters_tpu_torch.utils.parity import reassigned_errors as errors_of
    from openmeters_tpu_torch.utils.windows import WindowKind

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    shapes = [
        ("default", SlidingReassigned(2048, 64, 256, WindowKind.HANN, 48_000.0), FLAGSHIP_S),
        ("blackman-harris zpf 2",
         SlidingReassigned(512, 64, 256, WindowKind.BLACKMAN_HARRIS, 48_000.0, zpf=2), 37),
    ]
    result = {}
    for label, sl, s in shapes:
        n, hop, cols = sl.n, sl.hop, sl.cols_cap
        x = analytic_frames(s, n + cols * hop, gen, dev)
        ramp = torch.arange(n, device=dev, dtype=torch.float64) - (n - 1) * 0.5
        crops = torch.stack([x[0, :, :n], x[1, :, :n], x[0, :, :n] * ramp, x[1, :, :n] * ramp])
        spec = torch.fft.rfft(crops.double(), n=sl.pfft)
        states = tuple(
            part.float().contiguous() for i in range(4) for part in (spec[i].real, spec[i].imag)
        )
        del crops, spec

        def deltas(sig):
            return torch.stack(
                [torch.cat([sig[:, n + k * hop : n + (k + 1) * hop], sig[:, k * hop : (k + 1) * hop]], -1)
                 for k in range(cols)],
                dim=1,
            ).contiguous()

        dx, dh = deltas(x[0]), deltas(x[1])
        t = sl._tensors(dev)
        args = (states, dx, dh, t["upd"], t["rot_r"], t["rot_i"], t["normq"], t["freqb"])
        kw = dict(n=n, zpf=sl.zpf, coeffs=sl.coeffs(), inv_2pi=48_000.0 / (2.0 * np.pi),
                  inv_hop=1.0 / hop, latency_hops=sl.center / hop)
        # the plain version in float64 too: the reassignment's corrections at
        # bins 60 dB down amplify the products' rounding, so two f32 results
        # that round apart (the kernel's 3xTF32 sums and cuBLAS's FMA chains)
        # differ by about each one's own distance from the exact value.  The
        # kernel's corrections are held to the bars against the exact
        # (float64) plain version and to be as close to it as the f32 plain
        # version; the states against the f32 plain version, as before.
        args64 = (tuple(a.double() for a in states), *(a.double() for a in args[1:]))
        for ready in sorted({0, 1, cols}):
            kst, kf, kt, kp = reassigned_sliding_hop(ready, *args, **kw, tiles=t["tiles"])
            rst, rf, rt, rp = reassigned_sliding_hop_reference(ready, *args, **kw)
            exact = tuple(a.float() for a in reassigned_sliding_hop_reference(ready, *args64, **kw)[1:])
            torch.cuda.synchronize()
            state_err = abs_err = 0.0
            for i in range(0, 8, 2):  # each complex state against its row maximum
                scale = torch.clamp_min(torch.hypot(rst[i], rst[i + 1]).amax(1, keepdim=True), 1e-30)
                for j in (i, i + 1):
                    d = (kst[j] - rst[j]).abs()
                    state_err = max(state_err, float((d / scale).max()))
                    abs_err = max(abs_err, float(d.max()))
            every = torch.ones((s, cols), dtype=torch.bool, device=dev)
            err, _ = reassigned_errors(
                (kf, kt, kp), exact, every, drift=False, label=f"phase 6 {label} ready={ready}",
            )
            plain_err, _ = errors_of((rf, rt, rp), exact, every, drift=False)
            kern_err, _ = errors_of((kf, kt, kp), (rf, rt, rp), every, drift=False)
            log(
                f"phase 6 {label} S={s} n={n} hop={hop} cols={cols} bins={sl.bins} ready={ready}: "
                f"states max|d|/rowmax {state_err:.3e} (abs {abs_err:.3e}); kernel vs float64 plain: "
                f"{fmt_errors(err)}; f32 plain vs float64 plain: {fmt_errors(plain_err)}; kernel vs f32 "
                f"plain: {fmt_errors(kern_err)}"
            )
            check(state_err <= 1e-5, f"{label} ready={ready}: state error {state_err}")
            check(err["time_hops"] <= 1.5 * plain_err["time_hops"],
                  f"{label} ready={ready}: time 1.5 times further from float64 than the f32 plain version's")
            if ready == 0:
                check(all(torch.equal(a, b) for a, b in zip(kst, states)), "held states changed")
            if label == "default" and ready == cols:
                result = {"max_abs_err": abs_err, "max_rel_state_err": state_err, **err}
            del exact

        if label == "default":
            reps = 10
            kern = lambda: reassigned_sliding_hop(cols, *args, **kw, tiles=t["tiles"])  # noqa: E731, B023
            plain = lambda: reassigned_sliding_hop_reference(cols, *args, **kw)  # noqa: E731
            p1, k1, k2, p2 = (time_cuda(f, reps) for f in (plain, kern, kern, plain))
            result["ms"] = (k1 + k2) / 2
            result["plain_ms"] = (p1 + p2) / 2
            # per delta sample of x and hx, 4 FMA a bin (U and V, re and im)
            out = kern()
            moved = nbytes(*states, dx, dh, *args[3:], *out[0], *out[1:])
            result.update(bound(moved, 2.0 * s * cols * 2 * (2 * hop) * 4 * sl.bins, tensor_cores=True))
            # the library call: one FFT of the hop's frames under the three windows
            frames = torch.randn((3, s, cols, n), generator=gen, device=dev, dtype=torch.complex64)
            result["library_ms"] = time_cuda(lambda: torch.fft.fft(frames), reps)  # noqa: B023
            del frames, out
            log(
                f"phase 6 timing at S={s}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                f"FFT of the three windowed frames {result['library_ms']:.4f} ms, {fmt_bound(result)} "
                f"[{card_line()}]"
            )
        del x, states, dx, dh, args, args64
    torch.cuda.empty_cache()
    return result


def columns_fft_chain(frames, n: int):
    """The per-column transform's FFTs in f32 ``torch.fft``: the analytic
    signal of each ``2n``-sample frame, its centre crop, U and V."""
    h = 2 * n
    spec = torch.fft.rfft(frames, n=h)
    spec[..., 0] = 0.0
    a = torch.fft.ifft(spec, n=h)[..., (h - n) // 2 : (h - n) // 2 + n]
    ramp = torch.arange(n, device=frames.device, dtype=torch.float32) - (n - 1) * 0.5
    return torch.fft.fft(torch.stack([a, a * ramp]))


def phase7_reassigned_columns(dev) -> dict:
    from openmeters_tpu_torch.ops.reassigned_columns import (
        reassigned_columns,
        reassigned_columns_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def compare(frames, kw) -> dict:
        rows = frames.shape[0]
        out = reassigned_columns(frames, **kw)
        ref = reassigned_columns_reference(frames, **kw)
        torch.cuda.synchronize()
        err, held = reassigned_errors(
            out, ref, torch.ones((rows,), dtype=torch.bool, device=dev), drift=False,
            label=f"phase 7 n={kw['n']} rows={rows}",
        )
        log(
            f"phase 7 n={kw['n']} h={kw['h']} rows={rows} hop={kw['hop']}: {fmt_errors(err)}; "
            f"max |d power| {err['power_abs_all']:.3e} over all bins "
            f"({float(held.float().mean()):.3f} of bins held)"
        )
        return err

    result = {}
    for n, hop in ((8192, 512), (2048, 512), (512, 256)):
        h, rows = 2 * n, 1024
        frames = analytic_frames(rows, h, gen, dev)[0].contiguous()
        kw = dict(n=n, h=h, coeffs=(0.5, -0.5), sample_rate=48_000.0, hop=hop)
        compare(frames, kw)
        if n == 8192:
            # the main path's shape: one 16384-sample frame per stream at S=8192
            frames = analytic_frames(FLAGSHIP_S, h, gen, dev)[0].contiguous()
            err = compare(frames, kw)
            result = {"max_abs_err": err["power_abs_all"], **err}
            kern = lambda: reassigned_columns(frames, **kw)  # noqa: E731
            plain = lambda: reassigned_columns_reference(frames, **kw)  # noqa: E731
            p1, k1, k2, p2 = (time_cuda(f, 5) for f in (plain, kern, kern, plain))
            result["ms"] = (k1 + k2) / 2
            result["plain_ms"] = (p1 + p2) / 2
            # the transforms the kernel runs, n points each: the real frame's
            # half-length FFT, the two parities of the pruned inverse, U and V
            out = reassigned_columns(frames, **kw)
            result.update(bound(nbytes(frames, *out), fft_flops(n, 5 * FLAGSHIP_S)))
            result["library_ms"] = time_cuda(lambda: columns_fft_chain(frames, n), 5)  # noqa: B023
            del out
            log(
                f"phase 7 timing at {FLAGSHIP_S} frames, n={n}: kernel {k1:.4f}/{k2:.4f} ms, "
                f"plain {p1:.4f}/{p2:.4f} ms, f32 torch.fft chain {result['library_ms']:.4f} ms, "
                f"bound {result['bound_ms']:.4f} ms ({result['bound_by']}) [{card_line()}]"
            )
        else:
            k1 = time_cuda(lambda: reassigned_columns(frames, **kw), 10)  # noqa: B023
            p1 = time_cuda(lambda: reassigned_columns_reference(frames, **kw), 10)  # noqa: B023
            log(f"phase 7 timing at {rows} frames, n={n}: kernel {k1:.4f} ms, plain {p1:.4f} ms "
                f"[{card_line()}]")
        del frames
    torch.cuda.empty_cache()
    return result


def phase8_reassigned_slice(dev) -> None:
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine

    b = 256
    for fft, hop, s, hops, reset_hop in ((2048, 64, 32, 200, 90), (8192, 512, 8, 160, None)):
        rng = np.random.default_rng(SEED + fft)
        t = np.arange(hops * b) / 48_000.0
        freqs = rng.uniform(40.0, 8000.0, size=(s, 1, 1))
        audio = 0.3 * np.sin(2 * np.pi * freqs * t[None, :, None]) + 0.005 * rng.standard_normal((s, hops * b, 2))
        audio[3] *= 1e-3  # a quiet stream
        audio = audio.astype(np.float32)
        reset = np.zeros((s,), bool)
        reset[[5, 17] if s > 17 else [5]] = True

        engine = MeterEngine(reassigned_config(fft, hop))
        sliding = engine.analyzers["spectrogram"].use_sliding_reassigned
        sessions = {d: AnalysisSession(engine, s, d) for d in (dev, "cpu")}
        worst = {"freq_hz": 0.0, "time_hops": 0.0, "time_over_bar": 0.0, "power_rel": 0.0,
                 "time_at_peak": 0.0, "lufs": 0.0, "true_peak": 0.0}
        pv_diff = pv_total = columns = 0
        for i in range(hops):
            blk = audio[:, i * b : (i + 1) * b]
            r = reset if i == reset_hop else None
            snaps = {d: sess.feed(blk, r) for d, sess in sessions.items()}
            ga, ca = snaps[dev]["spectrogram"], snaps["cpu"]["spectrogram"]
            vc = ca.valid
            check(bool(torch.equal(ga.valid.cpu(), vc)), f"{fft}/{hop} hop {i}: valid masks differ")
            columns += int(vc.sum())
            err, held = reassigned_errors(
                (ga.freq_hz.cpu(), ga.time_offset.cpu(), ga.power.cpu()),
                (ca.freq_hz, ca.time_offset, ca.power), vc, drift=sliding,
                label=f"phase 8 {fft}/{hop} hop {i}",
            )
            for key in err:
                if key in worst:
                    worst[key] = max(worst[key], err[key])
            pv = ga.point_valid.cpu() != ca.point_valid
            check(not bool((pv & held).any()), f"{fft}/{hop} hop {i}: point_valid differs at held bins")
            pv_diff += int(pv.sum())
            pv_total += int(vc.sum()) * pv.shape[-1]
            la, lc = snaps[dev]["loudness"], snaps["cpu"]["loudness"]
            for f in la._fields:
                e = float((getattr(la, f).cpu() - getattr(lc, f)).abs().max())
                key = "true_peak" if f == "true_peak_db" else "lufs"
                worst[key] = max(worst[key], e)
        log(
            f"phase 8 card vs cpu, reassigned {fft}/{hop}, S={s}, {hops} hops"
            f"{f', reset at hop {reset_hop}' if reset_hop is not None else ''}: {columns} valid columns; "
            f"{fmt_errors(worst)}; point_valid differs at {pv_diff / max(pv_total, 1):.2e} of valid bins "
            f"(none held); loudness max |d| {worst['lufs']:.3e} LU/dB, true peak {worst['true_peak']:.3e} dB"
        )
        check(columns > 0, f"{fft}/{hop}: no valid column")
        check(worst["lufs"] <= 0.01, f"loudness differs by {worst['lufs']}")
        check(worst["true_peak"] <= 1e-3, f"true peak differs by {worst['true_peak']}")


def timed_reassigned_run(label: str, dev, fft: int, hop: int, warmup: int, counter, expect: int) -> dict:
    """``warmup`` then ``TIMED_HOPS`` hops of loudness plus the reassigned
    ``fft``/``hop`` spectrogram at S=8192 stereo streams, every output leaf
    folded into a device scalar; ``counter`` must count ``expect`` kernel
    launches over the timed hops.  Then a profile of 20 more hops."""
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine

    s, b = FLAGSHIP_S, 256
    engine = MeterEngine(reassigned_config(fft, hop))
    torch.cuda.reset_peak_memory_stats()
    session = AnalysisSession(engine, s, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + fft)
    bank = 16  # distinct blocks made on the card, fed in turn
    t = torch.arange(bank * b, device=dev, dtype=torch.float32) / 48_000.0
    freqs = torch.rand((s, 1, 1), generator=gen, device=dev) * 4000.0 + 50.0
    audio = 0.3 * torch.sin(2 * torch.pi * freqs * t[None, :, None]) + 0.05 * torch.randn(
        (s, bank * b, 2), generator=gen, device=dev
    )
    blocks = [audio[:, i * b : (i + 1) * b].contiguous() for i in range(bank)]
    del audio

    sink = torch.zeros((), device=dev, dtype=torch.float64)
    valid_cols = torch.zeros((), device=dev, dtype=torch.int64)

    def consume(snaps):
        # fold every output leaf into one device scalar: nothing is dropped,
        # and a non-finite value anywhere (every point is finite by
        # construction, valid or not) leaves the sum non-finite
        nonlocal sink, valid_cols
        lo, sg = snaps["loudness"], snaps["spectrogram"]
        acc = sum(getattr(lo, f).sum(dtype=torch.float64) for f in lo._fields)
        for f in ("freq_hz", "time_offset", "power", "point_valid", "valid"):
            acc = acc + getattr(sg, f).sum(dtype=torch.float64)
        sink = sink + acc
        valid_cols = valid_cols + sg.valid.sum()

    for i in range(warmup):
        consume(session.feed(blocks[i % bank]))
    torch.cuda.synchronize()
    valid_cols.zero_()

    counter.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TIMED_HOPS):
        snaps = session.feed(blocks[(warmup + i) % bank])
        consume(snaps)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches

    ms = start.elapsed_time(stop) / TIMED_HOPS
    realtime = s * (b / 48_000.0) / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated()
    log(
        f"{label} reassigned {fft}/{hop} S={s}: {ms:.4f} ms/hop (CUDA events; host wall "
        f"{1e3 * wall / TIMED_HOPS:.4f} ms/hop), {realtime:.1f} streams realtime, peak memory "
        f"{peak / 2**30:.3f} GiB, {counter.__name__} launched {launches} times, "
        f"{int(valid_cols)} valid columns [{card_line()}]"
    )
    check(launches == expect, f"{counter.__name__} launched {launches} times, want {expect}")
    check(bool(torch.isfinite(sink)), "non-finite output")
    check(int(valid_cols) > 0, "no valid spectrogram column")
    lo = snaps["loudness"]
    for f in lo._fields:
        check(bool(torch.isfinite(getattr(lo, f)).all()), f"{f} not finite")
    check(bool((lo.integrated_lufs > engine.config.loudness.floor_db).all()), "integrated loudness at the floor")
    profile_hops(label, session, blocks, consume, ms)
    result = {"ms_per_hop": ms, "launches": launches, "peak_gib": peak / 2**30}
    del session, blocks
    torch.cuda.empty_cache()
    return result


def phase9_reassigned_s8192(dev) -> tuple[int, int]:
    from openmeters_tpu_torch.ops.reassigned_columns import reassigned_columns
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop

    sliding = timed_reassigned_run(
        "phase 9a", dev, 2048, 64, WARMUP_HOPS, reassigned_sliding_hop, TIMED_HOPS
    )
    # the 16384-sample window first fills at hop 64; one column every second hop
    columns = timed_reassigned_run(
        "phase 9b", dev, 8192, 512, 80, reassigned_columns, TIMED_HOPS // 2
    )
    return sliding["launches"], columns["launches"]


# -- the oscilloscope ----------------------------------------------------------

OSC_LANES = 19456  # the mirrored ring: 2 x 9728 at 48 kHz
OSC_KCAP, OSC_WCAP, OSC_NFFT, OSC_OUT = 4800, 7200, 8192, 2401
# the same at 192 kHz: lanes, template, window, nfft, offsets
OSC_192K = (77312, 19200, 28800, 32768, 9601)


def search_inputs(s: int, gen, dev, lanes: int = OSC_LANES, kcap: int = OSC_KCAP) -> dict:
    """The search's inputs as the oscilloscope hands them over: a ring of
    noise, starts within the ring (six at the kernel's clamp edges or past
    them), template lengths from 0.4 to 1 times the store's (1920 to 4800 at
    48 kHz) centred in it, searches of 1 to klen/2, and the anchor shift
    -off (in [-1440, 0] at 48 kHz)."""
    ring = torch.randn((s, lanes), generator=gen, device=dev) * 0.3
    starts = torch.randint(0, lanes // 2, (s,), generator=gen, device=dev, dtype=torch.int32)
    starts[:6] = torch.tensor([0, 1, 127, 9727, 12256, lanes - 456], dtype=torch.int32, device=dev)
    klen = torch.randint(2 * kcap // 5, kcap + 1, (s,), generator=gen, device=dev, dtype=torch.int32)
    off = (kcap - klen) // 2
    kidx = torch.arange(kcap, device=dev, dtype=torch.int32)
    kmask = (kidx[None, :] >= off[:, None]) & (kidx[None, :] < (off + klen)[:, None])
    tmpl = torch.where(kmask, torch.randn((s, kcap), generator=gen, device=dev), 0.0)
    search = (torch.rand((s,), generator=gen, device=dev) * (klen // 2).float()).to(torch.int32) + 1
    return {"ring": ring, "starts": starts, "tmpl": tmpl, "klen": klen,
            "wlen": search + klen, "shift": (-off).contiguous()}


def library_chain(work, tmpl, shift, nfft: int, out: int):
    """The library calls computing the search on the materialised window:
    cuFFT for the dots, ``cumsum`` for the sums.  Returns ``(dots,
    dots and sums)`` as two closures."""
    k = torch.arange(nfft // 2 + 1, device=work.device, dtype=torch.int64)
    ang = (2.0 * math.pi / nfft) * torch.remainder(k[None, :] * shift.long()[:, None], nfft).float()
    ph = torch.polar(torch.ones_like(ang), ang)

    def dots():
        spec = torch.fft.rfft(work, n=nfft) * torch.conj(torch.fft.rfft(tmpl, n=nfft)) * ph
        return torch.fft.irfft(spec, n=nfft)[:, :out]

    def sums():
        return dots(), torch.cumsum(torch.cat([work, work * work]), dim=-1)

    return dots, sums


def phase10_corr(dev) -> dict:
    from openmeters_tpu_torch.ops import corr
    from openmeters_tpu_torch.ops.rows import window_rows_reference
    from openmeters_tpu_torch.utils.parity import check_corr, corr_errors

    s = FLAGSHIP_S
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = search_inputs(s, gen, dev)
    ring, starts, tmpl, klen, wlen, shift = (x[k] for k in ("ring", "starts", "tmpl", "klen", "wlen", "shift"))
    work = window_rows_reference(ring, starts.long().clamp(0, OSC_LANES - OSC_WCAP), OSC_WCAP).contiguous()
    sums_args = (klen, wlen, shift, OSC_NFFT, OSC_OUT)
    cases = {
        "corr_dots_sums_ring": (
            lambda: corr.corr_dots_sums_ring(ring, starts, tmpl, *sums_args, OSC_WCAP),
            lambda: corr.corr_dots_sums_ring_reference(ring, starts, tmpl, *sums_args, OSC_WCAP),
        ),
        "corr_dots_sums": (
            lambda: corr.corr_dots_sums(work, tmpl, *sums_args),
            lambda: corr.corr_dots_sums_reference(work, tmpl, *sums_args),
        ),
        "corr_dots": (
            lambda: corr.corr_dots(work, tmpl, shift, OSC_NFFT, OSC_OUT),
            lambda: corr.corr_dots_reference(work, tmpl, shift, OSC_NFFT, OSC_OUT),
        ),
    }
    library_dots, library_sums = library_chain(work, tmpl, shift, OSC_NFFT, OSC_OUT)

    # one forward and one inverse complex transform a stream
    flops = fft_flops(OSC_NFFT, 2 * s)
    results = {}
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = corr_errors(got, ref)
        check_corr(err, f"phase 10 {name}")
        outs = got if isinstance(got, tuple) else (got,)
        if name == "corr_dots":
            moved = nbytes(work, tmpl, shift, *outs)
        else:
            # from the ring, only the window is read: as many bytes as ``work``
            moved = nbytes(work, tmpl, klen, wlen, shift, *outs) + (nbytes(starts) if "ring" in name else 0)
        p1, k1, k2, p2 = (time_cuda(f, 5) for f in (plain, kern, kern, plain))
        lib = time_cuda(library_dots if name == "corr_dots" else library_sums, 5)
        results[name] = {
            "max_abs_err": max(v for key, v in err.items() if key.endswith("_abs")),
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
            **bound(moved, flops),
        }
        r = results[name]
        log(
            f"phase 10 {name} S={s} nfft {OSC_NFFT} out {OSC_OUT}: "
            + ", ".join(f"{key} {v:.3e}" for key, v in err.items() if not key.endswith("_abs"))
            + f" of their scale; max |d| {r['max_abs_err']:.3e}; kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, cuFFT+cumsum chain {lib:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) [{card_line()}]"
        )
    del x, ring, work, tmpl, library_dots, library_sums
    torch.cuda.empty_cache()

    # 192 kHz: the buffer no longer fits shared memory and lives in scratch
    lanes, kcap, wcap, nfft, out = OSC_192K
    s = 2048
    x = search_inputs(s, gen, dev, lanes, kcap)
    args = tuple(x[k] for k in ("ring", "starts", "tmpl", "klen", "wlen", "shift")) + (nfft, out, wcap)
    got, ref = corr.corr_dots_sums_ring(*args), corr.corr_dots_sums_ring_reference(*args)
    torch.cuda.synchronize()
    err = corr_errors(got, ref)
    check_corr(err, "phase 10 corr_dots_sums_ring at 192 kHz")
    work = window_rows_reference(x["ring"], x["starts"].long().clamp(0, lanes - wcap), wcap).contiguous()
    _, library_sums = library_chain(work, x["tmpl"], x["shift"], nfft, out)
    kern = lambda: corr.corr_dots_sums_ring(*args)  # noqa: E731
    plain = lambda: corr.corr_dots_sums_ring_reference(*args)  # noqa: E731
    p1, k1, k2, p2 = (time_cuda(f, 3) for f in (plain, kern, kern, plain))
    lib = time_cuda(library_sums, 3)
    log(
        f"phase 10 corr_dots_sums_ring at 192 kHz S={s} nfft {nfft} out {out} (global scratch): "
        + ", ".join(f"{key} {v:.3e}" for key, v in err.items() if not key.endswith("_abs"))
        + f" of their scale; kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"cuFFT+cumsum chain {lib:.4f} ms [{card_line()}]"
    )
    del x, args, got, ref, work, library_sums
    torch.cuda.empty_cache()
    return results


def phase11_rows(dev) -> dict:
    from openmeters_tpu_torch.ops.rows import window_rows, window_rows_reference

    s, n = FLAGSHIP_S, OSC_LANES
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    x = torch.randn((s, n), generator=gen, device=dev)
    result = {}
    for length, windows in ((4800, 0), (4802, 0), (300, 3)):
        shape = (s,) if windows == 0 else (s, windows)
        starts = torch.randint(-10, n + 10, shape, generator=gen, device=dev, dtype=torch.int32)
        got = window_rows(x, starts, length)
        ref = window_rows_reference(x, starts, length)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, ref)), f"window_rows length {length} differs from torch.gather")
        max_abs_err = float((got - ref).abs().max())
        st = (starts if windows else starts[:, None]).long().clamp(0, n - length)
        idx = (st[..., None] + torch.arange(length, device=dev)).reshape(s, -1)
        kern = lambda: window_rows(x, starts, length)  # noqa: E731, B023
        plain = lambda: window_rows_reference(x, starts, length)  # noqa: E731, B023
        p1, k1, k2, p2 = (time_cuda(f, 20) for f in (plain, kern, kern, plain))
        lib = time_cuda(lambda: torch.gather(x, 1, idx), 20)  # noqa: B023
        b = bound(nbytes(starts) + 2 * got.numel() * got.element_size(), 0.0)
        log(
            f"phase 11 window_rows [{s}, {n}] -> {length} x {max(windows, 1)}: bit-exact; kernel "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, torch.gather {lib:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card_line()}]"
        )
        if length == 4800:
            result = {"max_abs_err": max_abs_err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                      "library_ms": lib, **b}
        del got, ref, idx
    del x
    torch.cuda.empty_cache()
    return result


def osc_config(**kw):
    from openmeters_tpu_torch.engine import EngineConfig

    return EngineConfig(spectrum=None, stereometer=None, waveform=None, channels=2, **kw)


def osc_audio(hops: int, seed: int) -> np.ndarray:
    """``[8, hops * 256, 2]`` stereo: sines at 110, 440 and 1234 Hz, a
    220 Hz sawtooth, a 220 -> 880 Hz glide, silence then a 330 Hz onset at
    hop 30, a 440 Hz sine, a quiet 660 Hz sine with its octave; right is
    left at 0.8 plus a tone at 1.5 times the base, and faint noise."""
    rng = np.random.default_rng(seed)
    n = hops * 256
    t = np.arange(n) / 48_000.0
    k = 2.0 * np.log(2.0) / (n / 48_000.0)
    left = np.stack([
        0.6 * np.sin(2 * np.pi * 110.0 * t),
        0.5 * np.sin(2 * np.pi * 440.0 * t),
        0.4 * np.sin(2 * np.pi * 1234.0 * t),
        0.5 * (2.0 * ((220.0 * t) % 1.0) - 1.0),
        0.5 * np.sin(2 * np.pi * 220.0 * (np.exp(k * t) - 1.0) / k),
        np.where(t >= 30 * 256 / 48_000.0, 0.5 * np.sin(2 * np.pi * 330.0 * t), 0.0),
        0.5 * np.sin(2 * np.pi * 440.0 * t + 1.0),
        0.003 * (np.sin(2 * np.pi * 660.0 * t) + 0.5 * np.sin(2 * np.pi * 1320.0 * t)),
    ])
    base = np.array([110.0, 440.0, 1234.0, 220.0, 220.0, 330.0, 440.0, 660.0])
    right = 0.8 * left + 0.2 * np.sin(2 * np.pi * 1.5 * base[:, None] * t + rng.uniform(0, 6, (8, 1)))
    return (np.stack([left, right], -1) + 1e-4 * rng.standard_normal((8, n, 2))).astype(np.float32)


def phase12_osc_slice(dev) -> None:
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine
    from openmeters_tpu_torch.utils.parity import check_oscilloscope, oscilloscope_errors

    s, hops, b = 8, 150, 256
    audio = osc_audio(hops, SEED + 12)
    reset = np.zeros((s,), bool)
    reset[[3, 6]] = True
    engine = MeterEngine(osc_config(loudness=None, spectrogram=None))
    sessions = {d: AnalysisSession(engine, s, d) for d in (dev, "cpu")}
    keys = ("has_period", "missed", "reference", "pspec_re", "pspec_im")
    worst = {"period": 0.0, "span": 0.0, "position": 0.0, "reference": 0.0, "pspec": 0.0, "start_moved": 0}
    locked = 0
    for i in range(hops):
        blk = audio[:, i * b : (i + 1) * b]
        r = reset if i == 90 else None
        snaps = {d: sess.feed(blk, r)["oscilloscope"] for d, sess in sessions.items()}
        states = {d: {k: sess.carry["oscilloscope"][k] for k in keys} for d, sess in sessions.items()}
        err = oscilloscope_errors(snaps[dev], snaps["cpu"], states[dev], states["cpu"])
        check_oscilloscope(err, f"phase 12 hop {i}")
        for key in worst:
            worst[key] = worst[key] + err[key] if key == "start_moved" else max(worst[key], err[key])
        locked += int(snaps["cpu"].locked.sum())
    log(
        f"phase 12 oscilloscope card vs cpu, S={s}, {hops} hops, reset at hop 90: locked, valid, "
        f"has_period and missed equal on every hop ({locked} locked stream-hops); start moved by one "
        f"sample at {worst['start_moved']} captures, samples equal at the others; max relative "
        f"|d period| {worst['period']:.3e}, |d span| {worst['span']:.3e}; max |d (start + frac)| "
        f"{worst['position']:.3e} sample; reference {worst['reference']:.3e} and probe spectrum "
        f"{worst['pspec']:.3e} of their row maximum"
    )
    check(locked > hops, "the oscilloscope hardly locked")


def phase13_default_s8192(dev) -> dict:
    """The tentpole config at S=8192, timed and profiled as in phase 5."""
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine
    from openmeters_tpu_torch.ops.corr import corr_dots_sums_ring
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.ops.rows import window_rows

    s, b, warmup = FLAGSHIP_S, 256, 80
    engine = MeterEngine(osc_config())
    torch.cuda.reset_peak_memory_stats()
    session = AnalysisSession(engine, s, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    bank = 16  # distinct blocks made on the card, fed in turn
    t = torch.arange(bank * b, device=dev, dtype=torch.float32) / 48_000.0
    freqs = torch.exp(torch.rand((s, 1, 1), generator=gen, device=dev) * math.log(2000.0 / 40.0)) * 40.0
    audio = 0.3 * torch.sin(2 * torch.pi * freqs * t[None, :, None]) + 0.05 * torch.randn(
        (s, bank * b, 2), generator=gen, device=dev
    )
    blocks = [audio[:, i * b : (i + 1) * b].contiguous() for i in range(bank)]
    del audio

    sink = torch.zeros((), device=dev, dtype=torch.float64)
    locked = torch.zeros((), device=dev, dtype=torch.int64)

    def consume(snaps):
        # every output leaf, the extracted capture windows included, into
        # one device scalar
        nonlocal sink, locked
        lo, sg, osc = snaps["loudness"], snaps["spectrogram"], snaps["oscilloscope"]
        acc = sum(getattr(lo, f).sum(dtype=torch.float64) for f in lo._fields)
        for f in ("freq_hz", "time_offset", "power", "point_valid", "valid"):
            acc = acc + getattr(sg, f).sum(dtype=torch.float64)
        for f in osc._fields:
            acc = acc + getattr(osc, f).sum(dtype=torch.float64)
        sink = sink + acc
        locked = locked + osc.locked.sum()

    for i in range(warmup):
        consume(session.feed(blocks[i % bank]))
    torch.cuda.synchronize()
    locked.zero_()

    counters = (corr_dots_sums_ring, window_rows, reassigned_sliding_hop)
    for c in counters:
        c.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TIMED_HOPS):
        snaps = session.feed(blocks[(warmup + i) % bank])
        consume(snaps)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}

    ms = start.elapsed_time(stop) / TIMED_HOPS
    realtime = s * (b / 48_000.0) / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated()
    log(
        f"phase 13 loudness + reassigned 2048/64 + oscilloscope S={s}: {ms:.4f} ms/hop (CUDA events; "
        f"host wall {1e3 * wall / TIMED_HOPS:.4f} ms/hop), {realtime:.1f} streams realtime, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {launches}, {int(locked)} locked stream-hops of "
        f"{s * TIMED_HOPS} [{card_line()}]"
    )
    check(launches["corr_dots_sums_ring"] == TIMED_HOPS, f"corr_dots_sums_ring launches {launches}")
    check(launches["window_rows"] == 2 * TIMED_HOPS, f"window_rows launches {launches}")
    check(launches["reassigned_sliding_hop"] == TIMED_HOPS, f"reassigned_sliding_hop launches {launches}")
    check(bool(torch.isfinite(sink)), "non-finite output")
    check(int(locked) > s * TIMED_HOPS // 2, f"only {int(locked)} locked stream-hops")
    osc = snaps["oscilloscope"]
    check(tuple(osc.samples.shape) == (s, 2, engine.analyzers["oscilloscope"].window_cap), "capture shape")
    check(bool(osc.trace_valid[:, 0].all()), "capture not valid")
    profile_hops("phase 13", session, blocks, consume, ms)
    result = {"ms_per_hop": ms, "launches": launches, "peak_gib": peak / 2**30}
    del session, blocks
    torch.cuda.empty_cache()
    return result


# -- the spectrum, the stereometer and the waveform ------------------------------


def phase14_sliding_spectra(dev) -> dict:
    from openmeters_tpu_torch.ops.sliding_hop import (
        block_fits,
        sliding_hop,
        sliding_hop_reference,
        sliding_hop_spectra,
        sliding_hop_spectra_reference,
    )
    from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT
    from openmeters_tpu_torch.utils.level import DB_FLOOR
    from openmeters_tpu_torch.utils.parity import SPECTRUM_AMPLITUDE
    from openmeters_tpu_torch.utils.windows import WindowKind, fft_bin_normalization, window_coefficients

    s = FLAGSHIP_S
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    cases = [  # label, config (block = the engine's spectrum block), output modes
        ("16384/512", SlidingSTFT(16384, 512, 512, WindowKind.HANN), (False,)),
        ("16384/128", SlidingSTFT(16384, 128, 256, WindowKind.HANN), (False, True)),
        ("4096/2048", SlidingSTFT(4096, 2048, 2048, WindowKind.BLACKMAN_HARRIS), (False, True)),
        ("8192/128 (B1a)", SlidingSTFT(8192, 128, 256, WindowKind.HANN), (False,)),
        # past one block's row: the deltas' rFFT and the bin-tiled kernel
        ("32768/1024 (tiled)", SlidingSTFT(32768, 1024, 1024, WindowKind.HANN), (False, True)),
    ]
    result = {}
    for label, sl, modes in cases:
        n, cols, bins = sl.fft_size, sl.frames.cols_cap, sl.bins
        check(sl.whole_row == label.endswith("(B1a)"), f"{label}: the other hop variant")
        check(block_fits(n) != label.endswith("(tiled)"), f"{label}: the other B1b route")
        norm = torch.from_numpy(fft_bin_normalization(window_coefficients(sl.window, n), n)).to(dev)
        coeffs = tuple(float(a) for a in sl._stencil())
        kw = dict(n=n, coeffs=coeffs, floor_db=DB_FLOOR)
        fr, fi, deltas = hop_inputs(sl, s, cols, gen, dev)
        rot_r, rot_i, dc = sl._rows(dev)
        if sl.whole_row:
            args = (fr, fi, deltas, *sl._updates(dev), rot_r, rot_i, dc, norm)
            kern_fn, plain_fn = sliding_hop, sliding_hop_reference
        else:
            args = (fr, fi, deltas, rot_r, rot_i, dc, norm)
            kern_fn, plain_fn = sliding_hop_spectra, sliding_hop_spectra_reference
        for emit_codes in modes:
            for ready in range(cols + 1):
                kr, ki, ko = kern_fn(ready, *args, **kw, emit_codes=emit_codes)
                rr, ri, ro = plain_fn(ready, *args, **kw, emit_codes=emit_codes)
                torch.cuda.synchronize()
                scale = torch.clamp_min(torch.amax(torch.hypot(rr, ri), dim=1, keepdim=True), 1e-30)
                d = torch.maximum((kr - rr).abs(), (ki - ri).abs())
                state_err, abs_err = float((d / scale).max()), float(d.max())
                if emit_codes:
                    ref = ro.to(torch.int32)
                    dd = (ko.to(torch.int32) - ref).abs()
                    all_valid = torch.ones(ref.shape[:2], dtype=torch.bool, device=dev)
                    code_diff = int((dd * resolved_bins(ref, all_valid)).max())
                    what = (f"codes max diff {code_diff} within {RESOLVED_DB:g} dB of the column peak "
                            f"({int(dd.max())} over all bins)")
                    check(code_diff <= 2, f"{label} ready={ready}: codes differ by {code_diff}")
                else:
                    peak = torch.clamp_min(ro.sqrt().amax(dim=-1, keepdim=True), 1e-30)
                    amp_err = float(((ko.sqrt() - ro.sqrt()).abs() / peak).max())
                    abs_err = max(abs_err, float((ko - ro).abs().max()))
                    what = f"power: amplitude max |d| {amp_err:.3e} of the column's peak"
                    check(amp_err <= SPECTRUM_AMPLITUDE, f"{label} ready={ready}: amplitude differs by {amp_err}")
                log(
                    f"phase 14 {label} S={s} cols={cols} bins={bins} ready={ready} "
                    f"{'codes' if emit_codes else 'power'}: state max|d|/rowmax {state_err:.3e}; {what}; "
                    f"max |d| {abs_err:.3e} [{card_line()}]"
                )
                check(state_err <= 1e-5, f"{label} ready={ready}: state error {state_err}")
                if ready == 0:
                    check(torch.equal(kr, fr) and torch.equal(ki, fi), f"{label}: held state changed")
                if label == "16384/512" and ready == cols:
                    result = {"max_abs_err": abs_err, "max_rel_state_err": state_err}
                del kr, ki, ko, rr, ri, ro

        if label == "16384/512":
            reps = 20
            kern = lambda: sliding_hop_spectra(cols, *args, **kw, emit_codes=False)  # noqa: E731, B023
            plain = lambda: sliding_hop_spectra_reference(cols, *args, **kw, emit_codes=False)  # noqa: E731, B023
            # per bin and column: slide 8, stencil 2 + 4 per reach, DC 2, power 4;
            # per column the delta transform: R/2 + 1 twiddled P-point FFTs
            # (P = hop rounded up to a power of two, R = n/P), 2 operations a
            # point to twiddle the samples
            out = kern()
            pts = 1 << (sl.hop - 1).bit_length()
            count = n // pts // 2 + 1
            flops = s * cols * (bins * (16.0 + 4 * (len(coeffs) - 1)) + 2.0 * pts * count)
            flops += fft_flops(pts, s * cols * count)
            result.update(bound(nbytes(*args, *out), flops))
            # the library call: one rFFT of the hop's windowed frames
            frames = torch.randn((s, cols, n), generator=gen, device=dev)
            result["library_ms"] = time_cuda(lambda: torch.fft.rfft(frames), reps)  # noqa: B023
            # the kernel is the whole sliding path of a steady hop (it
            # transforms the deltas itself); the direct path is the one the
            # analyzer takes at fft/hop <= 16 (mean removed, window, rFFT,
            # power).  Plain, direct, kernel, kernel, direct, plain on the
            # same card within this run.
            window = torch.from_numpy(window_coefficients(sl.window, n)).to(dev)

            def direct_path():
                spec = torch.fft.rfft((frames - frames.mean(dim=-1, keepdim=True)) * window)  # noqa: B023
                return (spec.real.square() + spec.imag.square()) * norm  # noqa: B023

            p1, d1, k1, k2, d2, p2 = (
                time_cuda(f, reps) for f in (plain, direct_path, kern, kern, direct_path, plain)
            )
            result["ms"] = (k1 + k2) / 2
            result["plain_ms"] = (p1 + p2) / 2
            del frames, out
            log(
                f"phase 14 timing at 16384/512 S={s}: kernel (the sliding path) {k1:.4f}/{k2:.4f} ms, "
                f"plain {p1:.4f}/{p2:.4f} ms, direct path (mean, window, rfft, power) {d1:.4f}/{d2:.4f} ms, "
                f"rfft of the windowed frames {result['library_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms "
                f"({result['bound_by']}) [{card_line()}]"
            )
        del fr, fi, deltas, args
        torch.cuda.empty_cache()
    return result


def phase15_three_band(dev) -> dict:
    from openmeters_tpu_torch.ops.iir import three_band_init, three_band_scan, three_band_scan_reference

    s, b = FLAGSHIP_S, 256
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    clean = torch.randn((b, s, 2), generator=gen, device=dev) * 0.3
    x = torch.randn((b, s, 2), generator=gen, device=dev) * 0.3
    x[10, 1, 0], x[50, 2, 1], x[200, 3, 0] = float("nan"), float("inf"), float("-inf")
    x[:, 4, 1] = float("nan")
    result = {}
    for cascade_n, high in ((1, False), (2, True)):
        kw = dict(cascade_n=cascade_n, cascade_high=high)
        # a state mid-stream: one clean block first
        _, state = three_band_scan_reference(clean, three_band_init((s, 2), cascade_n, device=dev), 48_000.0, **kw)
        got, gstate = three_band_scan(x, state, 48_000.0, **kw)
        ref, rstate = three_band_scan_reference(x, state, 48_000.0, **kw)
        torch.cuda.synchronize()
        err = max(float((got - ref).abs().max()), float((gstate - rstate).abs().max()))
        exact = torch.equal(got, ref) and torch.equal(gstate, rstate)
        check(bool(torch.isfinite(got).all()), f"cascade {cascade_n}: non-finite band")
        check(exact, f"cascade {cascade_n}: kernel differs from the plain loop by {err}")
        kern = lambda: three_band_scan(x, state, 48_000.0, **kw)  # noqa: E731, B023
        plain = lambda: three_band_scan_reference(x, state, 48_000.0, **kw)  # noqa: E731, B023
        p1, k1, k2, p2 = (time_cuda(f, 3) for f in (plain, kern, kern, plain))
        # per sample and lane, 4 cascades of biquads: 5 products and 4 sums each
        flops = b * s * 2 * 4 * cascade_n * 9.0
        bnd = bound(nbytes(x, state, got, gstate) + 4 * 5 * 4, flops)
        log(
            f"phase 15 three_band cascade {cascade_n}{' (high from the low split)' if high else ''} "
            f"[{b}, {s}, 2] with NaN and infinite samples: bit-exact (max |d| {err:.3e}); kernel "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}) [{card_line()}]"
        )
        if cascade_n == 1:  # the waveform's, on the literal default's path
            result = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                      "library_ms": None, **bnd}
        del got, ref, gstate, rstate, state
    del x, clean
    torch.cuda.empty_cache()
    return result


def stereo_audio(s: int, n: int, seed: int, bad: bool = False) -> np.ndarray:
    """``[s, n, 2]``: a sine per stream (50 Hz-8 kHz) plus faint noise, the
    right at half the left plus a second tone; with ``bad`` a NaN, an inf
    and a -inf pair early, in different streams."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48_000.0
    f = rng.uniform(50.0, 8000.0, (s, 1))
    left = 0.3 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((s, n))
    right = 0.5 * left + 0.1 * np.sin(2 * np.pi * 1.7 * f * t)
    audio = np.stack([left, right], -1).astype(np.float32)
    if bad:
        audio[0, 3000, 0], audio[1, 7000, 1], audio[0, 9001, :] = np.nan, np.inf, -np.inf
    return audio


def phase16_spectrum_slice(dev) -> None:
    from openmeters_tpu_torch.analyzers.spectrum import AveragingMode, SpectrumConfig
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import EngineConfig, MeterEngine
    from openmeters_tpu_torch.ops.sliding_hop import sliding_hop_spectra
    from openmeters_tpu_torch.utils.channels import Channel
    from openmeters_tpu_torch.utils.parity import check_spectrum, spectrum_errors

    s, b = 4, 256
    cases = [  # label, spectrum config, engine hops (150 spectrum hops each)
        *((f"16384/512 {m.value}", SpectrumConfig(hop_size=512, averaging=m), 300) for m in AveragingMode),
        ("16384/128 dual trace", SpectrumConfig(hop_size=128, source=Channel.LEFT,
                                                secondary_source=Channel.RIGHT,
                                                averaging=AveragingMode.PEAK_HOLD), 150),
        ("16384/1024 stock", SpectrumConfig(), 600),
    ]
    for label, sp, hops in cases:
        engine = MeterEngine(EngineConfig(loudness=None, spectrogram=None, oscilloscope=None, stereometer=None,
                                          waveform=None, channels=2, spectrum=sp))
        r, an = engine.spectrum_cadence, engine.analyzers["spectrum"]
        audio = stereo_audio(s, hops * b, SEED + hops + len(label))
        reset = np.array([False, True, False, False])
        reset_hop = (hops * 3 // 5) | 1  # mid spectrum hop where r > 1
        sessions = {d: AnalysisSession(engine, s, d) for d in (dev, "cpu")}
        before = sliding_hop_spectra.launches
        worst = {"amplitude": 0.0, "db": 0.0}
        flips = updated = 0
        for i in range(hops):
            blk = audio[:, i * b : (i + 1) * b]
            snaps = {d: sess.feed(blk, reset if i == reset_hop else None) for d, sess in sessions.items()}
            if "spectrum" not in snaps["cpu"]:
                continue
            err = spectrum_errors(
                sessions[dev].carry["spectrum"]["smoothed"], sessions["cpu"].carry["spectrum"]["smoothed"],
                snaps[dev]["spectrum"], snaps["cpu"]["spectrum"], an.state_floor,
            )
            check_spectrum(err, f"phase 16 {label} hop {i}")
            worst = {k: max(v, err[k]) for k, v in worst.items()}
            flips += err["floor_flips"]
            if (i + 1) % r == 0:
                updated += int(snaps["cpu"]["spectrum"].updated.sum())
        launches = sliding_hop_spectra.launches - before
        want = hops // r if an.use_sliding and not an._sliding.whole_row else 0
        log(
            f"phase 16 spectrum {label} card vs cpu, S={s}, {hops} hops ({hops // r} spectrum hops, "
            f"cadence {r}, {'sliding' if an.use_sliding else 'direct rFFT'}), reset at hop {reset_hop}: "
            f"amplitude max |d| {worst['amplitude']:.3e} of the trace's peak, dB max |d| {worst['db']:.3e} "
            f"within 50 dB of the peak, {flips} bins zeroed at the state floor on one side only, "
            f"{updated} updated stream-hops, B1b launches {launches} [{card_line()}]"
        )
        check(flips <= 2, f"{label}: {flips} floor flips")
        check(updated > 0, f"{label}: no spectrum column")
        check(launches == want, f"{label}: B1b launched {launches} times, want {want}")


def phase17_stereo_waveform(dev) -> None:
    from openmeters_tpu_torch.analyzers.stereometer import StereometerAnalyzer, StereometerConfig
    from openmeters_tpu_torch.analyzers.waveform import WaveformAnalyzer, WaveformConfig
    from openmeters_tpu_torch.utils.parity import check_snapshot, snapshot_errors

    s, hops, b = 8, 150, 256
    audio = torch.from_numpy(stereo_audio(s, hops * b, SEED + 17, bad=True))
    reset = torch.zeros((s,), dtype=torch.bool)
    reset[[1, 5]] = True
    cases = [
        ("stereometer", StereometerAnalyzer(StereometerConfig())),
        ("stereometer bands + band points", StereometerAnalyzer(StereometerConfig(emit_band_points=True))),
        ("waveform", WaveformAnalyzer(WaveformConfig())),
        ("waveform RMS history", WaveformAnalyzer(WaveformConfig(track_history=True))),
    ]
    for label, an in cases:
        carries = {d: an.init(s, device=d) for d in (dev, "cpu")}
        worst = {}
        for i in range(hops):
            blk = audio[:, i * b : (i + 1) * b]
            snaps = {}
            for d in carries:
                rm = reset.to(d) if i == 90 else None
                carries[d], snaps[d] = an.step(carries[d], blk.to(d), reset_mask=rm)
            err = snapshot_errors(snaps[dev], snaps["cpu"])
            check_snapshot(err, f"phase 17 {label} hop {i}")
            worst = {k: max(worst.get(k, 0.0), v) for k, v in err.items() if k != "mismatch"}
        log(
            f"phase 17 {label} card vs cpu, S={s}, {hops} hops, reset at hop 90, NaN and infinite samples: "
            f"exact fields equal; " + ", ".join(f"{k} max |d| {v:.3e}" for k, v in worst.items())
            + f" [{card_line()}]"
        )


ANALYZERS = ("loudness", "spectrogram", "spectrum", "oscilloscope", "stereometer", "waveform")


def analyzer_breakdown(label: str, dev, cfg, blocks, names, hops: int = 20, warmup: int = 40) -> dict:
    """Each analyzer of ``names`` alone: an engine of ``cfg`` with the others
    off, through ``AnalysisSession.feed`` at S=8192, ``warmup`` hops, then
    the device's kernel time per hop over ``hops`` profiled hops (the
    engine's stereo fold included; outputs not consumed)."""
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine

    out = {}
    for name in names:
        one = MeterEngine(dataclasses.replace(cfg, **{f: None for f in ANALYZERS if f != name}))
        session = AnalysisSession(one, FLAGSHIP_S, dev)
        for i in range(warmup):
            session.feed(blocks[i % len(blocks)])
        out[name], _ = profiled(lambda i: session.feed(blocks[(warmup + i) % len(blocks)]), hops)  # noqa: B023
        del session
        torch.cuda.empty_cache()
    log(
        f"{label} each analyzer alone, device kernel time in ms/hop over {hops} profiled hops after "
        f"{warmup} (the engine's fold included, outputs not consumed): "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items()) + f"; sum {sum(out.values()):.4f} [{card_line()}]"
    )
    return out


def phase18_literal_default(dev, label: str, spectrum=None, expect_b1b: int = 0,
                            breakdown: tuple = ANALYZERS) -> dict:
    """The literal ``EngineConfig()`` (with ``spectrum`` in place of the stock
    spectrum if given) at S=8192 through ``AnalysisSession.feed``: 80
    warm-up hops, 200 timed with every output leaf folded into a device
    scalar (the spectrum's on the hops that make it), counting each kernel's
    launches, then a profile, then ``breakdown``'s analyzers each alone."""
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import EngineConfig, MeterEngine
    from openmeters_tpu_torch.ops.corr import corr_dots_sums_ring
    from openmeters_tpu_torch.ops.iir import three_band_scan
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.ops.rows import window_rows
    from openmeters_tpu_torch.ops.sliding_hop import sliding_hop, sliding_hop_spectra

    cfg = EngineConfig() if spectrum is None else dataclasses.replace(EngineConfig(), spectrum=spectrum)
    engine = MeterEngine(cfg)
    r = engine.spectrum_cadence
    s, b, warmup, channels = FLAGSHIP_S, 256, 80, engine.config.channels
    torch.cuda.reset_peak_memory_stats()
    session = AnalysisSession(engine, s, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    bank = 16  # distinct blocks made on the card, fed in turn
    t = torch.arange(bank * b, device=dev, dtype=torch.float32) / 48_000.0
    freqs = torch.exp(torch.rand((s, 1, 1), generator=gen, device=dev) * math.log(2000.0 / 40.0)) * 40.0
    audio = 0.3 * torch.sin(2 * torch.pi * freqs * t[None, :, None]) + 0.05 * torch.randn(
        (s, bank * b, 2), generator=gen, device=dev
    )
    # two channels of audio, the rest of the engine's 8 silent (as analyze pads)
    blocks = [torch.nn.functional.pad(audio[:, i * b : (i + 1) * b], (0, channels - 2)).contiguous()
              for i in range(bank)]
    del audio

    sink = torch.zeros((), device=dev, dtype=torch.float64)
    locked = torch.zeros((), device=dev, dtype=torch.int64)
    last_spectrum = None
    spectra = 0

    def consume(snaps):
        # every output leaf into one device scalar; the spectrum snapshot the
        # session holds between spectrum hops only when it is new
        nonlocal sink, locked, last_spectrum, spectra
        acc = torch.zeros((), device=dev, dtype=torch.float64)
        for name, snap in snaps.items():
            if name == "spectrum":
                if snap is last_spectrum:
                    continue
                last_spectrum = snap
                spectra += 1
            for f in snap._fields:
                acc = acc + getattr(snap, f).sum(dtype=torch.float64)
        sink = sink + acc
        locked = locked + snaps["oscilloscope"].locked.sum()

    for i in range(warmup):
        consume(session.feed(blocks[i % bank]))
    torch.cuda.synchronize()
    locked.zero_()
    spectra = 0

    counters = (reassigned_sliding_hop, corr_dots_sums_ring, window_rows, three_band_scan,
                sliding_hop_spectra, sliding_hop)
    for c in counters:
        c.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TIMED_HOPS):
        snaps = session.feed(blocks[(warmup + i) % bank])
        consume(snaps)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}

    ms = start.elapsed_time(stop) / TIMED_HOPS
    realtime = s * (b / 48_000.0) / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated()
    sp = engine.analyzers["spectrum"]
    log(
        f"{label} EngineConfig() {'' if spectrum is None else 'with the spectrum at hop 512 '}S={s}, "
        f"{channels} channels, spectrum {sp.config.fft_size}/{sp.config.hop_size} at cadence {r} "
        f"({'sliding' if sp.use_sliding else 'direct rFFT'}): {ms:.4f} ms/hop (CUDA events; host wall "
        f"{1e3 * wall / TIMED_HOPS:.4f} ms/hop), {realtime:.1f} streams realtime, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {launches}, {spectra} spectrum snapshots, {int(locked)} locked "
        f"stream-hops of {s * TIMED_HOPS} [{card_line()}]"
    )
    want = {"reassigned_sliding_hop": TIMED_HOPS, "corr_dots_sums_ring": TIMED_HOPS,
            "window_rows": 2 * TIMED_HOPS, "sliding_hop_spectra": expect_b1b, "sliding_hop": 0,
            # the waveform's crossover; the default stereometer runs no bands
            "three_band_scan": TIMED_HOPS}
    check(launches == want, f"launches {launches}, want {want}")
    check(spectra == TIMED_HOPS // r, f"{spectra} spectrum snapshots, want {TIMED_HOPS // r}")
    check(bool(torch.isfinite(sink)), "non-finite output")
    check(int(locked) > s * TIMED_HOPS // 2, f"only {int(locked)} locked stream-hops")
    check(bool(snaps["spectrum"].updated.all()), "the last spectrum hop made no column")
    check(bool(snaps["waveform"].col_valid.any()), "no waveform column")
    check(bool(snaps["stereometer"].points_valid.all()), "stereometer points not valid")
    lo = snaps["loudness"]
    check(bool((lo.integrated_lufs > engine.config.loudness.floor_db).all()), "integrated loudness at the floor")
    profile_hops(label, session, blocks, consume, ms)
    del session
    torch.cuda.empty_cache()
    alone = analyzer_breakdown(label, dev, cfg, blocks, breakdown)
    result = {"ms_per_hop": ms, "launches": launches, "peak_gib": peak / 2**30, "alone": alone}
    del blocks
    torch.cuda.empty_cache()
    return result


# -- the serving loop ------------------------------------------------------------


def serve_audio(s: int, n: int, seed: int) -> np.ndarray:
    """``[s, n, 2]`` PCM for the serving phases: a tone a stream (40 Hz to
    4 kHz) with a second on the right, a glide (100 Hz to 4 kHz) in stream
    1, faint noise, and NaN samples in stream 2 from frame 7000."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48_000.0
    f = np.exp(rng.uniform(np.log(40.0), np.log(4000.0), (s, 1)))
    phase = 2 * np.pi * f * t
    phase[1] = 2 * np.pi * (100.0 * t + 0.5 * (3900.0 / t[-1]) * t * t)
    amp = rng.uniform(0.05, 0.4, (s, 1))
    left = amp * np.sin(phase) + 0.01 * rng.standard_normal((s, n))
    right = 0.5 * left + 0.1 * np.sin(1.7 * phase)
    audio = np.stack([left, right], -1).astype(np.float32)
    audio[2, 7000:7003] = np.nan
    return audio


def push_block(servers, audio: np.ndarray, i: int, b: int = 256) -> None:
    ts = int(i * b / 48_000.0 * 1e9)
    for srv in servers:
        for st in range(audio.shape[0]):
            srv.transport.push_pcm(st, audio[st, i * b : (i + 1) * b], ts)


def _max_diff(a, b) -> float:
    """Largest |a - b| where both are finite; inf if their non-finite
    entries differ."""
    a, b = torch.as_tensor(np.asarray(a, np.float64)), torch.as_tensor(np.asarray(b, np.float64))
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return math.inf
    both = torch.isfinite(a)
    return float(torch.where(both, (a - b).abs(), 0.0).max()) if a.numel() else 0.0


def phase19_serving_card_vs_cpu(dev, s: int = 8, advances: int = 150) -> None:
    """``MeterServer`` on the card against one on the CPU: the literal
    ``EngineConfig()`` at the transport's 2 channels, ``fetch="full"``, the
    same pushed PCM; a generation reset on streams 3 and 5 at advance 40; at
    advance 60 an ``apply_settings_async`` (loudness floor, oscilloscope
    cadence, spectrum averaging) joined and adopted on the next advance; at
    advance 100 a checkpoint that a fresh card server restores, both then
    running to the end.  Every advance: ``last_meters()``, and from advance
    60 on every fourth ``fetch_spectrum()`` and ``fetch_osc_traces()``,
    card against CPU by the bars of ``utils/parity.py``; the restored server
    against the uninterrupted one."""
    from openmeters_tpu_torch.analyzers.spectrum import AveragingMode
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.utils.parity import (
        check_meters,
        check_oscilloscope,
        check_spectrum,
        oscilloscope_errors,
        spectrum_errors,
    )

    base = EngineConfig()
    cfg = ServeConfig(n_streams=s, channels=2, engine=base, realtime=False, fetch="full", fetch_every=1,
                      coalesce_blocks=1)
    new = dataclasses.replace(
        base,
        loudness=dataclasses.replace(base.loudness, floor_db=-80.0),
        oscilloscope=dataclasses.replace(base.oscilloscope, trigger_every=2),
        spectrum=dataclasses.replace(base.spectrum, averaging=AveragingMode.EXPONENTIAL),
    )
    t0 = time.perf_counter()
    card, cpu = MeterServer(cfg, device=dev), MeterServer(cfg, device="cpu")
    audio = serve_audio(s, advances * 256, SEED + 19)
    servers = [card, cpu]
    restored = None
    worst: dict = {}
    spectra = traces = 0
    ckpt = OUT_DIR / "phase19_carry.npz"
    OUT_DIR.mkdir(exist_ok=True)
    restore_diff, restore_at = {}, {}
    for i in range(advances):
        if i == 40:
            for srv in servers:
                for st in (3, 5):
                    srv.transport.set_generation(st, 2)
        if i == 60:
            for t in [srv.apply_settings_async(new) for srv in servers]:
                t.join(timeout=300)
                check(not t.is_alive(), "the background warm-up did not finish")
            check(all(srv.reconfig_pending for srv in servers), "the swap is not staged")
        if i == 100:
            card.checkpoint(str(ckpt))
            restored = MeterServer(dataclasses.replace(cfg, engine=new), device=dev)
            restored.restore(str(ckpt))
            servers = [card, cpu, restored]
        push_block(servers, audio, i)
        for srv in servers:
            srv.advance()
        if i == 60:
            check(card.engine.config.loudness.floor_db == -80.0 and not card.reconfig_pending,
                  "the staged swap was not adopted")
        err = check_meters(card.last_meters(), cpu.last_meters(), f"phase 19 advance {i}")
        for name, e in err.items():
            for k, v in e.items():
                if isinstance(v, (int, float)):
                    worst[f"{name}.{k}"] = max(worst.get(f"{name}.{k}", 0.0), v)
        if i >= 60 and i % 4 == 3:
            check_spectrum(spectrum_errors(None, None, card.fetch_spectrum(), cpu.fetch_spectrum()),
                           f"phase 19 spectrum advance {i}")
            check_oscilloscope(oscilloscope_errors(card.fetch_osc_traces(), cpu.fetch_osc_traces()),
                               f"phase 19 traces advance {i}")
            spectra += 1
            traces += 1
        if restored is not None:
            a, b = card.last_meters(), restored.last_meters()
            check(set(a) == set(b), "the restored server's meters differ in keys")
            pairs = [(k, a[k], b[k]) for k in a]
            if i % 4 == 3:
                for name, x, y in (("spectrum", card.fetch_spectrum(), restored.fetch_spectrum()),
                                   ("traces", card.fetch_osc_traces(), restored.fetch_osc_traces())):
                    pairs += [(f"{name}.{f}", getattr(x, f), getattr(y, f)) for f in x._fields]
            for k, x, y in pairs:
                d = _max_diff(x, y)
                restore_diff[k] = max(restore_diff.get(k, 0.0), d)
                if d:
                    restore_at.setdefault(k, []).append(i)
    resets = [srv.stats.resets for srv in (card, cpu)]
    for srv in (card, cpu, restored):
        srv.close()
    check(resets[0] == resets[1] == s + 2, f"resets {resets}, want {s + 2}")
    check(all(math.isfinite(v) for v in restore_diff.values()), "the restored server's non-finite entries differ")
    bit_equal = all(v == 0.0 for v in restore_diff.values())
    log(
        f"phase 19 MeterServer card vs cpu, literal EngineConfig() at 2 channels, S={s}, {advances} advances "
        f"in {time.perf_counter() - t0:.1f} s: meters, {spectra} spectra and {traces} trace fetches within the "
        f"bars; resets {resets[0]}; the async swap adopted at advance 60; worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()) if v) + f" [{card_line()}]"
    )
    nonzero = {k: v for k, v in restore_diff.items() if v}
    log(
        f"phase 19 restored (checkpoint at advance 100) against uninterrupted, {advances - 100} advances on the "
        "card: " + ("bit-equal in every fetched meter, spectrum and trace field" if bit_equal else
                    "not bit-equal; max |d| (at advances): " + ", ".join(
                        f"{k} {v:.3e} ({restore_at[k][0]}-{restore_at[k][-1]}, {len(restore_at[k])} advances)"
                        for k, v in sorted(nonzero.items())))
        + "; a restore re-emits the held spectrum snapshot from the carry, not updated until the next "
        "spectrum hop, as the JAX package's does"
    )


def phase20_serving_s8192(dev, label: str, engine_cfg, expect: tuple) -> dict:
    """``MeterServer`` at S=8192 stereo streams on the card, ``fetch="meters"``
    every sixth hop, with the C++ ``Feeder`` (4 threads) pushing flat out
    under backpressure: 40 warm-up advances, then 200 timed (the clock
    stopped after ``close()`` has drained every fetch), counting the
    launches of ``expect``'s kernels, then a 20-advance profile."""
    from openmeters_tpu_torch.ingest import Feeder
    from openmeters_tpu_torch.ops.corr import corr_dots_sums_ring
    from openmeters_tpu_torch.ops.iir import three_band_scan
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.ops.rows import window_rows
    from openmeters_tpu_torch.ops.sliding_hop import sliding_hop
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.tracing import EngineStats

    s, advances, warmup = FLAGSHIP_S, TIMED_HOPS, 40
    cfg = ServeConfig(n_streams=s, channels=2, engine=engine_cfg, realtime=False, fetch="meters", fetch_every=6)
    ring_bytes = s * cfg.channels * int(cfg.ring_seconds * 48_000.0) * 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = MeterServer(cfg, device=dev)
    built = time.perf_counter() - t0
    feeder = Feeder(server.transport, realtime=False, n_threads=4,
                    max_buffered_frames=int(cfg.ring_seconds * 48_000.0) // 2)
    try:
        for _ in range(warmup):
            server.advance()
        while server._inflight:  # noqa: SLF001
            server._drain_one()  # noqa: SLF001
        torch.cuda.synchronize()
        server.stats, server.latencies_ms = EngineStats(), []
        server.host_seconds = dict.fromkeys(server.host_seconds, 0.0)
        counters = {c.__name__: c for c in (sliding_hop, reassigned_sliding_hop, corr_dots_sums_ring,
                                            window_rows, three_band_scan)}
        for c in counters.values():
            c.launches = 0
        t1 = time.perf_counter()
        for _ in range(advances):
            server.advance()
        server.close()
        wall = time.perf_counter() - t1
        launches = {name: c.launches for name, c in counters.items()}
        server.stats.wall_seconds = wall
        report = server.report()
        host = {k: 1e3 * v / advances for k, v in server.host_seconds.items()}
        busy_ms, table = profiled(lambda i: server.advance(), 20)
        server.close()
    finally:
        ok, failed = feeder.stop()
    peak = torch.cuda.max_memory_allocated()
    hops_per_advance = report["hops"] / advances
    ms_per_advance = 1e3 * wall / advances
    (OUT_DIR / f"chip_smoke_profile_{label.replace(' ', '')}.txt").write_text(table)
    log(
        f"{label} MeterServer S={s} stereo, fetch meters every 6th hop, Feeder 4 threads flat out: built and "
        f"warmed in {built:.1f} s; {advances} advances ({report['hops']} hops, {hops_per_advance:.2f} a "
        f"advance) in {wall:.3f} s: report {json.dumps(report)}; host ms per advance: assemble "
        f"{host['assemble']:.4f}, H2D enqueue {host['h2d']:.4f}, step enqueue {host['step']:.4f}, drain "
        f"{host['drain']:.4f} (wall {ms_per_advance:.4f}); device kernel time {busy_ms:.4f} ms per advance "
        f"over a 20-advance profile: busy {100 * busy_ms / ms_per_advance:.1f} % of the timed advance; peak "
        f"device memory {peak / 2**30:.3f} GiB; transport ring {ring_bytes / 1e9:.3f} GB of host memory "
        f"(S x 2 ch x {int(cfg.ring_seconds * 48_000.0)} frames x 4 B); pushes ok {ok}, refused {failed}; "
        f"launches {launches} [{card_line()}]"
    )
    check(report["latency_ms_p50"] is not None, "no fetch drained")
    check(report["hops"] >= advances, f"{report['hops']} hops in {advances} advances")
    for name in expect:
        check(launches[name] > 0, f"{label}: {name} never launched")
    return {"report": report, "host_ms": host, "busy_ms": busy_ms, "wall_ms": ms_per_advance,
            "launches": launches}


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
        if any(w in line for w in ("entry function", "registers", "spill", "smem")):
            log("  ptxas: " + line.strip())
    for name, ops in tensor_core_sass(_build.library_path()).items():
        log(f"phase 2 {name}: tensor-core instructions {', '.join(ops)} in its SASS")

    kernel = phase3_kernel(dev)
    phase4_slice(dev)
    launches = phase5_flagship(dev)
    hop_kernel = phase6_reassigned_hop(dev)
    col_kernel = phase7_reassigned_columns(dev)
    phase8_reassigned_slice(dev)
    hop_launches, col_launches = phase9_reassigned_s8192(dev)
    corr_kernels = phase10_corr(dev)
    rows_kernel = phase11_rows(dev)
    phase12_osc_slice(dev)
    osc_launches = phase13_default_s8192(dev)["launches"]
    spectra_kernel = phase14_sliding_spectra(dev)
    band_kernel = phase15_three_band(dev)
    phase16_spectrum_slice(dev)
    phase17_stereo_waveform(dev)

    from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig

    stock = phase18_literal_default(dev, "phase 18a")["launches"]
    sliding = phase18_literal_default(dev, "phase 18b", SpectrumConfig(hop_size=512), TIMED_HOPS // 2,
                                      breakdown=("spectrum",))["launches"]

    from openmeters_tpu_torch.engine import EngineConfig

    phase19_serving_card_vs_cpu(dev)
    phase20_serving_s8192(dev, "phase 20a", EngineConfig(),
                          ("reassigned_sliding_hop", "corr_dots_sums_ring", "window_rows", "three_band_scan"))
    torch.cuda.empty_cache()
    phase20_serving_s8192(dev, "phase 20b", flagship_config(), ("sliding_hop",))

    def entry(name, source, replaces, n, k):
        extra = ("bound_f32_ms", "bound_tf32_ms", "bound_bytes_ms")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            **{key: k[key] for key in extra if key in k},
        }

    corr_src = "openmeters_tpu_torch/csrc/corr_search.cu"
    print(json.dumps({
        "kernels": [
            entry("sliding_hop", "openmeters_tpu_torch/csrc/sliding_hop_deltas.cu",
                  "openmeters_tpu/ops/pallas_sliding.py:381", launches, kernel),
            entry("reassigned_sliding_hop", "openmeters_tpu_torch/csrc/reassigned_hop.cu",
                  "openmeters_tpu/ops/pallas_sliding_reassigned.py:229", hop_launches, hop_kernel),
            entry("reassigned_columns", "openmeters_tpu_torch/csrc/reassigned_columns.cu",
                  "openmeters_tpu/ops/pallas_reassigned.py:363", col_launches, col_kernel),
            entry("corr_dots_sums_ring", corr_src, "openmeters_tpu/ops/pallas_corr.py:524",
                  osc_launches["corr_dots_sums_ring"], corr_kernels["corr_dots_sums_ring"]),
            # no engine path calls these two: the JAX package uses them in tests and tools only
            entry("corr_dots_sums", corr_src, "openmeters_tpu/ops/pallas_corr.py:451", 0,
                  corr_kernels["corr_dots_sums"]),
            entry("corr_dots", corr_src, "openmeters_tpu/ops/pallas_corr.py:579", 0,
                  corr_kernels["corr_dots"]),
            entry("window_rows", "openmeters_tpu_torch/csrc/window_rows.cu",
                  "openmeters_tpu/ops/pallas_rows.py:117", osc_launches["window_rows"], rows_kernel),
            entry("sliding_hop_spectra", "openmeters_tpu_torch/csrc/sliding_hop.cu",
                  "openmeters_tpu/ops/pallas_sliding.py:514", sliding["sliding_hop_spectra"], spectra_kernel),
            # no pallas_call: the JAX package runs this recurrence as a lax.scan
            entry("three_band", "openmeters_tpu_torch/csrc/three_band.cu",
                  "openmeters_tpu/ops/iir.py:154", stock["three_band_scan"], band_kernel),
        ],
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
