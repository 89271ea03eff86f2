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
   card tensors, at the flagship's former shape (2048/64, S=8192) and a
   small Blackman-Harris shape, for ready in {0, 1, cols}, plus both
   versions' times at the first; (3b) the ``classic_columns`` kernel, the
   flagship's spectrogram, against its plain version in float64 from the
   same ring at the flagship shape, 64/16 Blackman-Harris and 32768/1024,
   plus the kernel's, the plain version's and the f32 ``torch.fft``
   chain's times at the flagship shape; (3c) the ``ring_gather`` kernel on
   one hop of a registered transport at S=8192, 256 x 2 (rows in one ring
   segment, across the ring's end, staged and zero) bit for bit against
   its plain version, plus the kernel's, the plain version's and the H2D
   copy of a pinned batch's times, and the seconds to register the rings;
   with the served 64,000-frame rings, then 4,800-frame ones;
4. the flagship engine through the public API on the card against the
   same on the CPU (S=32, 200 hops, two streams reset at hop 90);
5. the flagship engine at S=8192 stereo streams: 40 warm-up hops, then 200
   timed hops with every output consumed, counting kernel launches (one
   ``classic_columns`` a hop, no ``sliding_hop``), and a profile of 20
   more;
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
    with NaN and infinite samples, both cascade settings, bit-exact, at the
    blocks of 48, 44.1, 96 and 192 kHz (``[256, 8192, 2]``, ``[235, 8192,
    2]``, ``[512, 4096, 2]``, ``[1024, 2048, 2]``), plus the times (the
    kernel as a CUDA graph of 200 launches), the byte bound and the serial
    chain's floor (from the instructions a sample its SASS issues, at the
    card's highest SM clock);
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
    flagship (20b); 20 warm-up advances, 200 timed to the last drained
    fetch: ``report()``, host ms per advance by stage, the device's busy
    share from a 10-advance profile, peak device memory, the transport's
    host bytes, and the launches of the path's kernels (each must launch;
    ``ring_gather`` once a hop and shard).
21. the CLI on the card, in this process through
    ``openmeters_tpu_torch.__main__.main``: (a) ``serve --socket PATH
    --rates 44100,48000 --streams 4096`` with the flagship in a settings
    file it watches, 128 producer links in real time (96 at 48 kHz, 32 at
    44.1 kHz: a helper subprocess of ``ProducerClient``s and four
    ``python -m openmeters_tpu_torch.ingest.producer`` processes, one with
    a timeline gap, one with a format switch) and two steady -6 dBFS
    997 Hz links under backpressure, the file rewritten halfway to turn
    reassignment on: every link in the report, B1a launched in both
    buckets, B2 after the swap, and each steady link's served momentary
    LUFS (the newest drain whose window held its tone whole) within 0.01
    LU of the same tone analyzed on the CPU at its rate; the report, host
    ms a hop by stage, the device's busy share over the serve loop and
    peak memory are printed; (b) ``analyze`` of a 3 s stereo WAV under
    ``EngineConfig()`` with the spectrum at hop 512, on the card against
    ``--device cpu`` within ``check_analyze``'s bars, B1b, B2, B4, B7 and
    ``three_band`` each launched; (c) ``selftest``, ``precompile`` and
    ``settings --init``;
22. the display layers on the card: (a) ``render`` of a 3 s stereo WAV at
    48 kHz under the literal ``EngineConfig()`` (B2, B4, B7 and
    ``three_band`` launched) and at 44.1 kHz under
    ``EngineConfig.at_rate(44100)`` (235-frame blocks: B3, B4, B7 and
    ``three_band``), 960 x 540, every pane decoded and held against
    ``--device cpu``'s by the pixel bar of ``utils/parity.py``; (b) the TUI
    and the PNG consumer on the served literal default at S=8192 (as 20a)
    for 10 s, the meter-mode panes (loudness, correlation, spectrum,
    oscilloscope) written, ``report()`` beside 20a's; (c) the same with
    ``fetch="full"`` at S=256: every pane written, and keys on a pipe
    (``2`` toggles the spectrogram off and back, each swap warmed while
    serving and adopted at an advance's start; ``p`` pauses and resumes;
    ``q`` stops ``run()``);
23. the stream mesh (``engine/sharding.py``): (a) the flagship at S=8192
    through ``sharded_step`` over ``make_mesh()`` (every card of the
    machine) against the unsharded step on the card, 200 hops with resets
    at hops 60 and 140, held by the bars of ``utils/parity.py``, the
    bit-equal leaves counted, B1a launched once a shard a hop; (b) the
    literal ``EngineConfig()`` at two channels, S=64 over the two-shard
    one-card mesh ``StreamMesh([cuda:0, cuda:0])``, 150 hops of phase 12's
    and phase 16's audio with two streams of shard 1 reset at hop 90,
    against the unsharded step on the card and the same two shards on the
    CPU (stepped each hop from the card shards' state) by the bars, every
    replicated host scalar equal across the shards
    and to the unsharded carry's at every hop, B2, B4, B7 and
    ``three_band`` each launched once a shard a hop; then ``gather_carry``
    -> ``save_state`` -> ``load_state`` onto a one-shard mesh, 30 hops on
    against the uninterrupted two shards; (c) ``MeterServer`` at S=8192
    over the two-shard one-card mesh, the literal default and the flagship
    as 20a and 20b, 100 timed advances (report, host ms by stage, busy
    share, peak memory, launches) beside 20a's and 20b's of this run, and
    the server's
    leaf-by-leaf join of the shards' meter vectors against
    ``join_by_leaf``'s;
24. long runs, (b) in two processes of their own started after 23c,
    beside 23a, 23b and (a) (23c runs first of phase 23): (a)
    the drift of the free-running reassigned default
    (loudness + ``SpectrogramConfig()``, 2 channels) at S=256 over 640
    hops of tones (40 Hz to 8 kHz), tones with noise and tones with level
    steps: the card (B2) and the hop's f32 plain version on the card, each
    against the port's CPU path (its float64 plain hop), the time error as
    a multiple of ``DRIFT_TIME_HOPS`` by band (largest, 99.9th percentile,
    the bins over 1.0 and where they lie), the card held within the bar or
    1.5 times the f32 plain version's own distance
    (``utils/parity.py::check_near_reference``); (b) the flagship (B1a) and the
    reassigned default (B2) at S=64 for 65,700 hops each (16,819,200
    samples, past 2^24) of programme audio made on the card (tones, noise,
    both; levels stepping 6 to 20 dB every 1.6 s, some sections below -70
    LUFS), steps chained with every snapshot leaf folded into a checksum on
    the card and no synchronizing call between the checks; every 4,096
    hops, on the hop before a re-anchor and on the re-anchor hop, the last
    column against its exact recompute from the rings (float64 rFFTs on the
    host), within the phase-4 and phase-8 bars or 1.5 times the hop's f32
    plain version's own distance from it (stepped on the card from the
    card's carry through the re-anchor); the last 200 hops card against CPU
    stepped each hop from the card's carry (the reassigned columns within
    the bars or 1.5 times the f32 plain hop's distance); four streams'
    integrated loudness and LRA against ``tests/ebur_ref.py`` within 0.02
    and 0.2 LU.

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

import collections
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import threading
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


STARTED = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - STARTED:7.1f} s] {msg}", flush=True)


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


def tensor_core_sass() -> dict:
    """``{kernel: tensor-core opcodes}`` from ``cuobjdump -sass`` of the
    built library, for each of ``TENSOR_CORE_KERNELS`` (every instance of a
    template); fails if one shows none."""
    from openmeters_tpu_torch.ops import _build

    found = {}
    for kernel in TENSOR_CORE_KERNELS:
        for name, instrs in _build.kernel_sass(kernel).items():
            ops = {w.split(".")[0] for _, text in instrs for w in text.split() if w.startswith(("HGMMA", "HMMA"))}
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


def phase3b_classic_columns(dev) -> dict:
    """The ``classic_columns`` kernel against its plain version in float64
    (the per-column chain on the frames ``FrameBuffer.extract`` takes from
    the same ring) for ready in {0, 1, cols}: at the flagship shape (S=8192,
    2048/64, 4 columns, Hann), 64/16 Blackman-Harris and 32768/1024; the
    ring holds noise 80 dB down with a loud stretch at 0 dBFS, so some
    windows hold its tail.  Codes within 2 at bins within 60 dB of the
    column's peak; at the flagship shape the kernel, the plain version and
    the f32 ``torch.fft`` chain (the library call) timed, with the bound."""
    from openmeters_tpu_torch.ops.classic_columns import classic_columns, classic_columns_reference
    from openmeters_tpu_torch.ops.framing import FrameBuffer
    from openmeters_tpu_torch.utils.level import DB_FLOOR
    from openmeters_tpu_torch.utils.windows import WindowKind, fft_bin_normalization, window_coefficients

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    result = {}
    for label, n, hop, kind, s in (("flagship", 2048, 64, WindowKind.HANN, FLAGSHIP_S),
                                   ("64/16 blackman-harris", 64, 16, WindowKind.BLACKMAN_HARRIS, 37),
                                   ("32768/1024", 32768, 1024, WindowKind.HANN, 12)):
        fb = FrameBuffer(n, hop, 256)
        cols = fb.cols_cap
        buf = torch.randn((s, fb.ring_len), generator=gen, device=dev) * 1e-4
        loud = slice(fb.cap - n // 2, fb.cap - n // 4)
        buf[:, loud] = torch.randn((s, n // 4), generator=gen, device=dev)
        window = torch.from_numpy(window_coefficients(kind, n)).to(dev)
        norm = torch.from_numpy(fft_bin_normalization(window_coefficients(kind, n), n)).to(dev)
        for ready in sorted({0, 1, cols}):
            info = {"buf": buf, "base": fb.cap - n, "ready": ready}
            got = classic_columns(fb, info, window, norm, floor_db=DB_FLOOR)
            ref = classic_columns_reference(fb.extract(info).double(), window.double(), norm.double(),
                                            floor_db=DB_FLOOR).to(torch.int32)
            d = (got.to(torch.int32) - ref).abs()
            held = resolved_bins(ref, torch.ones(ref.shape[:2], dtype=torch.bool, device=dev))
            code_diff = int((d * held).max())
            log(f"phase 3b {label} S={s} cols={cols} ready={ready}: codes max diff {code_diff} within "
                f"{RESOLVED_DB:g} dB of the column peak against float64 ({int(d.max())} over all bins)")
            check(code_diff <= 2, f"phase 3b {label} ready={ready}: codes differ by {code_diff}")
            if label == "flagship" and ready == cols:
                result = {"max_abs_err": float(code_diff), "max_code_diff": code_diff}
        if label == "flagship":
            info = {"buf": buf, "base": fb.cap - n, "ready": cols}
            reps = 20
            kern = lambda: classic_columns(fb, info, window, norm, floor_db=DB_FLOOR)  # noqa: E731, B023
            plain = lambda: classic_columns_reference(  # noqa: E731
                fb.extract(info).double(), window.double(), norm.double(), floor_db=DB_FLOOR)  # noqa: B023
            p1, k1, k2, p2 = (time_cuda(f, reps) for f in (plain, kern, kern, plain))
            result["ms"], result["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
            result["library_ms"] = time_cuda(
                lambda: classic_columns_reference(fb.extract(info), window, norm, floor_db=DB_FLOOR), reps)  # noqa: B023
            bins = n // 2 + 1
            moved = s * (n + (cols - 1) * hop) * 4 + s * cols * bins * 2 + n * 4 + bins * 4
            result.update(bound(moved, fft_flops(n // 2, s * cols)))
            log(f"phase 3b timing at S={s}: kernel {k1:.4f}/{k2:.4f} ms, plain (float64) {p1:.4f}/{p2:.4f} ms, "
                f"the f32 torch.fft chain {result['library_ms']:.4f} ms, {fmt_bound(result)} [{card_line()}]")
    return result


def timed_on(stream, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` issued on ``stream``, by CUDA events."""
    with torch.cuda.stream(stream):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            fn()
        stop.record(stream)
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def phase3c_ring_gather(dev) -> dict:
    """The ``ring_gather`` kernel on one hop of a registered transport at
    the served shape (S=8192, 256 frames, 2 channels), drained by the
    descriptor pass with rows of every kind (one ring segment, across the
    ring's end, staged, zero); the kernel's block bit for bit the plain
    gather's.  Then, on a copy stream, the kernel, the plain version (its
    index gather on the host into the card's block) and the H2D copy of
    the plain gather's batch from pinned memory (``library_ms``: the copy
    the gather replaced) timed; the bound is the hop's samples and
    descriptors over the copy engine's rate measured here.  Rings of the
    served 64,000 frames (a 4.19 GB arena: the result), then of 4,800
    (0.31 GB), to tell the arena's size from the bytes."""
    result = {}
    for cap in (64_000, 4_800):
        got = _ring_gather_hop(dev, cap)
        result = result or got
    return result


def _ring_gather_hop(dev, cap: int) -> dict:
    from openmeters_tpu_torch.ingest import Transport
    from openmeters_tpu_torch.ingest.transport import ROW_KINDS
    from openmeters_tpu_torch.ops.ring_gather import mapped_addresses, ring_gather, ring_gather_reference

    s, b, c, rate = FLAGSHIP_S, 256, 2, 48_000.0
    ns = lambda frames: int(frames / rate * 1e9)  # noqa: E731
    tp = Transport(s, c, b, rate, ring_seconds=cap / rate)
    rng = np.random.default_rng(SEED + 30)
    audio = rng.standard_normal((s, 2 * b, c)).astype(np.float32)
    kind = np.arange(s) % 16  # 0: idle (zero row); 1: a gap inside the hop (staged); 2-4: across the end
    pre = np.where((kind >= 2) & (kind <= 4), cap - 2 - rng.integers(0, b - 3, s), 0)
    filler = np.zeros((cap, c), np.float32)
    for st in np.flatnonzero(pre):
        tp.push_pcm(int(st), filler[: pre[st]], 0)
        tp.push_fault(int(st))
    discard = tp.make_desc_buffers()
    for _ in range(2):  # the faults discard the filler, then its space comes back:
        tp.assemble_desc(discard, 1)  # these rings' next rows start near their ends
    for st in range(s):
        if kind[st] == 1:
            tp.push_pcm(st, audio[st, :100], 0)
            tp.push_pcm(st, audio[st, 100:256], ns(150))
        elif kind[st] != 0:
            n = b + 64 * (st % 3)
            tp.push_pcm(st, audio[st, :n], ns(pre[st]))
    bufs = tp.make_desc_buffers(pin_memory=True)
    before = tp.ingest_rows.copy()
    tp.assemble_desc(bufs, 0)
    rows = dict(zip(ROW_KINDS, (tp.ingest_rows - before).tolist()))
    check(min(rows.values()) > 0, f"phase 3c: a row kind is missing: {rows}")
    t0 = time.perf_counter()
    tp.pin_arena([dev])
    register_s = time.perf_counter() - t0
    try:
        arena = tp.arena_tensor()
        staging, desc = torch.from_numpy(bufs[0]), torch.from_numpy(bufs[3])
        mapped = mapped_addresses(arena, staging, desc)
        plain = ring_gather_reference(arena, staging, desc, torch.empty((s, b, c)))
        out = torch.full((s, b, c), float("nan"), device=dev)
        copy = torch.cuda.Stream(dev)
        with torch.cuda.stream(copy):
            ring_gather(arena, staging, desc, out, mapped=mapped)
        copy.synchronize()
        got = out.cpu()
        check(torch.equal(got.view(torch.int32), plain.view(torch.int32)), "phase 3c: kernel != plain gather")
        err = float((got - plain).abs().max())
        pinned = plain.pin_memory()
        kern = lambda: ring_gather(arena, staging, desc, out, mapped=mapped)  # noqa: E731
        lib = lambda: out.copy_(pinned, non_blocking=True)  # noqa: E731
        ref = lambda: ring_gather_reference(arena, staging, desc, out)  # noqa: E731
        p1, k1, l1, l2, k2, p2 = (timed_on(copy, f, r) for f, r in ((ref, 3), (kern, 50), (lib, 50),
                                                                     (lib, 50), (kern, 50), (ref, 3)))
    finally:
        tp.unpin_arena()
    samples = s * b * c * 4
    link = samples / ((l1 + l2) / 2) / 1e6  # GB/s
    result = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": (l1 + l2) / 2,
              "bound_ms": (samples + s * 32) / link / 1e6, "bound_by": "host link (the copy engine's rate)",
              "rows": rows, "register_s": register_s, "ring_frames": cap}
    log(f"phase 3c ring_gather S={s} {b}x{c}, {cap}-frame rings ({arena.numel() * 4 / 1e9:.3f} GB arena), rows "
        f"{json.dumps(rows)}: bit-equal to the plain gather; kernel {k1:.4f}/{k2:.4f} ms "
        f"({samples / k1 / 1e6:.1f}/{samples / k2 / 1e6:.1f} GB/s), plain {p1:.4f}/{p2:.4f} ms, H2D copy of the "
        f"pinned batch {l1:.4f}/{l2:.4f} ms ({link:.1f} GB/s); bound {result['bound_ms']:.4f} ms "
        f"({samples + s * 32} B at {link:.1f} GB/s); registering the arena {register_s:.3f} s [{card_line()}]")
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


def phase5_flagship(dev) -> dict:
    from openmeters_tpu_torch.api import AnalysisSession
    from openmeters_tpu_torch.engine import MeterEngine
    from openmeters_tpu_torch.ops.classic_columns import classic_columns
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

    sliding_hop.launches = classic_columns.launches = 0
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
    launches = {"classic_columns": classic_columns.launches, "sliding_hop": sliding_hop.launches}

    ms = start.elapsed_time(stop) / TIMED_HOPS
    realtime = s * (b / 48_000.0) / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated()
    card = card_line()
    log(
        f"phase 5 flagship S={s}: {ms:.4f} ms/hop (CUDA events; host wall {1e3 * wall / TIMED_HOPS:.4f} ms/hop), "
        f"{realtime:.1f} streams realtime, peak memory {peak / 2**30:.3f} GiB [{card}]"
    )
    check(launches == {"classic_columns": TIMED_HOPS, "sliding_hop": 0}, f"launches in {TIMED_HOPS} hops: {launches}")
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
    of the kernels under them again, as the device-side copies of the
    program's spans, ``gpu_user_annotation``, carry the time of the kernels
    each span launched), and the table of time by name.  A profile that
    records no device time fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(hops):
            run_hop(i)
        torch.cuda.synchronize()
    busy_us = sum(
        getattr(e, "device_time_total", 0.0)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
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


# the crossover's shapes: (frames a block, streams) at 48, 44.1, 96 and 192 kHz, two channels a stream
THREE_BAND_SHAPES = ((256, FLAGSHIP_S, 48_000.0), (235, FLAGSHIP_S, 44_100.0), (512, 4096, 96_000.0),
                     (1024, 2048, 192_000.0))


def time_graph(fn, reps: int) -> float:
    """Mean ms per call of ``reps`` calls captured in one CUDA graph and
    replayed, by CUDA events: the device's time without the host's issue,
    for kernels shorter than their wrapper's Python."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def max_sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


_BRANCH = re.compile(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?(0x[0-9a-f]+)")


def sass_loops(instrs: list[tuple[int, str]], op: str) -> list[collections.Counter]:
    """The loops of one function's SASS (``_build.kernel_sass``) that run
    ``op``: for each branch back to an earlier address, the opcodes from
    there to the branch, counted by name without modifiers (``FMUL``,
    ``LDS``, ``BRA``).  A span with an ``EXIT`` in it is no loop: the
    compiler puts a wait's retry after the function's exits, from where it
    branches back into the body."""
    loops = []
    for addr, text in instrs:
        target = _BRANCH.search(text)
        if target and int(target.group(1), 16) <= addr:
            start = int(target.group(1), 16)
            ops = collections.Counter(_opcode(t) for a, t in instrs if start <= a <= addr)
            del ops["NOP"]
            if ops[op] and not ops["EXIT"]:
                loops.append(ops)
    return loops


def _opcode(text: str) -> str:
    words = text.split()
    return (words[1] if words[0].startswith("@") else words[0]).split(".")[0]


def three_band_issue(lib_path=None) -> dict:
    """The crossover kernel's issue cost, read from its SASS in the built
    library (or ``lib_path``): ``{(cascade_n, high_from_al): [instructions a
    sample of each warp that runs a share of a lane's filters]}``.  Those
    warps' sample loops are the loops that hold the most ``FMUL`` (a
    block's tail loops hold fewer), and a lane's sample takes five products
    for each of its ``4 cascade_n`` biquads, split evenly over them."""
    from openmeters_tpu_torch.ops._build import kernel_sass

    out = {}
    for symbol, lines in kernel_sass("three_band_kernel", lib_path).items():
        cn, high = re.search(r"three_band_kernelILi(\d+)ELb(\d)E", symbol).groups()
        loops = sass_loops(lines, "FMUL")
        if not loops:
            raise RuntimeError(f"{symbol}: no loop with FMUL in its SASS")
        chain = [c for c in loops if c["FMUL"] == max(c["FMUL"] for c in loops)]
        products = 20 * int(cn) / len(chain)  # a sample's products on one warp
        out[(int(cn), high == "1")] = [sum(c.values()) * products / c["FMUL"] for c in chain]
    return out


def three_band_chain_floor_ms(t: int, lanes: int, per_sample, clock_mhz: float, sms: int) -> float:
    """The least time the crossover's serial chains could take at ``t``
    samples and ``lanes`` lanes, from :func:`three_band_issue`'s
    ``per_sample``: a warp issues at most one instruction a cycle, so a
    lane's samples take ``t`` times the largest per-warp count; and an SM's
    four schedulers issue at most four a cycle for the tiles of 32 lanes it
    holds (``ceil(tiles / sms)``).  A model at the card's highest clock,
    not a measurement: it is logged, and kept out of the ``kernels`` line."""
    tiles = -(-lanes // 32)
    cycles = max(t * max(per_sample), -(-tiles // sms) * t * sum(per_sample) / 4)
    return cycles / (clock_mhz * 1e3)


def phase15_three_band(dev) -> dict:
    from openmeters_tpu_torch.ops.iir import three_band_init, three_band_scan, three_band_scan_reference

    issue, clock = three_band_issue(), max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (cn, high), per_sample in sorted(issue.items()):
        log(f"phase 15 three_band_kernel<{cn}, {str(high).lower()}>: {len(per_sample)} chain warps a lane, "
            f"{', '.join(f'{n:.1f}' for n in per_sample)} SASS instructions a sample; max SM clock {clock:.0f} MHz, "
            f"{sms} SMs")
    card, shapes, result = card_line(), {}, {}
    for b, s, rate in THREE_BAND_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 15)
        clean = torch.randn((b, s, 2), generator=gen, device=dev) * 0.3
        x = torch.randn((b, s, 2), generator=gen, device=dev) * 0.3
        # on both sides of the first chunk boundary (16 samples), the last sample, the last lane, a whole lane
        x[15, 1, 0], x[16, 2, 1], x[b - 1, 3, 0] = float("nan"), float("inf"), float("-inf")
        x[b // 2, s - 1, 1] = float("inf")
        x[:, 4, 1] = float("nan")
        key = f"{b}x{s}x2"
        for cascade_n, high in ((1, False), (2, True)):
            kw = dict(cascade_n=cascade_n, cascade_high=high)
            # a state mid-stream: one clean block first
            _, state = three_band_scan_reference(clean, three_band_init((s, 2), cascade_n, device=dev), rate, **kw)
            got, gstate = three_band_scan(x, state, rate, **kw)
            ref, rstate = three_band_scan_reference(x, state, rate, **kw)
            torch.cuda.synchronize()
            err = max(float((got - ref).abs().max()), float((gstate - rstate).abs().max()))
            exact = torch.equal(got, ref) and torch.equal(gstate, rstate)
            check(bool(torch.isfinite(got).all()), f"[{key}] cascade {cascade_n}: non-finite band")
            check(exact, f"[{key}] cascade {cascade_n}: kernel differs from the plain loop by {err}")
            kern = lambda: three_band_scan(x, state, rate, **kw)  # noqa: E731, B023
            plain = lambda: three_band_scan_reference(x, state, rate, **kw)  # noqa: E731, B023
            p1 = time_cuda(plain, 3)
            k1, k2 = time_graph(kern, 200), time_graph(kern, 200)
            p2 = time_cuda(plain, 3)
            # per sample and lane, 4 cascades of biquads: 5 products and 4 sums each
            flops = b * s * 2 * 4 * cascade_n * 9.0
            bnd = bound(nbytes(x, state, got, gstate) + 4 * 5 * 4, flops)
            floor = three_band_chain_floor_ms(b, s * 2, issue[(cascade_n, high)], clock, sms)
            log(
                f"phase 15 three_band cascade {cascade_n}{' (high from the low split)' if high else ''} "
                f"[{b}, {s}, 2] at {rate:.0f} Hz with NaN and infinite samples: bit-exact (max |d| {err:.3e}); "
                f"kernel {k1:.4f}/{k2:.4f} ms (a graph of 200 launches), plain {p1:.4f}/{p2:.4f} ms, "
                f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), chain floor {floor:.4f} ms [{card}]"
            )
            reading = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                       "bound_ms": bnd["bound_ms"]}
            shapes.setdefault(key, {})[f"cascade{cascade_n}"] = reading
            if (b, s, cascade_n) == (256, FLAGSHIP_S, 1):  # the waveform's, on the literal default's path
                result = {**reading, "library_ms": None, **bnd}
            del got, ref, gstate, rstate, state
        del x, clean
        torch.cuda.empty_cache()
    return {**result, "shapes": shapes}


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


def phase20_serving_s8192(dev, label: str, engine_cfg, expect: tuple, mesh=None, check_join=None,
                          advances: int = TIMED_HOPS, warmup: int = 20, profile: int = 10) -> dict:
    """``MeterServer`` at S=8192 stereo streams on the card, ``fetch="meters"``
    every sixth hop, with the C++ ``Feeder`` (4 threads) pushing flat out
    under backpressure: ``warmup`` advances, then ``advances`` timed (the
    clock stopped once every fetch is drained and the card is done; the
    server is closed after the profile), counting the
    launches of ``expect``'s kernels and of ``ring_gather`` (one a hop and
    shard), then a ``profile``-advance profile.
    With ``mesh`` the server cuts its streams over it, and
    ``check_join(server)`` runs after the profile."""
    from openmeters_tpu_torch.ingest import Feeder
    from openmeters_tpu_torch.ops.classic_columns import classic_columns
    from openmeters_tpu_torch.ops.corr import corr_dots_sums_ring
    from openmeters_tpu_torch.ops.iir import three_band_scan
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.ops.ring_gather import ring_gather
    from openmeters_tpu_torch.ops.rows import window_rows
    from openmeters_tpu_torch.ops.sliding_hop import sliding_hop
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.tracing import EngineStats

    s = FLAGSHIP_S
    cfg = ServeConfig(n_streams=s, channels=2, engine=engine_cfg, realtime=False, fetch="meters", fetch_every=6)
    ring_bytes = s * cfg.channels * int(cfg.ring_seconds * 48_000.0) * 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = MeterServer(cfg, mesh=mesh, device=dev)
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
        counters = {c.__name__: c for c in (classic_columns, sliding_hop, reassigned_sliding_hop,
                                            corr_dots_sums_ring, window_rows, three_band_scan, ring_gather)}
        for c in counters.values():
            c.launches = 0
        t1 = time.perf_counter()
        for _ in range(advances):
            server.advance()
        while server._inflight:  # noqa: SLF001
            server._drain_one()  # noqa: SLF001
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {name: c.launches for name, c in counters.items()}
        server.stats.wall_seconds = wall
        report = server.report()
        host = {k: 1e3 * v / advances for k, v in server.host_seconds.items()}
        busy_ms, table = profiled(lambda i: server.advance(), profile)
        server.close()
        if check_join is not None:
            check_join(server)
    finally:
        ok, failed = feeder.stop()
    peak = torch.cuda.max_memory_allocated()
    hops_per_advance = report["hops"] / advances
    ms_per_advance = 1e3 * wall / advances
    (OUT_DIR / f"chip_smoke_profile_{label.replace(' ', '')}.txt").write_text(table)
    shards = "" if mesh is None else f" over {len(server._shards)} shards ({', '.join(map(str, mesh.shard_devices()))})"
    log(
        f"{label} MeterServer S={s} stereo{shards}, fetch meters every 6th hop, Feeder 4 threads flat out: built and "
        f"warmed in {built:.1f} s; {advances} advances ({report['hops']} hops, {hops_per_advance:.2f} a "
        f"advance) in {wall:.3f} s: report {json.dumps(report)}; host ms per advance: assemble "
        f"{host['assemble']:.4f}, H2D enqueue {host['h2d']:.4f}, step enqueue {host['step']:.4f}, drain "
        f"{host['drain']:.4f} (wall {ms_per_advance:.4f}); device kernel time {busy_ms:.4f} ms per advance "
        f"over a {profile}-advance profile: busy {100 * busy_ms / ms_per_advance:.1f} % of the timed advance; peak "
        f"device memory {peak / 2**30:.3f} GiB; transport ring {ring_bytes / 1e9:.3f} GB of host memory "
        f"(S x 2 ch x {int(cfg.ring_seconds * 48_000.0)} frames x 4 B); pushes ok {ok}, refused {failed}; "
        f"launches {launches} [{card_line()}]"
    )
    check(report["latency_ms_p50"] is not None, "no fetch drained")
    check(report["hops"] >= advances, f"{report['hops']} hops in {advances} advances")
    for name in expect:
        check(launches[name] > 0, f"{label}: {name} never launched")
    gathers = report["hops"] * len(server._shards)  # noqa: SLF001
    check(launches["ring_gather"] == gathers, f"{label}: ring_gather launched {launches['ring_gather']} times, "
          f"want {gathers} (a hop and shard)")
    return {"report": report, "host_ms": host, "busy_ms": busy_ms, "wall_ms": ms_per_advance,
            "launches": launches, "peak_gib": peak / 2**30, "advances": advances}


# -- the CLI -----------------------------------------------------------------------

CLI_DIR = OUT_DIR / "phase21"  # relative: a unix socket path holds at most 107 bytes
STEADY_AMP, STEADY_HZ = 0.5, 997.0  # -6.02 dBFS


def _tone_chunk(sent: int, rate: float, freq: float, amp: float) -> tuple[np.ndarray, int]:
    """The next 1024-frame push at 48 kHz (its wall time at other rates)
    of a phase-continuous stereo tone, and its timestamp."""
    n = np.arange(sent, sent + int(round(1024 * rate / 48_000.0)))
    x = (amp * np.sin(2 * np.pi * freq * (n / rate))).astype(np.float32)
    return np.stack([x, x], -1), int(sent / rate * 1e9)


def producer_helper(sock: str, n48: int, n44: int, max_seconds: float) -> int:
    """Run in a subprocess of phase 21a: ``n48`` + ``n44`` ``ProducerClient``
    links, each a distinct stereo tone in real time (a push of 1024 frames
    at 48 kHz, one push ahead of the wall clock), until the server closes
    the links or ``max_seconds`` pass.  Prints one JSON line: the links'
    slots."""
    from openmeters_tpu_torch.ingest.runtime import ProducerClient

    specs = [(f"h48-{k:03d}", 48_000.0) for k in range(n48)] + [(f"h44-{k:03d}", 44_100.0) for k in range(n44)]
    clients = []
    for name, rate in specs:
        c = ProducerClient(sock, {"app_name": name, "channels": 2, "sample_rate": rate}, timeout=60.0)
        if c.connect() is None:
            raise RuntimeError(f"{name} refused: {c.refusal}")
        clients.append(c)
    print(json.dumps({name: [rate, c.slot] for (name, rate), c in zip(specs, clients)}), flush=True)
    sent = [0] * len(clients)
    live = [True] * len(clients)
    t0 = time.monotonic()
    while any(live) and time.monotonic() - t0 < max_seconds:
        ahead = time.monotonic() - t0 + 1024 / 48_000.0
        for k, c in enumerate(clients):
            while live[k] and sent[k] < ahead * c.sample_rate:
                pcm, ts = _tone_chunk(sent[k], c.sample_rate, 60.0 * 2 ** (k / 20), 0.25)
                try:
                    c.send_pcm(pcm, ts)
                except OSError:  # the server closed the link
                    live[k] = False
                sent[k] += len(pcm)
        time.sleep(0.002)
    for c in clients:
        c.close()
    return 0


def _steady_producer(sock: str, name: str, rate: float, transport, halt, slots: dict) -> None:
    """Phase 21a's steady -6 dBFS 997 Hz link: it keeps 0.25 s of audio
    buffered in its slot of the bucket's transport (backpressure, as
    phase 20's feeder pushes), so its stream neither runs dry nor
    overflows however fast the server drains, and its meters hold a whole
    window of the tone."""
    from openmeters_tpu_torch.ingest.runtime import ProducerClient

    c = ProducerClient(sock, {"app_name": name, "channels": 2, "sample_rate": rate}, timeout=60.0)
    slots[name] = [rate, c.connect()]
    sent = 0
    try:
        while not halt.wait(0.05):
            while transport.buffered_frames(c.slot) < 0.25 * rate:
                pcm, ts = _tone_chunk(sent, rate, STEADY_HZ, STEADY_AMP)
                c.send_pcm(pcm, ts)
                sent += len(pcm)
    except OSError:
        pass  # the server closed the link
    finally:
        c.close()


class _Phase21Server:
    """Observes the ``MultiRateMeterServer`` the CLI builds in phase 21a:
    per bucket, the reset and underrun flags of every assembled hop, every
    drained fetch's momentary LUFS, and the kernel launches of advances
    that no background warm-up overlapped; the serve loop's start and end."""

    def __init__(self, counters: dict):
        self.counters = counters
        self.server = None
        self.flags: dict = {}  # rate -> [packed reset|underrun bits a hop]
        self.drains: dict = {}  # rate -> [(hops assembled, momentary LUFS [S])]
        self.quiet: dict = {}  # rate -> {kernel: launches in advances with no warm-up beside them}
        self.staged: dict = {}  # rate -> serve-loop seconds when a reconfiguration was first pending
        self.adopted: dict = {}  # rate -> serve-loop seconds when the reassigned engine first served
        self.t0 = self.t_end = None  # the serve loop's start and end (perf_counter)
        self.wall = (None, None)  # the same on the wall clock (time.time)

    def install(self, serve_mod) -> None:
        base, probe = serve_mod.MultiRateMeterServer, self

        class Observed(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                probe.server = self
                probe.t0 = time.perf_counter()
                for rate, s in self.servers.items():
                    probe._observe(rate, s)

            def run(self, duration_s):
                probe.t0, start = time.perf_counter(), time.time()
                try:
                    return super().run(duration_s)
                finally:
                    probe.t_end, probe.wall = time.perf_counter(), (start, time.time())

        serve_mod.MultiRateMeterServer = Observed
        self._restore = (serve_mod, base)

    def uninstall(self) -> None:
        serve_mod, base = self._restore
        serve_mod.MultiRateMeterServer = base

    def _observe(self, rate, s) -> None:
        flags, drains = self.flags.setdefault(rate, []), self.drains.setdefault(rate, [])
        quiet = self.quiet.setdefault(rate, dict.fromkeys(self.counters, 0))
        assemble, advance = s.transport.assemble_desc, s.advance

        def observed_assemble(*args, **kw):
            out = assemble(*args, **kw)
            flags.append(np.packbits((out[0] != 0) | (out[1] != 0)))
            return out

        def recorder(server):
            m = server.last_meters()
            drains.append((len(flags), m["['loudness'].momentary_lufs"].copy()))

        def observed_advance():
            calm = not any(b.reconfig_pending for b in self.server.servers.values())
            before = {n: c.launches for n, c in self.counters.items()}
            advance()
            now = round(time.perf_counter() - self.t0, 3)
            if s.reconfig_pending:
                self.staged.setdefault(str(rate), now)
            if s.engine.config.spectrogram.use_reassignment:
                self.adopted.setdefault(str(rate), now)
            if calm and not any(b.reconfig_pending for b in self.server.servers.values()):
                for n, c in self.counters.items():
                    quiet[n] += c.launches - before[n]

        s.transport.assemble_desc = observed_assemble
        s.on_drain = recorder  # the CLI's settings watcher runs after it
        s.advance = observed_advance

    def clean_reading(self, rate: float, slot: int, hops: int):
        """The newest drained momentary LUFS of ``slot`` whose last ``hops``
        assembled hops carried whole PCM blocks (no underrun, no reset),
        and how many drains were older; ``None`` if no drain had such a
        window."""
        flags = self.flags[rate]
        for k in range(len(self.drains[rate]) - 1, -1, -1):
            h, lufs = self.drains[rate][k]
            if h >= hops + 1 and not any(np.unpackbits(f)[slot] for f in flags[h - hops : h]):
                return float(lufs[slot]), k, len(self.drains[rate])
        return None


def _samples_between(csv: str, start: float, end: float) -> list[float]:
    """``nvidia-smi --query-gpu=timestamp,utilization.gpu`` lines whose
    timestamp (the host's local time) falls within ``[start, end]``
    (``time.time()`` seconds): their utilization values."""
    import datetime

    out = []
    for line in csv.splitlines():
        stamp, _, value = line.rpartition(",")
        try:
            t = datetime.datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()
            util = float(value)
        except ValueError:
            continue
        if start <= t <= end:
            out.append(util)
    return out


def _message_counts(links: dict) -> dict:
    """PCM messages a link: least, median, most, by kind of producer."""
    out = {}
    for kind in ("h48", "h44", "sub", "steady"):
        n = sorted(v["pcm_messages"] for k, v in links.items() if k.startswith(f"app.name:{kind}"))
        if n:
            out[kind] = [n[0], n[len(n) // 2], n[-1]]
    return out


def _cli(argv: list[str]) -> tuple[int, str]:
    """``python -m openmeters_tpu_torch`` in this process: its exit code
    and standard output."""
    import contextlib
    import io

    from openmeters_tpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def _wait_for(cond, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def phase21a_serve_socket(dev, counters: dict, streams: int = 4096, duration: float = 24.0) -> dict:
    """``serve --socket --rates 44100,48000 --streams 4096`` with the
    flagship in a watched settings file: 128 producer links in real time
    (a helper subprocess of ``ProducerClient``s and four ``ingest.producer``
    processes, one with a timeline gap, one with a format switch) and two
    steady ones under backpressure; the file rewritten to turn
    reassignment on halfway through."""
    import dataclasses
    import shutil

    from openmeters_tpu_torch import serve as serve_mod
    from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig
    from openmeters_tpu_torch.api import analyze
    from openmeters_tpu_torch.engine import EngineConfig, scaled_block_frames
    from openmeters_tpu_torch.persistence import encode_settings, write_json_atomic
    from openmeters_tpu_torch.utils.parity import LOUDNESS_LU

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    sock, settings = str(CLI_DIR / "serve.sock"), str(CLI_DIR / "settings.json")
    flagship = flagship_config()
    write_json_atomic(settings, encode_settings(flagship))
    edited = str(CLI_DIR / "settings.next.json")
    reassigned = dataclasses.replace(flagship, spectrogram=dataclasses.replace(flagship.spectrogram,
                                                                              use_reassignment=True))
    write_json_atomic(edited, encode_settings(reassigned))
    rewrite_at = duration / 2
    probe = _Phase21Server(counters)
    n48, n44 = 93, 31  # with the four producer processes: 96 links at 48 kHz, 32 at 44.1 kHz
    subs = [("sub-gap", 48_000.0, ["--gap-at", "3"]), ("sub-fmt", 48_000.0, ["--format-switch-at", "5"]),
            ("sub-48", 48_000.0, []), ("sub-44", 44_100.0, [])]
    procs: dict = {}
    peaks = {}
    halt, steady_slots, steady_threads = threading.Event(), {}, []

    def spawn():
        if not _wait_for(lambda: os.path.exists(sock) and probe.server is not None, 300.0):
            return
        procs["helper"] = subprocess.Popen(
            [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.producer_helper("
             f"{sock!r}, {n48}, {n44}, {duration + 60.0}))"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, (name, rate, extra) in enumerate(subs):
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "openmeters_tpu_torch.ingest.producer", "--socket", sock, "--app-name",
                 name, "--rate", str(rate), "--freq", str(440.0 + 110.0 * k), "--amp", "0.3", "--seconds", "8",
                 "--realtime", *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, rate in (("steady48", 48_000.0), ("steady44", 44_100.0)):
            t = threading.Thread(target=_steady_producer, daemon=True,
                                 args=(sock, name, rate, probe.server.servers[rate].transport, halt, steady_slots))
            t.start()
            steady_threads.append(t)
        # halfway through the serve loop, turn reassignment on: one rename,
        # as an editor saves (this thread waits on the interpreter lock
        # behind the runtime's threads, so it prepared the file before)
        time.sleep(max(rewrite_at - (time.perf_counter() - probe.t0), 0.0))
        peaks["before_swap"] = torch.cuda.max_memory_allocated()
        peaks["rewrite_s"] = time.perf_counter() - probe.t0
        os.replace(edited, settings)

    starter = threading.Thread(target=spawn, daemon=True)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    probe.install(serve_mod)
    # the device's busy share from nvidia-smi (the share of each sample
    # period in which a kernel ran): a profiler in this process doubles the
    # host's time to launch a step here, and its start waits seconds on the
    # interpreter lock behind the runtime's threads
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=timestamp,utilization.gpu", "--format=csv,noheader,nounits",
                            "-lms", "500"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    starter.start()
    t0 = time.perf_counter()
    try:
        rc, out = _cli(["serve", "--socket", sock, "--rates", "44100,48000", "--streams", str(streams),
                        "--config", "serve", "--fetch", "meters", "--settings", settings, "--watch-settings",
                        "--duration", str(duration)])
    finally:
        probe.uninstall()
        smi.terminate()
        samples = smi.communicate(timeout=30)[0]
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        starter.join(timeout=60)
        halt.set()
        for t in steady_threads:
            t.join(timeout=30)
        results = {}
        for name, p in procs.items():
            try:
                results[name] = (p.wait(timeout=90), *p.communicate(timeout=30))
            except subprocess.TimeoutExpired:
                p.kill()
                results[name] = (p.wait(timeout=30), "", "killed")
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"phase 21a: serve exited {rc}")
    report = json.loads(out.strip().splitlines()[-1])
    m = probe.server
    slots = json.loads(results["helper"][1].strip().splitlines()[-1]) if results.get("helper", (1,))[0] == 0 else {}
    slots.update(steady_slots)
    flagged = {}  # the steady slots' hops with an underrun or a reset
    for rate, flags in probe.flags.items():
        name = "steady48" if rate == 48_000.0 else "steady44"
        if name in slots:
            flagged[name] = [int(np.unpackbits(f)[slots[name][1]]) for f in flags]
    steady = {}
    for name, (rate, slot) in ((n, slots[n]) for n in ("steady48", "steady44") if n in slots):
        window = math.ceil(0.4 * rate / scaled_block_frames(rate)) + 2
        got = probe.clean_reading(rate, slot, window)
        t = np.arange(int(2.0 * rate)) / rate
        x = (STEADY_AMP * np.sin(2 * np.pi * STEADY_HZ * t)).astype(np.float32)
        ref_cfg = EngineConfig.at_rate(rate, channels=2, loudness=LoudnessConfig(), spectrogram=None,
                                       spectrum=None, oscilloscope=None, stereometer=None, waveform=None)
        ref = float(analyze(np.stack([x, x], -1), rate, ref_cfg, device="cpu")[-1]["loudness"].momentary_lufs[0])
        steady[name] = {"rate": rate, "slot": slot, "cpu": ref, "window_hops": window,
                        "flagged_hops": f"{sum(flagged[name])} of {len(flagged[name])}"}
        if got is not None:
            steady[name].update(served=got[0], drain=got[1], drains=got[2])
    stages = {str(rate): {k: round(1e3 * v / max(s.stats.hops, 1), 4) for k, v in s.host_seconds.items()}
              for rate, s in m.servers.items()}
    loop_s = probe.t_end - probe.t0
    in_loop = _samples_between(samples, *probe.wall)
    busy = sum(in_loop) / len(in_loop) if in_loop else None
    rep = {str(r): {k: report[str(r)][k] for k in ("streams", "hops", "resets", "underruns", "realtime_streams",
                                                    "latency_ms_p50", "latency_ms_p95", "latency_ms_max")}
           for r in m.servers}
    log(
        f"phase 21a serve --socket, {streams} slots a bucket at 44.1 and 48 kHz, {n48 + n44 + len(subs)} producer "
        f"links in real time ({n48 + 3} at 48 kHz, {n44 + 1} at 44.1 kHz) and 2 steady ones under backpressure, "
        f"--duration {duration}: rc {rc}, {wall:.1f} s in all; "
        f"report {json.dumps(rep)}; host ms a hop by stage {json.dumps(stages)}; device busy "
        f"{'not measured' if busy is None else f'{busy:.1f} %'} (nvidia-smi utilization.gpu, mean of the "
        f"{len(in_loop)} samples, polled every 500 ms, within the {loop_s:.2f} s serve loop: {in_loop}); link messages "
        f"{json.dumps(_message_counts(report['links']))}; peak device memory "
        f"{peaks.get('before_swap', 0) / 2**30:.3f} GiB before the settings rewrite, {peak / 2**30:.3f} GiB with "
        f"the swap; settings rewritten at {peaks.get('rewrite_s', 0):.2f} s, swap staged / adopted at "
        f"{json.dumps(probe.staged)} / {json.dumps(probe.adopted)} s of the serve loop; launches {launches}, in "
        f"advances with no warm-up beside them {json.dumps({str(k): v for k, v in probe.quiet.items()})}; "
        f"steady tone {json.dumps(steady)} [{card_line()}]"
    )
    for name, (code, _, err) in results.items():
        check(code == 0, f"phase 21a: producer {name} exited {code}: {err[-2000:]}")
    want = set(f"app.name:{n}" for n in list(slots) + [s[0] for s in subs])
    check(len(want) == n48 + n44 + len(subs) + 2, "phase 21a: producer names collide")
    missing = want - set(report["links"])
    check(not missing, f"phase 21a: links missing from the report: {sorted(missing)[:8]}")
    for rate, s in m.servers.items():
        check(s.engine.config.spectrogram.use_reassignment, f"phase 21a: the {rate} Hz bucket never adopted the swap")
        check(probe.quiet[rate]["classic_columns"] > 0,
              f"phase 21a: classic_columns never launched in the {rate} Hz bucket")
        # 2048/64 slides at 48 kHz (B2); 235-frame blocks do not align the
        # sliding ring's writes, so at 44.1 kHz it runs a column at a time (B3)
        sg = s.engine.analyzers["spectrogram"]
        kernel = "reassigned_sliding_hop" if sg.use_sliding_reassigned else "reassigned_columns"
        check(sg.use_sliding_reassigned or sg.use_reassigned_kernel, f"phase 21a: {rate} Hz reassigns on no kernel")
        check(probe.quiet[rate][kernel] > 0, f"phase 21a: {kernel} never launched in the {rate} Hz bucket after the swap")
    for name, st in steady.items():
        check("served" in st, f"phase 21a: {name} never had {st['window_hops']} clean hops before a drain")
        check(abs(st["served"] - st["cpu"]) <= LOUDNESS_LU,
              f"phase 21a: {name} served momentary {st['served']} LUFS against {st['cpu']} analyzed on the CPU")
    return {"report": rep, "stages": stages, "busy": busy, "peak": peak, "steady": steady}


def phase21b_analyze(dev, counters: dict) -> None:
    """``analyze`` of a 3 s stereo WAV under ``EngineConfig()`` with the
    spectrum at hop 512 (a settings file), on the card and with
    ``--device cpu``: every field within its bar."""
    import dataclasses

    from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.io.wav import write_wav
    from openmeters_tpu_torch.persistence import encode_settings, write_json_atomic
    from openmeters_tpu_torch.utils.parity import check_analyze

    rng = np.random.default_rng(SEED)
    t = np.arange(int(3.0 * 48_000)) / 48_000.0
    left = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1700.0 * t)
    left += 0.01 * rng.standard_normal(t.shape)
    right = 0.6 * left + 0.05 * np.sin(2 * np.pi * 3100.0 * t)
    wav, settings = str(CLI_DIR / "input.wav"), str(CLI_DIR / "analyze.json")
    write_wav(wav, np.stack([left, right], -1).astype(np.float32), 48_000.0)
    write_json_atomic(settings, encode_settings(dataclasses.replace(EngineConfig(),
                                                                    spectrum=SpectrumConfig(hop_size=512))))
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc, out = _cli(["analyze", wav, "--settings", settings, "--compact"])
    card_s = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    check(rc == 0, f"phase 21b: analyze on the card exited {rc}")
    t0 = time.perf_counter()
    rc_cpu, out_cpu = _cli(["analyze", wav, "--settings", settings, "--compact", "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    check(rc_cpu == 0, f"phase 21b: analyze --device cpu exited {rc_cpu}")
    card, cpu = json.loads(out.strip().splitlines()[-1]), json.loads(out_cpu.strip().splitlines()[-1])
    err = check_analyze(card, cpu, "phase 21b card against cpu")
    for name in ("sliding_hop_spectra", "reassigned_sliding_hop", "corr_dots_sums_ring", "window_rows",
                 "three_band_scan"):
        check(launches[name] > 0, f"phase 21b: {name} never launched")
    log(f"phase 21b analyze, 3 s stereo 48 kHz, EngineConfig() with the spectrum at hop 512: card "
        f"{card_s:.1f} s, cpu {cpu_s:.1f} s; card {json.dumps(card)}; differences {json.dumps(err)}; launches "
        f"{launches} [{card_line()}]")


def phase21c_commands(dev) -> None:
    """``selftest``, ``precompile`` and ``settings --init`` on the card."""
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.persistence import SettingsHandle

    rc, out = _cli(["selftest", "--device", "cuda"])
    check(rc == 0, f"phase 21c: selftest exited {rc}: {out}")
    rc, pre = _cli(["precompile", "--streams", "256"])
    check(rc == 0, f"phase 21c: precompile exited {rc}")
    pre = json.loads(pre.strip().splitlines()[-1])
    path = str(CLI_DIR / "default.json")
    rc, _ = _cli(["settings", "--init", path])
    check(rc == 0 and SettingsHandle.load_or_default(path) == EngineConfig(),
          "phase 21c: settings --init does not load back to EngineConfig()")
    log(f"phase 21c selftest: {out.strip()}; precompile {json.dumps(pre)}; settings --init loads back to "
        f"EngineConfig() [{card_line()}]")


def phase21_cli(dev) -> dict:
    from openmeters_tpu_torch.ops.corr import corr_dots_sums_ring
    from openmeters_tpu_torch.ops.iir import three_band_scan
    from openmeters_tpu_torch.ops.reassigned_columns import reassigned_columns
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.ops.rows import window_rows
    from openmeters_tpu_torch.ops.classic_columns import classic_columns
    from openmeters_tpu_torch.ops.sliding_hop import sliding_hop, sliding_hop_spectra

    counters = {c.__name__: c for c in (classic_columns, sliding_hop, sliding_hop_spectra, reassigned_sliding_hop,
                                        reassigned_columns, corr_dots_sums_ring, window_rows, three_band_scan)}
    served = phase21a_serve_socket(dev, counters)
    torch.cuda.empty_cache()
    phase21b_analyze(dev, counters)
    phase21c_commands(dev)
    return served


# -- the display layers ----------------------------------------------------------

RENDER_DIR = OUT_DIR / "phase22"
PANES = ("loudness", "spectrogram", "spectrum", "oscilloscope", "stereometer", "waveform")


def render_wav(path: str, rate: float, seconds: float = 3.0) -> None:
    """A stereo WAV at ``rate`` made from ``SEED`` as phase 21b makes its
    own: two tones and faint noise on the left, a third tone on the right."""
    from openmeters_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(SEED)
    t = np.arange(int(seconds * rate)) / rate
    left = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1700.0 * t)
    left += 0.01 * rng.standard_normal(t.shape)
    right = 0.6 * left + 0.05 * np.sin(2 * np.pi * 3100.0 * t)
    write_wav(path, np.stack([left, right], -1).astype(np.float32), rate)


def compare_renders(ours, ref) -> dict:
    """Every PNG in directory ``ref`` against the one of the same name in
    ``ours`` by the pixel bar of ``utils/parity.py``.  Raises
    ``AssertionError`` where the two hold other panes, or a pane is off the
    bar; returns the errors by pane."""
    from openmeters_tpu_torch.render import decode_png
    from openmeters_tpu_torch.utils.parity import check_image, image_errors

    ours, ref = Path(ours), Path(ref)
    names = sorted(p.name for p in ref.glob("*.png"))
    check(names == sorted(p.name for p in ours.glob("*.png")),
          f"{ours} and {ref} hold other panes: {sorted(p.name for p in ours.glob('*.png'))} against {names}")
    out = {}
    for name in names:
        err = image_errors(decode_png((ours / name).read_bytes()), decode_png((ref / name).read_bytes()))
        check_image(err, str(ours / name))
        out[name[:-4]] = err
    return out


def _drawn(directory: Path, panes) -> bool:
    """Whether every named pane of ``directory`` is written and has content
    (the consumer writes a frame whole, by rename)."""
    from openmeters_tpu_torch.render import decode_png

    try:
        return all(decode_png((directory / f"{n}.png").read_bytes()).max() > 0 for n in panes)
    except OSError:
        return False


def _decoded(directory: Path, panes) -> dict:
    """The named panes of ``directory`` decoded: ``{pane: (height, width)}``;
    raises where one is missing or does not decode."""
    from openmeters_tpu_torch.render import decode_png

    out = {}
    for name in panes:
        path = directory / f"{name}.png"
        check(path.exists(), f"{path} was never written")
        img = decode_png(path.read_bytes())
        check(img.ndim == 3 and img.shape[2] == 3 and img.max() > 0, f"{path}: nothing drawn")
        out[name] = img.shape[:2]
    return out


def phase22a_render(dev, counters: dict) -> dict:
    """``render`` of a 3 s stereo WAV at 48 kHz under the literal
    ``EngineConfig()``, and of one at 44.1 kHz under
    ``EngineConfig.at_rate(44100)`` (a settings file: the literal default at
    the 44.1 kHz bucket's 235-frame block, where the reassigned spectrogram
    runs a column at a time), 960 x 540, on the card in this process and
    with ``--device cpu`` in two subprocesses started first (3 threads
    each); every pane written and decoded, the card's images against the
    CPU's by the pixel bar."""
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.persistence import encode_settings, write_json_atomic

    RENDER_DIR.mkdir(parents=True, exist_ok=True)
    at44 = str(RENDER_DIR / "at44100.json")
    write_json_atomic(at44, encode_settings(EngineConfig.at_rate(44_100.0)))
    runs = {48_000: ([], ("reassigned_sliding_hop", "corr_dots_sums_ring", "window_rows", "three_band_scan")),
            44_100: (["--settings", at44],
                     ("reassigned_columns", "corr_dots_sums_ring", "window_rows", "three_band_scan"))}
    cpu, ends = {}, {}
    env = dict(os.environ, OMP_NUM_THREADS="3")
    for rate, (extra, _) in runs.items():
        wav = str(RENDER_DIR / f"in{rate}.wav")
        render_wav(wav, float(rate))
        proc = subprocess.Popen(
            [sys.executable, "-m", "openmeters_tpu_torch", "render", wav, str(RENDER_DIR / f"cpu{rate}"), *extra,
             "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        cpu[rate] = (proc, time.perf_counter())
        threading.Thread(target=lambda r=rate, p=proc: (p.wait(), ends.__setitem__(r, time.perf_counter())),
                         daemon=True).start()
    out = {}
    try:
        for rate, (extra, expect) in runs.items():
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            rc, printed = _cli(["render", str(RENDER_DIR / f"in{rate}.wav"), str(RENDER_DIR / f"card{rate}"), *extra])
            card_s = time.perf_counter() - t0
            launches = {n: c.launches for n, c in counters.items()}
            check(rc == 0, f"phase 22a: render at {rate} Hz on the card exited {rc}")
            check(sorted(Path(p).stem for p in printed.split()) == sorted(PANES),
                  f"phase 22a: render at {rate} Hz wrote {printed.split()}")
            for name in expect:
                check(launches[name] > 0, f"phase 22a: {name} never launched by render at {rate} Hz")
            out[rate] = {"card_s": card_s, "launches": launches,
                         "sizes": _decoded(RENDER_DIR / f"card{rate}", PANES)}
        for rate, (proc, t0) in cpu.items():
            printed, _ = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"phase 22a: render --device cpu at {rate} Hz exited {proc.returncode}: "
                  f"{printed[-2000:]}")
            out[rate]["cpu_s"] = ends.get(rate, time.perf_counter()) - t0
            out[rate]["errors"] = compare_renders(RENDER_DIR / f"card{rate}", RENDER_DIR / f"cpu{rate}")
    finally:
        for proc, _ in cpu.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rate, r in out.items():
        log(f"phase 22a render, 3 s stereo at {rate} Hz{' (EngineConfig.at_rate: 235-frame blocks)' if rate != 48_000 else ''}, "
            f"EngineConfig(), 960 x 540: card {r['card_s']:.1f} s, cpu {r['cpu_s']:.1f} s (two cpu renders at once, "
            f"3 threads each, beside the card's); panes {r['sizes']}; card against cpu: "
            + ", ".join(f"{k} off {v['off_share']:.3e} mean {v['mean_levels']:.4f} max {v['max_levels']}"
                        for k, v in r["errors"].items())
            + f"; launches {r['launches']} [{card_line()}]")
    return out


def phase22b_live(dev, served: dict, seconds: float = 10.0) -> dict:
    """The display consumers on the served literal default at S=8192 (as
    20a: 2 channels, ``fetch="meters"`` every sixth hop, the C++ ``Feeder``
    flat out): 40 warm-up advances, then ``serve_tui_callback`` (into a
    buffer) and ``attach_render_consumer`` (a frame every 0.5 s) for
    ``seconds`` of ``run()``; the meter-mode panes written and decoded, and
    the report beside 20a's."""
    import contextlib
    import io

    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.ingest import Feeder
    from openmeters_tpu_torch.render_live import attach_render_consumer
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.tracing import EngineStats
    from openmeters_tpu_torch.tui import serve_tui_callback

    s = FLAGSHIP_S
    cfg = ServeConfig(n_streams=s, channels=2, engine=EngineConfig(), realtime=False, fetch="meters", fetch_every=6)
    out_dir = RENDER_DIR / "live_meters"
    server = MeterServer(cfg, device=dev)
    feeder = Feeder(server.transport, realtime=False, n_threads=4,
                    max_buffered_frames=int(cfg.ring_seconds * 48_000.0) // 2)
    tui = io.StringIO()
    try:
        for _ in range(40):
            server.advance()
        while server._inflight:  # noqa: SLF001
            server._drain_one()  # noqa: SLF001
        torch.cuda.synchronize()
        server.stats, server.latencies_ms = EngineStats(), []
        spent = {"tui": 0.0, "frames": 0.0}  # host seconds on the serving thread

        def timed(fn, key):
            def run(*args):
                t = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    spent[key] += time.perf_counter() - t
            return run

        server.on_drain = timed(serve_tui_callback(stream=0), "tui")
        renderer = attach_render_consumer(server, str(out_dir), every=0.5)
        renderer.render = timed(renderer.render, "frames")
        with contextlib.redirect_stderr(tui):
            report = server.run(seconds)
        server.close()
    finally:
        feeder.stop()
    sizes = _decoded(out_dir, ("loudness", "stereometer", "spectrum", "oscilloscope"))
    frames = tui.getvalue().count("\x1b[H")
    check("LUFS" in tui.getvalue() and frames > 0, "phase 22b: the TUI painted no meters")
    ref = served["report"]
    log(f"phase 22b MeterServer S={s}, literal EngineConfig() at 2 channels, fetch meters every 6th hop, Feeder "
        f"flat out, with the TUI ({frames} frames) and the PNG consumer ({renderer.frames} frames, every 0.5 s) "
        f"for {seconds:.0f} s: panes {sizes}; drawing on the serving thread: frames {spent['frames']:.3f} s "
        f"({1e3 * spent['frames'] / max(renderer.frames, 1):.1f} ms a frame), TUI {spent['tui']:.3f} s "
        f"({1e3 * spent['tui'] / max(frames, 1):.1f} ms a paint) of {report['wall_seconds']} s; "
        f"realtime_streams {report['realtime_streams']}, latency p50 "
        f"{report['latency_ms_p50']} p95 {report['latency_ms_p95']} ms; 20a in this run without them: "
        f"realtime_streams {ref['realtime_streams']}, p50 {ref['latency_ms_p50']} p95 {ref['latency_ms_p95']} ms; "
        f"report {json.dumps(report)} [{card_line()}]")
    return {"report": report, "frames": renderer.frames, "tui_frames": frames, "spent": spent}


def phase22c_full(dev, s: int = 256) -> dict:
    """The served literal default with ``fetch="full"`` at S=``s``, the
    TUI, the PNG consumer (every 0.25 s) and ``attach_key_controls`` on a
    pipe: once the bulk panes are written, ``2`` toggles the spectrogram
    off and back (each a new engine warmed on the card while the old one
    serves, adopted at an advance's start), ``p`` pauses and resumes, and
    ``q`` stops ``run()``."""
    import contextlib
    import io

    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.ingest import Feeder
    from openmeters_tpu_torch.render_live import attach_render_consumer
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig
    from openmeters_tpu_torch.tui import attach_key_controls, serve_tui_callback

    cfg = ServeConfig(n_streams=s, channels=2, engine=EngineConfig(), realtime=False, fetch="full", fetch_every=6)
    out_dir = RENDER_DIR / "live_full"
    t0 = time.perf_counter()
    server = MeterServer(cfg, device=dev)
    feeder = Feeder(server.transport, realtime=False, n_threads=2,
                    max_buffered_frames=int(cfg.ring_seconds * 48_000.0) // 2)
    r, w = os.pipe()
    keys = os.fdopen(r, "rb", buffering=0)
    tui = serve_tui_callback(stream=1)
    server.on_drain = tui
    renderer = attach_render_consumer(server, str(out_dir), stream=1, every=0.25)
    attach_key_controls(server, source=keys, view=tui.view)
    ev: dict = {}
    kept = out_dir / "first"
    stock = server.engine.config.spectrogram

    def drive() -> None:
        try:
            # the first frames with every pane drawn are kept: a toggled
            # spectrogram starts its scroll empty again
            ev["panes"] = _wait_for(lambda: _drawn(out_dir, PANES), 120)
            if ev["panes"]:
                kept.mkdir(parents=True, exist_ok=True)
                for n in PANES:
                    (kept / f"{n}.png").write_bytes((out_dir / f"{n}.png").read_bytes())
            for on in (False, True):
                h0 = server.stats.hops
                os.write(w, b"2")
                ok = _wait_for(lambda on=on: not server.reconfig_pending
                               and ("spectrogram" in server.engine.analyzers) == on, 120)
                ev[f"toggle_{'on' if on else 'off'}"] = (ok, h0, server.stats.hops)
            os.write(w, b"p")
            ev["paused"] = _wait_for(lambda: server.paused, 30)
            h = server.stats.hops
            time.sleep(0.5)
            ev["paused_hops"] = (h, server.stats.hops)
            os.write(w, b"p")
            ev["resumed"] = _wait_for(lambda: not server.paused and server.stats.hops > h, 30)
        finally:
            os.write(w, b"q")

    driver = threading.Thread(target=drive, daemon=True)
    buf = io.StringIO()
    try:
        driver.start()
        with contextlib.redirect_stderr(buf):
            report = server.run(300.0)
        driver.join(timeout=60)
        carry_dev = {t.device.type for t in torch.utils._pytree.tree_leaves(server.carry["spectrogram"])
                    if isinstance(t, torch.Tensor)}
        server.close()
    finally:
        feeder.stop()
        keys.close()
        os.close(w)
    wall = time.perf_counter() - t0
    check(ev.get("panes"), "phase 22c: the panes were never all drawn")
    sizes = _decoded(kept, PANES)
    for key in ("toggle_off", "toggle_on"):
        ok, h0, h1 = ev[key]
        check(ok and h1 > h0, f"phase 22c: {key} not adopted while serving (hops {h0} -> {h1})")
    check(server.engine.config.spectrogram == stock, "phase 22c: the re-enabled spectrogram lost its settings")
    check(carry_dev == {"cuda"}, f"phase 22c: the re-enabled spectrogram's carry is on {carry_dev}")
    check(ev.get("paused") and ev["paused_hops"][0] == ev["paused_hops"][1] and ev.get("resumed"),
          f"phase 22c: pause {ev.get('paused')}, hops while paused {ev.get('paused_hops')}, resumed {ev.get('resumed')}")
    check(report["wall_seconds"] < 290.0, "phase 22c: q did not stop the loop")
    log(f"phase 22c MeterServer S={s}, literal EngineConfig() at 2 channels, fetch full every 6th hop, stream 1 "
        f"shown: panes {sizes} ({renderer.frames} frames, every 0.25 s); key 2 off adopted at hop "
        f"{ev['toggle_off'][2]} (pressed at {ev['toggle_off'][1]}), on at {ev['toggle_on'][2]} (pressed at "
        f"{ev['toggle_on'][1]}), the stock settings restored from the stash; p held the hop count at "
        f"{ev['paused_hops'][0]} for 0.5 s, p resumed, q stopped run() after {report['wall_seconds']} s; "
        f"{wall:.1f} s with the server's warm-up; report {json.dumps(report)} [{card_line()}]")
    return {"report": report, "events": ev}


def phase22_display(dev, served20a: dict) -> dict:
    from openmeters_tpu_torch.ops.corr import corr_dots_sums_ring
    from openmeters_tpu_torch.ops.iir import three_band_scan
    from openmeters_tpu_torch.ops.reassigned_columns import reassigned_columns
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.ops.rows import window_rows

    counters = {c.__name__: c for c in (reassigned_sliding_hop, reassigned_columns, corr_dots_sums_ring, window_rows,
                                        three_band_scan)}
    t0 = time.perf_counter()
    rendered = phase22a_render(dev, counters)
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    live = phase22b_live(dev, served20a)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    full = phase22c_full(dev)
    log(f"phase 22 in {time.perf_counter() - t0:.1f} s: 22a {t1 - t0:.1f} s, 22b {t2 - t1:.1f} s, 22c "
        f"{time.perf_counter() - t2:.1f} s")
    return {"render": rendered, "live": live, "full": full}


# -- the stream mesh ------------------------------------------------------------------


def replicated_mismatches(shards: list, dims) -> list[str]:
    """The paths of the carry leaves with no stream dim (``dims`` ``None``:
    the host scalars every shard advances alike) whose value differs
    across the shard carries ``shards``."""
    out = []

    def walk(nodes, d, path):
        if isinstance(d, dict):
            for k in d:
                walk([n[k] for n in nodes], d[k], f"{path}/{k}")
        elif isinstance(d, tuple):
            for i, x in enumerate(d):
                walk([n[i] for n in nodes], x, f"{path}/{i}")
        elif d is None:
            first = nodes[0]
            same = all(
                torch.equal(first.cpu(), n.cpu()) if isinstance(first, torch.Tensor) else n == first
                for n in nodes[1:]
            )
            if not same:
                out.append(path)

    walk(list(shards), dims, "")
    return out


def join_by_leaf(vectors: list, layout: list, dims: list) -> np.ndarray:
    """The meter vector of every stream from per-shard vectors, each
    leaf-major over its own streams: ``layout`` the ``(name, shape)`` of
    each leaf over all streams, ``dims`` each leaf's stream dim (``None``:
    the leaf is shard 0's).  Raises where a vector's length does not fit
    the layout."""
    n = len(vectors)
    local = [shape if d is None else (*shape[:d], shape[d] // n, *shape[d + 1:]) for (_, shape), d in
             zip(layout, dims)]
    sizes = [int(np.prod(shape)) for shape in local]
    for i, v in enumerate(vectors):
        if v.size != sum(sizes):
            raise ValueError(f"shard {i}: {v.size} values, the layout holds {sum(sizes)} a shard")
    out, off = [], 0
    for shape, size, d in zip(local, sizes, dims):
        pieces = [v[off:off + size].reshape(shape) for v in vectors]
        out.append((pieces[0] if d is None else np.concatenate(pieces, axis=d)).reshape(-1))
        off += size
    return np.concatenate(out)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal tensors (NaN where NaN)."""
    b = b.to(a.device)
    if a.shape != b.shape:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _bit_equal(ours: dict, ref: dict) -> dict:
    """``{analyzer.field: bit-equal}`` over two hops' snapshots."""
    return {f"{name}.{f}": _same(getattr(ours[name], f), getattr(snap, f))
            for name, snap in ref.items() for f in snap._fields}


def phase23a_flagship_mesh(dev) -> dict:
    """The flagship at S=8192 through ``sharded_step`` on ``make_mesh()``
    (every card of the machine) against the unsharded ``engine.step`` on
    ``dev``: 200 hops from 16 host blocks, resets of streams 3 and 4097 at
    hop 60 and of 8000 at 140; every 10th hop, the reset hops and the last
    held by the bars of ``utils/parity.py``, every hop's leaves checked for
    bit equality; ``classic_columns`` launched once a shard a hop."""
    from openmeters_tpu_torch.engine import MeterEngine, StreamMeta, make_mesh, sharded_step
    from openmeters_tpu_torch.engine.sharding import gather_carry, gather_snapshots
    from openmeters_tpu_torch.ops.classic_columns import classic_columns
    from openmeters_tpu_torch.utils.parity import check_snapshots

    mesh = make_mesh()
    n = mesh.size
    engine = MeterEngine(flagship_config())
    s, b, hops, bank = FLAGSHIP_S, 256, TIMED_HOPS, 16
    gen = torch.Generator().manual_seed(SEED + 23)
    t = torch.arange(bank * b, dtype=torch.float32) / 48_000.0
    freqs = torch.exp(torch.rand((s, 1, 1), generator=gen) * math.log(4000.0 / 40.0)) * 40.0
    audio = 0.3 * torch.sin(2 * torch.pi * freqs * t[None, :, None]) + 0.02 * torch.randn(
        (s, bank * b, 2), generator=gen)
    blocks = [audio[:, i * b:(i + 1) * b].contiguous().pin_memory() for i in range(bank)]
    del audio
    resets = {60: [3, 4097], 140: [8000]}
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    dev_meta = StreamMeta(*(x.to(dev) for x in meta))
    t0 = time.perf_counter()
    step, place = sharded_step(engine, mesh)
    built = time.perf_counter() - t0
    carry, ref = place(engine.init(s, device=dev)), engine.init(s, device=dev)
    equal = collections.Counter()
    launches, held = 0, 0
    for h in range(hops):
        rst = None
        if h in resets:
            rst = torch.zeros((s,), dtype=torch.bool)
            rst[resets[h]] = True
        before = classic_columns.launches
        carry, snaps = step(carry, blocks[h % bank], meta, rst)
        launches += classic_columns.launches - before
        ref, rsnaps = engine.step(ref, blocks[h % bank].to(dev, non_blocking=True), dev_meta,
                                  None if rst is None else rst.to(dev))
        ours = gather_snapshots(snaps, step.snapshot_dims, device=dev)
        for key, same in _bit_equal(ours, rsnaps).items():
            equal[key] += same
        if h % 10 == 9 or h in resets or h == hops - 1:
            check_snapshots(ours, rsnaps, f"phase 23a hop {h}")
            held += 1
    torch.cuda.synchronize()
    whole = gather_carry(engine, carry, device=dev)
    carry_equal = _bit_equal_carry(whole, ref)
    snap_equal = sorted(k for k, v in equal.items() if v == hops)
    log(
        f"phase 23a flagship S={s} over make_mesh() = {n} card(s) ({', '.join(map(str, mesh.shard_devices()))}) "
        f"against the unsharded step on {dev}, {hops} hops, resets at hops {sorted(resets)}: step built in "
        f"{built:.2f} s; {held} hops held by the bars of utils/parity.py; snapshot leaves bit-equal at every hop: "
        f"{len(snap_equal)} of {len(equal)} ({', '.join(snap_equal)}); bit-equal at some hops only: "
        f"{', '.join(f'{k} {v}' for k, v in sorted(equal.items()) if v != hops) or 'none'}; carry leaves "
        f"bit-equal after the run: {sum(carry_equal.values())} of {len(carry_equal)}; classic_columns launches {launches} "
        f"({launches / hops:.2f} a hop, {n} shard(s)) [{card_line()}]"
    )
    check(launches == hops * n, f"classic_columns launched {launches} times, want {hops * n}")
    del carry, ref, blocks
    torch.cuda.empty_cache()
    return {"shards": n, "launches": launches, "snapshot_bit_equal": len(snap_equal), "snapshot_leaves": len(equal),
            "carry_bit_equal": sum(carry_equal.values()), "carry_leaves": len(carry_equal)}


def _bit_equal_carry(ours: dict, ref: dict) -> dict:
    """``{path: bit-equal}`` over two engine carries' leaves."""
    out = {}

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, tuple):
            for i, x in enumerate(b):
                walk(a[i], x, f"{path}/{i}")
        elif isinstance(b, torch.Tensor):
            out[path] = _same(a, b)
        else:
            out[path] = a == b

    walk(ours, ref, "")
    return out


def _carry_to(carry, device):
    """A copy of an engine carry with its tensors on ``device``."""
    if isinstance(carry, dict):
        return {k: _carry_to(v, device) for k, v in carry.items()}
    if isinstance(carry, tuple):
        return tuple(_carry_to(v, device) for v in carry)
    return carry.to(device, copy=True) if isinstance(carry, torch.Tensor) else carry


def mesh_audio(s: int, hops: int) -> np.ndarray:
    """``[s, hops * 256, 2]``: phase 12's oscilloscope streams (tones, a
    sawtooth, a glide, an onset, a quiet stream), each level scaled per
    copy, for the first half; phase 16's tones plus noise for the rest."""
    half = s // 2
    osc = osc_audio(hops, SEED + 231)
    reps = -(-half // osc.shape[0])
    gains = np.repeat(np.linspace(1.0, 0.25, reps), osc.shape[0])[:half, None, None]
    first = (np.tile(osc, (reps, 1, 1))[:half] * gains).astype(np.float32)
    return np.concatenate([first, stereo_audio(s - half, hops * 256, SEED + 232)])


def phase23b_literal_default_two_shards(dev, s: int = 64, hops: int = 150, more: int = 30) -> dict:
    """The literal ``EngineConfig()`` (two channels) at S=64 over the
    two-shard one-card mesh ``[dev, dev]``, 150 hops, two streams of shard
    1 reset at hop 90, against the unsharded step on ``dev`` (both running
    on from their own carries) and against the same two shards on the CPU
    stepped each hop from a copy of the card shards' carry: every hop's
    snapshots (with the oscilloscope's windows, and the spectrum's on its
    cadence) held by the bars of ``utils/parity.py``; every replicated host
    scalar equal across the shards and to the unsharded carry's at every
    hop; B2, B4, B7 and ``three_band`` each launched once a shard a hop
    from hop 60 on.  Then ``gather_carry`` -> ``save_state`` ->
    ``load_state`` onto a one-shard mesh, continued 30 hops against the
    uninterrupted two-shard run.

    The CPU shards start each hop from the card's state because two runs
    that slide their own states drift apart: left to run on their own, the
    card's reassigned spectrogram parted from the CPU's by 1.18 times the
    50-60 dB drift bar at one bin 59.95 dB below its column's peak (hop
    123 of this audio; PERF.md has the reading), a distance between the card's and
    the CPU's sliding paths, not between the shards; the unsharded card
    run is the free-running reference for the mesh."""
    from openmeters_tpu_torch.checkpoint import load_state, save_state
    from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMesh, StreamMeta, sharded_step
    from openmeters_tpu_torch.engine.sharding import gather_snapshots, sharded_spectrum_step
    from openmeters_tpu_torch.ops.corr import corr_dots_sums_ring
    from openmeters_tpu_torch.ops.iir import three_band_scan
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.ops.rows import window_rows
    from openmeters_tpu_torch.utils.parity import check_snapshots

    b = 256
    engine = MeterEngine(dataclasses.replace(EngineConfig(), channels=2))
    r = engine.spectrum_cadence
    meshes = {"card": StreamMesh([dev, dev]), "cpu": StreamMesh(["cpu", "cpu"])}
    steps = {k: sharded_step(engine, m) for k, m in meshes.items()}
    specs = {k: sharded_spectrum_step(engine, m) for k, m in meshes.items()}
    carries = {k: place(engine.init(s, device="cpu")) for k, (_, place) in steps.items()}
    ref = engine.init(s, device=dev)
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    dev_meta = StreamMeta(*(x.to(dev) for x in meta))
    dims = engine.carry_stream_dims()
    audio = mesh_audio(s, hops + more)
    counters = (reassigned_sliding_hop, corr_dots_sums_ring, window_rows, three_band_scan)
    launches = collections.Counter()
    resets = np.zeros((hops + more, s), bool)
    resets[90, [s // 2 + s // 8, s // 2 + s // 4]] = True  # two streams of shard 1
    held_spectra = 0
    t0 = time.perf_counter()

    def hop(h, step_names=("card", "cpu"), count=False):
        """One hop of every run in ``step_names`` and the unsharded one;
        returns the snapshots, joined on the CPU."""
        nonlocal ref
        if "cpu" in step_names:  # the CPU shards take the card shards' state (in-place steps: copy first)
            carries["cpu"] = [_carry_to(c, "cpu") for c in carries["card"]]
        block = torch.from_numpy(np.ascontiguousarray(audio[:, h * b:(h + 1) * b]))
        rst = torch.from_numpy(resets[h]) if resets[h].any() else None
        out = {}
        for k in step_names:
            step = steps[k][0]
            before = {c.__name__: c.launches for c in counters}
            carries[k], snaps = step(carries[k], block, meta, rst)
            if count and k == "card":
                for c in counters:
                    launches[c.__name__] += c.launches - before[c.__name__]
            joined = gather_snapshots(snaps, step.snapshot_dims)
            traces = [engine.extract_oscilloscope(c) for c in carries[k]]
            joined["oscilloscope"] = gather_snapshots(traces, step.snapshot_dims["oscilloscope"])
            out[k] = joined
        ref, rsnaps = engine.step(ref, block.to(dev), dev_meta, None if rst is None else rst.to(dev))
        out["unsharded"] = dict(rsnaps, oscilloscope=engine.extract_oscilloscope(ref))
        if (h + 1) % r == 0:
            blocks = torch.from_numpy(np.ascontiguousarray(
                audio[:, (h + 1 - r) * b:(h + 1) * b].reshape(s, r, b, 2).transpose(1, 0, 2, 3)))
            group = torch.from_numpy(resets[h + 1 - r:h + 1])
            for k in step_names:
                sps, sp_snaps = specs[k]([c["spectrum"] for c in carries[k]], blocks, meta, group)
                for c, sp in zip(carries[k], sps):
                    c["spectrum"] = sp
                out[k]["spectrum"] = gather_snapshots(sp_snaps, specs[k].snapshot_dims)
            ref["spectrum"], out["unsharded"]["spectrum"] = engine.spectrum_step(
                ref["spectrum"], blocks.to(dev), dev_meta, group.to(dev))
        return out

    scalars = 0
    for h in range(hops):
        out = hop(h, count=h >= 60)
        check_snapshots(out["card"], out["unsharded"], f"phase 23b hop {h}, two shards against unsharded")
        check_snapshots(out["card"], out["cpu"], f"phase 23b hop {h}, card against CPU from the same state")
        held_spectra += "spectrum" in out["card"]
        for k in ("card", "cpu"):
            bad = replicated_mismatches(carries[k], dims)
            check(not bad, f"phase 23b hop {h}: replicated scalars differ across the {k} shards: {bad}")
        bad = replicated_mismatches([carries["card"][0], ref], dims)
        check(not bad, f"phase 23b hop {h}: replicated scalars differ from the unsharded carry's: {bad}")
        scalars += 1
    want = {c.__name__: 2 * max(hops - 60, 0) for c in counters}
    check(dict(launches) == want, f"phase 23b launches {dict(launches)}, want {want} (once a shard a hop)")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0

    # the checkpoint onto a one-shard mesh, beside the uninterrupted two shards
    path = OUT_DIR / "phase23b_carry.npz"
    OUT_DIR.mkdir(exist_ok=True)
    save_state(str(path), engine, carries["card"])
    one = StreamMesh([dev])
    steps["one"], specs["one"] = sharded_step(engine, one), sharded_spectrum_step(engine, one)
    carries["one"] = steps["one"][1](load_state(str(path), engine, device="cpu"))
    for h in range(hops, hops + more):
        out = hop(h, step_names=("card", "one"))
        check_snapshots(out["one"], out["card"], f"phase 23b hop {h}, one shard restored against two")
        check(not replicated_mismatches([carries["one"][0], carries["card"][0]], dims),
              f"phase 23b hop {h}: the restored shard's scalars left the two shards'")
    path.unlink()
    log(
        f"phase 23b literal EngineConfig() (2 channels) S={s} over StreamMesh([{dev}, {dev}]) against the unsharded "
        f"step on {dev} (each free-running) and StreamMesh([cpu, cpu]) stepped each hop from the card shards' "
        f"state: {hops} hops ({held_spectra} with a spectrum hop) in "
        f"{main_s:.1f} s, streams {np.flatnonzero(resets[90]).tolist()} (shard 1) reset at hop 90; every hop held by the bars of "
        f"utils/parity.py both ways; replicated host scalars equal across the shards and to the unsharded "
        f"carry's at all {scalars} hops; launches from hop 60 on {dict(launches)} (once a shard a hop); "
        f"gather_carry -> save_state -> load_state onto StreamMesh([{dev}]) continued {more} hops within the bars "
        f"of the two-shard run [{card_line()}]"
    )
    del carries, ref
    torch.cuda.empty_cache()
    return {"launches": dict(launches)}


def phase23c_served_two_shards(dev, served20a: dict, served20b: dict) -> dict:
    """``MeterServer`` at S=8192 over the two-shard one-card mesh, as 20a
    (the literal default) and 20b (the flagship), beside their figures from
    this run; after each, the server's leaf-by-leaf join of the shards'
    meter vectors against :func:`join_by_leaf` of the same vectors."""
    from openmeters_tpu_torch.engine import EngineConfig, StreamMesh

    def check_join(server):
        vecs = [torch.cat([m.reshape(-1).to(torch.float32) for m in sh.meters]).cpu().numpy()
                for sh in server._shards]  # noqa: SLF001
        meters = server.fetch_meters_now()
        ours = join_by_leaf(vecs, server._packed_layout, server._shard_dims)  # noqa: SLF001
        check(np.array_equal(ours, server.last_snapshot, equal_nan=True), "the served join differs by leaf")
        check(not np.array_equal(np.concatenate(vecs), server.last_snapshot, equal_nan=True),
              "the shard vectors concatenated whole read as the joined meters")
        for name, value in meters.items():
            check(value.shape[0] == FLAGSHIP_S, f"{name}: {value.shape}")

    mesh = StreamMesh([dev, dev])
    out = {}
    for label, cfg, expect, base in (
        ("phase 23c literal default", EngineConfig(), ("reassigned_sliding_hop", "corr_dots_sums_ring",
                                                        "window_rows", "three_band_scan"), served20a),
        ("phase 23c flagship", flagship_config(), ("classic_columns",), served20b),
    ):
        got = phase20_serving_s8192(dev, label, cfg, expect, mesh=mesh, check_join=check_join,
                                    advances=TIMED_HOPS // 2)
        torch.cuda.empty_cache()
        rs, rb = got["report"], base["report"]
        log(
            f"{label} two shards on one card against one shard (20{'a' if base is served20a else 'b'}, this run): "
            f"realtime_streams {rs['realtime_streams']} vs {rb['realtime_streams']} "
            f"({100 * rs['realtime_streams'] / max(rb['realtime_streams'], 1):.1f} %); latency p50/p95 "
            f"{rs['latency_ms_p50']}/{rs['latency_ms_p95']} vs {rb['latency_ms_p50']}/{rb['latency_ms_p95']} ms; "
            f"host ms per advance: assemble {got['host_ms']['assemble']:.4f} vs {base['host_ms']['assemble']:.4f}, "
            f"H2D {got['host_ms']['h2d']:.4f} vs {base['host_ms']['h2d']:.4f}, step enqueue "
            f"{got['host_ms']['step']:.4f} vs {base['host_ms']['step']:.4f}, drain {got['host_ms']['drain']:.4f} "
            f"vs {base['host_ms']['drain']:.4f}; device {got['busy_ms']:.4f} vs {base['busy_ms']:.4f} ms per "
            f"advance (busy {100 * got['busy_ms'] / got['wall_ms']:.1f} vs {100 * base['busy_ms'] / base['wall_ms']:.1f} "
            f"%); peak memory {got['peak_gib']:.3f} vs {base['peak_gib']:.3f} GiB; launches {got['launches']} vs "
            f"{base['launches']} [{card_line()}]"
        )
        out[label] = got
    return out


def phase23_mesh(dev, served20a: dict, served20b: dict, after_served=lambda: None) -> dict:
    """23c (timed) first, then ``after_served()``, then 23a and 23b (checks
    only, which may share the host with what that starts)."""
    t0 = time.perf_counter()
    c = phase23c_served_two_shards(dev, served20a, served20b)
    t1 = time.perf_counter()
    after_served()
    a = phase23a_flagship_mesh(dev)
    t2 = time.perf_counter()
    b = phase23b_literal_default_two_shards(dev)
    log(f"phase 23 in {time.perf_counter() - t0:.1f} s: 23c {t1 - t0:.1f} s, 23a {t2 - t1:.1f} s, 23b "
        f"{time.perf_counter() - t2:.1f} s")
    return {"flagship": a, "literal": b, "served": c}


# -- long runs ------------------------------------------------------------------------

LONG_HOPS = 65_700  # 16,819,200 samples: past 2^24, and 219 runs of 300 hops (16 gating chunks)
LONG_SECTION = 300  # hops a level of the long run's audio holds (1.6 s)
LONG_CHECK_EVERY = 4096  # hops between exact recomputes (a multiple of the 32-hop re-anchor)
LONG_TAIL = 200  # last hops, the CPU stepped from the card's state
INTEGRATED_LU = 0.02  # tests/test_loudness_gating.py:116
LRA_LU = 0.2  # tests/test_loudness_gating.py:124


def drift_audio(s: int, hops: int, seed: int = SEED + 24) -> np.ndarray:
    """``[s, hops * 256, 2]`` float32, each stream made from ``[seed, i]``
    so that the first streams are the same at any ``s``: a tone at 40 Hz to
    8 kHz (log-uniform) of amplitude 0.05 to 0.5; streams ``i % 3 == 1``
    add noise 26 dB below the tone, streams ``i % 3 == 2`` step its level
    by 6 to 20 dB every 0.5 to 1.5 s within -40 to 0 dB of it.  The right
    channel is the left at 0.8 plus noise 80 dB below the tone."""
    n = hops * 256
    t = np.arange(n) / 48_000.0
    out = np.empty((s, n, 2), np.float32)
    for i in range(s):
        rng = np.random.default_rng([seed, i])
        f = np.exp(rng.uniform(np.log(40.0), np.log(8000.0)))
        amp = rng.uniform(0.05, 0.5)
        x = np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        if i % 3 == 1:
            x = x + 0.05 * rng.standard_normal(n)
        elif i % 3 == 2:
            gain, pos, level = np.empty(n), 0, 0.0
            while pos < n:
                m = int(rng.uniform(0.5, 1.5) * 48_000)
                gain[pos:pos + m] = 10.0 ** (level / 20.0)
                pos += m
                step = rng.uniform(6.0, 20.0) * rng.choice([-1.0, 1.0])
                level = level + step if -40.0 <= level + step <= 0.0 else level - step
            x = x * gain
        x = amp * x
        out[i, :, 0] = x
        out[i, :, 1] = 0.8 * x + 1e-4 * amp * rng.standard_normal(n)
    return out


class f32_plain_hop:
    """Within it the spectrogram's hop runs as its plain version in float32
    on every device: ``reassigned_sliding_hop_reference`` in place of B2
    (and of the CPU's float64 hop), ``sliding_hop_reference`` in place of
    B1a, ``classic_columns_reference`` on the extracted frames in place of
    ``classic_columns``."""

    def __enter__(self):
        from openmeters_tpu_torch.ops import classic_columns, sliding_reassigned, sliding_stft
        from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop_reference
        from openmeters_tpu_torch.ops.sliding_hop import sliding_hop_reference

        def reassigned(ready, states, *args, tiles=None, **kw):
            return reassigned_sliding_hop_reference(
                ready, tuple(x.float() for x in states), *(x.float() for x in args), **kw)

        def classic(ready, *args, tiles=None, **kw):
            return sliding_hop_reference(ready, *args, **kw)

        def columns(frames, info, window, norm, *, floor_db):
            return classic_columns.classic_columns_reference(frames.extract(info), window, norm, floor_db=floor_db)

        self.saved = (sliding_reassigned.reassigned_sliding_hop, sliding_stft.sliding_hop,
                      classic_columns.classic_columns)
        sliding_reassigned.reassigned_sliding_hop, sliding_stft.sliding_hop = reassigned, classic
        classic_columns.classic_columns = columns
        return self

    def __exit__(self, *exc):
        from openmeters_tpu_torch.ops import classic_columns, sliding_reassigned, sliding_stft

        (sliding_reassigned.reassigned_sliding_hop, sliding_stft.sliding_hop,
         classic_columns.classic_columns) = self.saved


def fmt_drift(d: dict) -> str:
    worst = "; ".join(f"stream {w[0]} hop {w[1]} col {w[2]} bin {w[3]} {w[4]:.2f} dB down, {w[5]} hops since "
                      f"the re-anchor, time {w[6]:.2f} hop: {w[7]:.3f}" for w in d["worst"][:8])
    bands = "; ".join(
        f"{name}: max {d['max_ratio_bands'][b]:.4f} of the bar (|d time| {d['max_hops'][b]:.4e} hop), 99.9th "
        f"percentile {d['p999_ratio_bands'][b]:.4f}, {d['over_bands'][b]} bins over 1.0 of {d['held'][b]} held"
        for b, name in enumerate(("within 50 dB", "50-60 dB")))
    return f"{bands}; both: 99.9th percentile {d['p999_ratio']:.4f}{'; over 1.0: ' + worst if worst else ''}"


def phase24a_drift(dev, s: int = 256, hops: int = 640) -> dict:
    """The free-running reassigned default (loudness + ``SpectrogramConfig()``,
    2 channels) at S=256 over ``hops`` hops of :func:`drift_audio`: the card
    (B2), the card with the hop's f32 plain version, and the port's CPU path
    (its float64 plain hop), each from its own carry.  The time error of
    the card and of the f32 plain version against the CPU is tallied by
    ``utils/parity.py::DriftTally``; the card's largest time error in
    each band, frequency, power and time at the peak are held within their
    bars or 1.5 times the f32 plain version's own distance
    (``check_near_reference``); ``valid`` equal; loudness within 0.01 LU
    (true peak 1e-3 dB)."""
    from openmeters_tpu_torch.engine import MeterEngine, StreamMeta
    from openmeters_tpu_torch.ops.reassigned_hop import reassigned_sliding_hop
    from openmeters_tpu_torch.utils.parity import (
        DRIFT_TIME_HOPS, FREQ_HZ, LOUDNESS_LU, POWER_REL, TIME_AT_PEAK, TRUE_PEAK_DB, DriftTally,
        check_near_reference,
    )
    from openmeters_tpu_torch.utils.parity import reassigned_errors as errors_of

    t0 = time.perf_counter()
    b = 256
    engine = MeterEngine(reassigned_config())
    refresh = engine.analyzers["spectrogram"]._sliding_reassigned.refresh_steps  # noqa: SLF001
    audio = drift_audio(s, hops)
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    dev_meta = StreamMeta(*(x.to(dev) for x in meta))
    carries = {"card": engine.init(s, device=dev), "f32": engine.init(s, device=dev), "cpu": engine.init(s, device="cpu")}
    tally = {"card": DriftTally(), "f32": DriftTally()}
    corrections = ("freq_hz", "power_rel", "time_at_peak")
    worst = {k: dict.fromkeys(corrections, 0.0) for k in tally}
    loud = {"lufs": 0.0, "true_peak": 0.0}
    before = reassigned_sliding_hop.launches
    columns, cpu_s = 0, 0.0
    for h in range(hops):
        blk = torch.from_numpy(np.ascontiguousarray(audio[:, h * b:(h + 1) * b]))
        snaps = {}
        carries["card"], snaps["card"] = engine.step(carries["card"], blk.to(dev), dev_meta)
        with f32_plain_hop():
            carries["f32"], snaps["f32"] = engine.step(carries["f32"], blk.to(dev), dev_meta)
        t1 = time.perf_counter()
        carries["cpu"], snaps["cpu"] = engine.step(carries["cpu"], blk, meta)
        cpu_s += time.perf_counter() - t1
        since = (carries["cpu"]["spectrogram"]["srs"]["count"] - 1) % refresh
        ref = snaps["cpu"]["spectrogram"]
        columns += int(ref.valid.sum())
        for k in ("card", "f32"):
            sg = snaps[k]["spectrogram"]
            check(bool(torch.equal(sg.valid.cpu(), ref.valid)), f"phase 24a {k} hop {h}: valid differs")
            tally[k].add(h, since, sg.time_offset, ref.time_offset, ref.power, ref.valid)
            err, _ = errors_of((sg.freq_hz, sg.time_offset, sg.power), (ref.freq_hz, ref.time_offset, ref.power),
                               ref.valid, drift=True)
            for key in corrections:
                worst[k][key] = max(worst[k][key], err[key])
        la, lc = snaps["card"]["loudness"], snaps["cpu"]["loudness"]
        for f in la._fields:
            e = float((getattr(la, f).cpu() - getattr(lc, f)).abs().max())
            key = "true_peak" if f == "true_peak_db" else "lufs"
            loud[key] = max(loud[key], e)
    launches = reassigned_sliding_hop.launches - before
    summary = {k: v.summary() for k, v in tally.items()}
    for k, label in (("card", "card (B2)"), ("f32", "f32 plain hop on the card")):
        log(f"phase 24a {label} against the CPU's float64 hop, free-running, S={s}, {hops} hops: "
            f"{fmt_drift(summary[k])}")
    fmt = ", ".join
    log(f"phase 24a corrections against the CPU: card {fmt(f'{k} {v:.3e}' for k, v in worst['card'].items())}; "
        f"f32 plain hop {fmt(f'{k} {v:.3e}' for k, v in worst['f32'].items())}")
    for k in tally:
        worst[k].update({"time within 50 dB": summary[k]["max_hops"][0], "time 50-60 dB": summary[k]["max_hops"][1]})
    bars = {"time within 50 dB": DRIFT_TIME_HOPS[0], "time 50-60 dB": DRIFT_TIME_HOPS[1], "freq_hz": FREQ_HZ,
            "power_rel": POWER_REL, "time_at_peak": TIME_AT_PEAK}
    near = check_near_reference(worst["card"], worst["f32"], bars, "phase 24a card against the CPU")
    for ok, what in (
        (loud["lufs"] <= LOUDNESS_LU, f"loudness differs by {loud['lufs']}"),
        (loud["true_peak"] <= TRUE_PEAK_DB, f"true peak differs by {loud['true_peak']}"),
        (launches == hops, f"B2 launched {launches} times in {hops} hops"),
        (columns > 0, "no valid column"),
    ):
        check(ok, f"phase 24a: {what}")
    secs = time.perf_counter() - t0
    log(f"phase 24a rule (utils/parity.py::check_near_reference): the card within max(bar, 1.5 x the f32 plain "
        f"hop's) = {fmt(f'{k} {v:.3e}' for k, v in near.items())}: held; {columns} valid columns; loudness "
        f"{loud['lufs']:.3e} LU/dB, true peak {loud['true_peak']:.3e} dB; B2 launched {launches} times; {secs:.1f} s "
        f"({cpu_s:.1f} s of it the CPU's steps) [{card_line()}]")
    return {"card": summary["card"], "f32": summary["f32"], "limits": near, "errors": worst, "seconds": secs}


class CardProgramme:
    """Programme-like stereo audio made on the card a block at a time, for
    ``s`` streams: stream ``i % 3`` a tone (40 Hz to 8 kHz, log-uniform),
    noise, or both, at unit RMS, times a level that holds for
    ``LONG_SECTION`` hops and then steps by 6 to 20 dB within -40 to -8
    dBFS, about one section in six at -85 to -78 dBFS (below the -70 LUFS
    gate).  The right channel is the left one's tone at 0.8 plus noise of
    its own.  From ``seed`` (the levels, tones, and the card's noise
    generator).  Blocks are made ``CHUNK`` hops at a time; the first
    ``kept`` streams' audio is kept on the card (``self.kept``)."""

    CHUNK = 64

    def __init__(self, s: int, hops: int, dev, seed: int = SEED + 25, kept: int = 4):
        rng = np.random.default_rng(seed)
        sections = hops // LONG_SECTION + 1
        levels = np.empty((s, sections))
        for i in range(s):
            level = rng.uniform(-30.0, -15.0)
            for j in range(sections):
                if rng.random() < 1.0 / 6.0:
                    levels[i, j] = rng.uniform(-85.0, -78.0)
                    continue
                step = rng.uniform(6.0, 20.0) * rng.choice([-1.0, 1.0])
                if not -40.0 <= level + step <= -8.0:
                    step = float(np.clip(level - step, -40.0, -8.0)) - level
                level = levels[i, j] = level + step
        kind = np.arange(s) % 3
        self.gain = torch.from_numpy(10.0 ** (levels / 20.0)).to(dev)
        self.freq = torch.from_numpy(np.exp(rng.uniform(np.log(40.0), np.log(8000.0), s))).to(dev)[:, None]
        self.phase = torch.from_numpy(rng.uniform(0.0, 2 * np.pi, s)).to(dev)[:, None]
        self.tone = torch.from_numpy(np.where(kind == 1, 0.0, np.where(kind == 0, np.sqrt(2.0), 1.0))).to(dev)[:, None]
        self.noise = torch.from_numpy(np.where(kind == 0, 0.0, np.where(kind == 1, 1.0, np.sqrt(0.5)))).to(dev)[:, None]
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.offsets = torch.arange(self.CHUNK * 256, device=dev, dtype=torch.float64)
        self.s, self.dev, self.hops = s, dev, hops
        self.kept = torch.empty((kept, hops * 256, 2), dtype=torch.float32, device=dev)
        self.start, self.chunk = -1, None

    def _make(self, h0: int) -> None:
        """Hops ``h0`` to ``h0 + CHUNK`` as ``[CHUNK, s, 256, 2]``."""
        n = self.CHUNK * 256
        t = (h0 * 256 + self.offsets) / 48_000.0  # float64: exact past 2^24 samples
        tone = torch.sin(2 * math.pi * self.freq * t + self.phase) * self.tone
        noise = torch.randn((self.s, n, 2), generator=self.gen, device=self.dev, dtype=torch.float64)
        x = torch.stack([tone + noise[..., 0] * self.noise, 0.8 * tone + noise[..., 1] * self.noise], -1)
        hop = torch.arange(h0, h0 + self.CHUNK, device=self.dev).repeat_interleave(256) // LONG_SECTION
        x = (x * self.gain[:, hop.clamp_max(self.gain.shape[1] - 1), None]).float()
        stop = min(n, (self.hops - h0) * 256)
        self.kept[:, h0 * 256:h0 * 256 + stop] = x[:self.kept.shape[0], :stop]
        self.chunk = x.reshape(self.s, self.CHUNK, 256, 2).transpose(0, 1)
        self.start = h0

    def block(self, h: int) -> torch.Tensor:
        """Hop ``h``'s block ``[s, 256, 2]`` (hops come in order)."""
        if self.chunk is None or not self.start <= h < self.start + self.CHUNK:
            self._make(h - h % self.CHUNK)
        return self.chunk[h - self.start]


def last_frames(analyzer, carry: dict, ready: int) -> dict:
    """The framing ``info`` of the hop that produced ``carry``, rebuilt from
    it (its ``ready`` columns, read from the ring)."""
    fb = analyzer._frames  # noqa: SLF001
    avail = carry["fb"]["avail"] + ready * fb.hop
    return {"buf": carry["fb"]["buf"], "base": (carry["fb"]["origin"] - avail) % fb.cap, "ready": ready}


def state_errors(ours, exact) -> list:
    """The largest error of each complex state of ``ours`` (real and
    imaginary parts in turn, each ``[S, bins]``) against ``exact``, as a
    share of that state's row maximum."""
    out = []
    for i in range(0, len(exact), 2):
        scale = torch.clamp_min(torch.hypot(exact[i], exact[i + 1]).amax(1, keepdim=True), 1e-30)
        d = torch.maximum((ours[i].double() - exact[i]).abs(), (ours[i + 1].double() - exact[i + 1]).abs())
        out.append(float((d / scale).max()))
    return out


def exact_last_column(engine, carry: dict):
    """The spectrogram's sliding state after the hop that produced
    ``carry`` and its last column, recomputed exactly in float64 on the
    host from the rings.  Classic (no state: each column comes from its
    frame): the column the per-column path (DC removed, windowed rFFT, dB,
    u16 codes) on the last window.  Reassigned: the eight states are the
    rFFTs of the last window's raw and Hilbert crops and their
    ramp-weighted copies, the column the hop's corrections on them.
    Returns ``(states, exact states, codes [S, bins] or (freq, time,
    power))``."""
    from openmeters_tpu_torch.ops.reassigned_hop import _column
    from openmeters_tpu_torch.ops.sliding_reassigned import STATE_KEYS

    sg = engine.analyzers["spectrogram"]
    host = _carry_to(carry["spectrogram"], "cpu")
    if not sg.config.use_reassignment:
        fb = sg._frames  # noqa: SLF001
        info = last_frames(sg, host, fb.cols_cap)
        frames = fb.extract(info)[:, -1].double()
        return (), (), sg._classic(frames[:, None], None).codes[:, 0]  # noqa: SLF001
    sr = sg._sliding_reassigned  # noqa: SLF001
    info = last_frames(sg, host, sr.cols_cap)
    info = {**info, "buf": info["buf"].double(), "base": info["base"] + (sr.cols_cap - 1) * sr.hop}
    t = sr._tensors(torch.device("cpu"))  # noqa: SLF001
    exact = sr._exact_states(info, host["srs"]["hx"].double(), t["ramp"].double())  # noqa: SLF001
    column = _column(exact, t["normq"].double(), t["freqb"].double(), n=sr.n, zpf=sr.zpf, coeffs=sr.coeffs(),
                     inv_2pi=sr.sample_rate / (2.0 * np.pi), inv_hop=1.0 / sr.hop, latency_hops=sr.center / sr.hop)
    return tuple(host["srs"][k] for k in STATE_KEYS), exact, column


def exact_errors(engine, carry: dict, snaps: dict) -> dict:
    """The last spectrogram column of the hop against
    :func:`exact_last_column`: classic, the largest code difference at
    valid bins within 60 dB of the exact column's peak (phase 4's held
    bins); reassigned, ``reassigned_errors`` with ``drift`` (phase 8's
    bars), the time where the exact time offset lies within the window
    (``window_hops``: elsewhere B sits near a zero and the time is the
    ratio of two cancelling sums).  With each state's distance from the
    exact one as a share of its row maximum (``state_u``: U; ``state_v``: the ramp-weighted V)."""
    from openmeters_tpu_torch.utils.parity import reassigned_errors as errors_of

    sg = snaps["spectrogram"]
    valid = sg.valid[:, -1].cpu()
    check(bool(valid.all()), "a stream's last column is not valid")
    states, exact_states, exact = exact_last_column(engine, carry)
    errs = state_errors(states, exact_states)
    if isinstance(exact, torch.Tensor):
        ref = exact.to(torch.int32)
        d = ((sg.codes[:, -1].cpu().to(torch.int32) - ref).abs() * resolved_bins(ref, valid)).max()
        return {"codes": int(d)}
    sr = engine.analyzers["spectrogram"]._sliding_reassigned  # noqa: SLF001
    err, _ = errors_of((sg.freq_hz[:, -1].cpu(), sg.time_offset[:, -1].cpu(), sg.power[:, -1].cpu()),
                       exact, valid, drift=True, window_hops=sr.n / sr.hop)
    return {"state_u": max(errs[:2]), "state_v": max(errs[2:]), **err}


def exact_bars() -> dict:
    """The bars of :func:`exact_errors`' held errors."""
    return {"codes": 2, **reassigned_bars()}


def fold_snapshots(snaps: dict, sink: torch.Tensor) -> torch.Tensor:
    """``sink`` plus the sum of every leaf of every snapshot, in float64 on
    the card: each output is read, and a non-finite one leaves the sum
    non-finite."""
    leaves = [leaf for snap in snaps.values() for leaf in snap]
    return sink + torch.stack([leaf.sum(dtype=torch.float64) for leaf in leaves]).sum()


def phase24b_long_run(dev, label: str, cfg, counter, s: int = 64, hops: int = LONG_HOPS) -> dict:
    """``cfg`` at S=64 over ``hops`` hops of :class:`CardProgramme` audio
    (past 2^24 samples), steps chained through ``MeterEngine.step`` and
    every snapshot leaf folded into a float64 checksum on the card, with
    synchronizing calls made errors (``torch.cuda.set_sync_debug_mode``)
    between the checks from hop 64 on (the first hops copy the analyzers'
    constants to the card).  Every ``LONG_CHECK_EVERY`` hops, on the hop
    before a re-anchor and on the re-anchor hop, the last column is held
    against the exact recompute from the rings (:func:`exact_errors`), and
    so is the hop's f32 plain version, which steps the 33 hops up to the
    check on the card from a copy of the card's carry, through the
    re-anchor before it; the card's largest errors over the checks are held
    within their bars, or within ``REFERENCE_MULTIPLE`` times the f32 plain
    version's largest (``check_near_reference``).  For the last
    ``LONG_TAIL`` hops the CPU steps each hop from a copy of the card's
    carry, held by ``check_snapshots``; the reassigned columns there by the
    same rule against the hop's f32 plain version from the card's state.
    At the end four streams' integrated loudness and LRA against
    ``tests/ebur_ref.py`` within 0.02 and 0.2 LU."""
    from openmeters_tpu_torch.engine import MeterEngine, StreamMeta
    from openmeters_tpu_torch.utils.parity import check_near_reference, check_snapshots

    t0 = time.perf_counter()
    engine = MeterEngine(cfg)
    refresh = 32
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    dev_meta = StreamMeta(*(x.to(dev) for x in meta))
    audio = CardProgramme(s, hops, dev)
    carry = engine.init(s, device=dev)
    sink = torch.zeros((), dtype=torch.float64, device=dev)
    checks, plain_checks, tail, plain_tail = {}, {}, {}, {}
    launches0 = counter.launches
    chained = hops - LONG_TAIL
    steady, steady_hops = 0.0, 0

    def hop(h, cpu=None, plain=None):
        nonlocal carry, sink
        blk = audio.block(h)
        carry, snaps = engine.step(carry, blk, dev_meta)
        sink = fold_snapshots(snaps, sink)
        out = [snaps, None, None]
        if cpu is not None:
            out[1:] = engine.step(cpu, blk.cpu(), meta)
        if plain is not None:
            with f32_plain_hop():
                out[1:] = engine.step(plain, blk, dev_meta)
        return out

    def held_against_exact(h, snaps, plain, plain_snaps):
        checks[h] = exact_errors(engine, carry, snaps)
        plain_checks[h] = exact_errors(engine, plain, plain_snaps)

    start = 2 * refresh
    for h in range(start):  # the first window, anchors and constants (copied to the card on first use)
        hop(h)
    for m in range(1, chained // LONG_CHECK_EVERY + 1):
        shadow = m * LONG_CHECK_EVERY - refresh - 1  # the f32 plain hop joins here, before the re-anchor hop
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for h in range(start, shadow):
                hop(h)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        steady += time.perf_counter() - t1
        steady_hops += shadow - start
        plain = _carry_to(carry, dev)
        for h in range(shadow, m * LONG_CHECK_EVERY + 1):
            snaps, plain, plain_snaps = hop(h, plain=plain)
            if h >= m * LONG_CHECK_EVERY - 1:  # the hop before a re-anchor, then the re-anchor hop
                held_against_exact(h, snaps, plain, plain_snaps)
        start = m * LONG_CHECK_EVERY + 1
    for h in range(start, chained):
        hop(h)
    chained_s = time.perf_counter() - t0
    reassigned = engine.analyzers["spectrogram"].use_sliding_reassigned
    for h in range(chained, hops):
        if reassigned:  # the hop's f32 plain version from the same state, on the card
            with f32_plain_hop():
                _, plain_snaps = engine.step(_carry_to(carry, dev), audio.block(h), dev_meta)
        snaps, cpu, cpu_snaps = hop(h, _carry_to(carry, "cpu"))
        where = f"{label} hop {h}, card against CPU from the card's state"
        err = check_snapshots({k: v for k, v in snaps.items() if not (reassigned and k == "spectrogram")},
                              {k: v for k, v in cpu_snaps.items() if not (reassigned and k == "spectrogram")}, where)
        tail[h] = {f"{name}.{key}": v for name, e in err.items() for key, v in e.items()}
        if reassigned:
            tail[h].update(reassigned_against(snaps["spectrogram"], cpu_snaps["spectrogram"], where))
            plain_tail[h] = reassigned_against(plain_snaps["spectrogram"], cpu_snaps["spectrogram"], where)
    launches = counter.launches - launches0
    ebur_ref = load_ebur_ref()
    lo = snaps["loudness"]
    x = audio.kept.cpu().numpy()
    loud = []
    for i in range(4):
        want = ebur_ref.integrated_lufs(x[i]), ebur_ref.loudness_range(x[i])
        loud.append((float(lo.integrated_lufs[i]) - want[0], float(lo.lra_lu[i]) - want[1]))
    secs = time.perf_counter() - t0

    def short(rows: dict) -> dict:
        return {k: float(f"{v:.3e}") for k, v in worst(rows).items()}

    key = "codes" if "codes" in next(iter(checks.values())) else "time_over_bar"
    log(f"{label}: {key} against the exact column at each check, the card / the f32 plain hop: "
        + ", ".join(f"{h} {checks[h][key]:.3g}/{plain_checks[h][key]:.3g}" for h in checks))

    log(f"{label} S={s}, {hops} hops ({hops * 256} samples, past 2^24 = {2**24}) of programme audio made on the card: "
        f"{chained} chained hops in {chained_s:.1f} s ({1e3 * steady / steady_hops:.4f} ms a hop between the checks, "
        f"no synchronizing call), checksum {float(sink):.6e}; {len(checks)} hops (before and on a re-anchor) against "
        f"the exact column, the largest errors: the card {short(checks)}, the f32 plain hop from the card's state 33 "
        f"hops earlier {short(plain_checks)}; the last {LONG_TAIL} hops against the CPU from the card's state: the "
        f"card {short(tail)}{f', the f32 plain hop {short(plain_tail)}' if plain_tail else ''}; "
        f"integrated and LRA of 4 streams against tests/ebur_ref.py (LU): "
        f"{[(float(f'{a:.2e}'), float(f'{b:.2e}')) for a, b in loud]}; {counter.__name__} launched {launches} "
        f"times; {secs:.1f} s [{card_line()}]")
    bars = {k: v for k, v in exact_bars().items() if k in next(iter(checks.values()))}
    check_near_reference(worst(checks), worst(plain_checks), bars, f"{label}: the card against the exact column")
    if reassigned:
        check_near_reference(worst(tail), worst(plain_tail), reassigned_bars(),
                             f"{label}: the card against the CPU from the card's state")
    check(bool(torch.isfinite(sink)), f"{label}: a non-finite output")
    check(launches == hops, f"{label}: {counter.__name__} launched {launches} times in {hops} hops")
    for i, (di, dl) in enumerate(loud):
        check(abs(di) <= INTEGRATED_LU, f"{label} stream {i}: integrated {di} LU off tests/ebur_ref.py")
        check(abs(dl) <= LRA_LU, f"{label} stream {i}: LRA {dl} LU off tests/ebur_ref.py")
    del audio, carry
    torch.cuda.empty_cache()
    return {"seconds": secs, "checks": worst(checks), "plain": worst(plain_checks), "tail": worst(tail),
            "ebur": loud, "launches": launches}


def worst(rows: dict) -> dict:
    """The largest of each number over ``rows`` (``{hop: {name: number}}``;
    ``power_abs_all`` left out)."""
    keys = {k for r in rows.values() for k, v in r.items() if isinstance(v, (int, float)) and k != "power_abs_all"}
    return {k: max(r.get(k, 0) for r in rows.values()) for k in sorted(keys)}


def reassigned_bars() -> dict:
    from openmeters_tpu_torch.utils.parity import FREQ_HZ, POWER_REL, TIME_AT_PEAK

    return {"freq_hz": FREQ_HZ, "power_rel": POWER_REL, "time_over_bar": 1.0, "time_at_peak": TIME_AT_PEAK}


def reassigned_against(ours, cpu, where: str) -> dict:
    """One hop's reassigned columns against the CPU's (its float64 hop) by
    ``reassigned_errors`` with the drift bars; ``valid`` must be equal."""
    from openmeters_tpu_torch.utils.parity import reassigned_errors as errors_of

    check(bool(torch.equal(ours.valid.cpu(), cpu.valid)), f"{where}: valid differs")
    err, _ = errors_of((ours.freq_hz, ours.time_offset, ours.power), (cpu.freq_hz, cpu.time_offset, cpu.power),
                       cpu.valid, drift=True)
    return err


def load_ebur_ref():
    """``tests/ebur_ref.py`` of this checkout (the offline BS.1770 / EBU
    Tech 3342 computation), loaded by path."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "ebur_ref.py"
    spec = importlib.util.spec_from_file_location("ebur_ref", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LONG_RUNS = {"flagship": (flagship_config, "classic_columns"), "reassigned default": (reassigned_config,
                                                                                      "reassigned_sliding_hop")}


def phase24b_child(name: str) -> int:
    """``python3 chip_smoke.py --phase24b NAME``: one long run of phase 24b
    in a process of its own, on the kernel library phase 2 built; its
    result as JSON on the last line."""
    from openmeters_tpu_torch.ops import _build, classic_columns, reassigned_hop

    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)  # the host thread paces the run; 24a's CPU hop runs beside it
    _build.load_library()
    config, counter = LONG_RUNS[name]
    counter = getattr(reassigned_hop if counter.startswith("reassigned") else classic_columns, counter)
    out = phase24b_long_run(dev, f"phase 24b {name}", config(), counter)
    print(json.dumps(out, default=float))
    return 0


def start_long_runs() -> dict:
    """Start phase 24b's two long runs, each in a process of its own (each
    is paced by its host thread)."""
    here = Path(__file__).resolve()
    return {
        name: subprocess.Popen([sys.executable, str(here), "--phase24b", name], cwd=here.parent,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in LONG_RUNS
    }


def phase24_long(dev, procs: dict) -> dict:
    """Phase 24: 24a here, then the two long runs of 24b (``procs``, started
    before 23a) to their end."""
    t0 = time.perf_counter()
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads - 5, 2))  # cores for the two runs of 24b
    try:
        out["drift"] = phase24a_drift(dev)
    finally:
        torch.set_num_threads(threads)
    t1 = time.perf_counter()
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=900)
        lines = text.strip().splitlines()
        for line in lines[:-1] if proc.returncode == 0 else lines:
            log(f"(24b {name}) {line}")
        check(proc.returncode == 0, f"phase 24b {name} exited {proc.returncode}")
        out[name] = json.loads(lines[-1])
    log(f"phase 24 in {time.perf_counter() - t0:.1f} s: 24a {t1 - t0:.1f} s, then the rest of 24b's two runs "
        f"(in two processes since 23c's end), {out['flagship']['seconds']:.1f} s and "
        f"{out['reassigned default']['seconds']:.1f} s of their own")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--phase24b"]:
        return phase24b_child(sys.argv[2])
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
    for name, ops in tensor_core_sass().items():
        log(f"phase 2 {name}: tensor-core instructions {', '.join(ops)} in its SASS")

    kernel = phase3_kernel(dev)
    columns_kernel = phase3b_classic_columns(dev)
    gather_kernel = phase3c_ring_gather(dev)
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
    served20a = phase20_serving_s8192(dev, "phase 20a", EngineConfig(),
                                      ("reassigned_sliding_hop", "corr_dots_sums_ring", "window_rows",
                                       "three_band_scan"))
    torch.cuda.empty_cache()
    served20b = phase20_serving_s8192(dev, "phase 20b", flagship_config(), ("classic_columns",))
    torch.cuda.empty_cache()
    phase21_cli(dev)
    torch.cuda.empty_cache()
    phase22_display(dev, served20a)
    torch.cuda.empty_cache()
    procs = {}
    try:
        phase23_mesh(dev, served20a, served20b, after_served=lambda: procs.update(start_long_runs()))
        torch.cuda.empty_cache()
        phase24_long(dev, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def entry(name, source, replaces, n, k):
        extra = ("bound_f32_ms", "bound_tf32_ms", "bound_bytes_ms", "shapes")
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
                  "openmeters_tpu/ops/pallas_sliding.py:381", launches["sliding_hop"], kernel),
            # the classic spectrogram's columns, in place of B1a on that path
            entry("classic_columns", "openmeters_tpu_torch/csrc/classic_columns.cu",
                  "openmeters_tpu/ops/pallas_sliding.py:381", launches["classic_columns"], columns_kernel),
            # no pallas_call: the JAX package copies each hop's rows into a host batch and puts it on the device
            entry("ring_gather", "openmeters_tpu_torch/csrc/ring_gather.cu", "openmeters_tpu/serve.py:698",
                  served20b["launches"]["ring_gather"], gather_kernel),
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
