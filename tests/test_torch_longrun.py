"""PyTorch port, long runs: programme-like audio through the JAX package and
the port on the CPU, past the lengths the other parity tests cover.

The audio (``programme``) is stereo, made from a numpy seed: sections of
tones, noise and both, 1.5 to 8 s each, whose levels step by 6 to 20 dB
(so the loudness range is not trivial), with stretches below -70 LUFS for
the absolute gate; one stream restarts in the middle of the run.  Both
packages get the same audio and the same ``StreamMeta``.  The JAX package
runs ``MeterEngine.super_step`` jitted (a ``lax.scan`` over a chunk of
hops); the port runs ``MeterEngine.step`` hop by hop.

Held at every sampled hop (each ``every``-th and each of the last 200) by
``openmeters_tpu_torch/utils/parity.py::check_snapshots``: loudness within
0.01 LU/dB, true peak within 1e-3 dB, classic codes within 2 at valid bins
within 60 dB of their column's peak, the reassigned columns by the drift
bars.  The trailing-window loudness fields (short-term, momentary, RMS)
are also held to their float64 values from the audio: the JAX package
re-reduces its window sums in f32, and where loud audio has just left a
window that holds quiet audio its reading is off by up to 0.35 dB (the
slow case; 0.34 relative in ``test_windowed_means_exact_after_a_drop``).  There
the port is held to the exact value alone and the JAX package's miss is
recorded (``reference_off``).  At the end both packages' integrated loudness and loudness range are
held to ``tests/ebur_ref.py`` (the offline BS.1770 / EBU Tech 3342
computation over the audio since each stream's last start) within the JAX
package's own bars, 0.02 LU and 0.2 LU (tests/test_loudness_gating.py).

A run's length is a multiple of 300 hops (76,800 samples, 16 gating chunks
of 100 ms), and the restart falls on one too: the gating chunks then close
on the last hop and start on the restart's, as the offline blocks do.

The ``slow`` case runs the flagship for 114,000 hops (608 s of audio, past
2^24 samples, where an f32 count or position stops being exact); tier-1
runs it for 1,800 hops and the reassigned default for 600 (18 re-anchor
periods).  ``pytest -m slow tests/test_torch_longrun.py`` runs the slow
case alone.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ebur_ref  # noqa: E402
from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig as JSpecConfig  # noqa: E402
from openmeters_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from openmeters_tpu.engine import MeterEngine as JMeterEngine  # noqa: E402
from openmeters_tpu.engine import StreamMeta as JStreamMeta  # noqa: E402
from openmeters_tpu.ops import windowed as jwindowed  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta  # noqa: E402
from openmeters_tpu_torch.ops import windowed as twindowed  # noqa: E402
from openmeters_tpu_torch.utils.parity import (  # noqa: E402
    CLASSIC_CODES,
    LOUDNESS_LU,
    REFERENCE_MULTIPLE,
    TRUE_PEAK_DB,
    DriftTally,
    check_snapshots,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

RATE = 48_000
BLOCK = 256
WINDOW_SECONDS = (3.0, 0.4, 0.3, 1.0)  # short-term, momentary, RMS fast, RMS slow
LOUDNESS_OFFSET = -0.691
FLOOR_DB = -99.9
ALIGN = 300  # hops in 16 gating chunks: 300 * 256 = 16 * 4800
INTEGRATED_LU = 0.02  # tests/test_loudness_gating.py:116
LRA_LU = 0.2  # tests/test_loudness_gating.py:124
TAIL = 200


def programme(s: int, hops: int, seed: int) -> np.ndarray:
    """``[s, hops * 256, 2]`` float32 programme-like stereo audio.

    Each stream is a run of sections 1.5 to 8 s long: one to three tones
    (40 Hz to 8 kHz), noise (white, or low-passed), or both.  Each section's
    level steps 6 to 20 dB up or down from the last, within -40 to -8 dBFS
    RMS; about one section in six sits at -85 to -78 dBFS, below the -70
    LUFS absolute gate.  The right channel is the left one's tones at
    another gain plus noise of its own."""
    rng = np.random.default_rng(seed)
    n = hops * BLOCK
    out = np.empty((s, n, 2), np.float32)
    for i in range(s):
        pos, level = 0, rng.uniform(-30.0, -15.0)
        while pos < n:
            m = min(int(rng.uniform(1.5, 8.0) * RATE), n - pos)
            t = (pos + np.arange(m)) / RATE
            kind = rng.integers(3)  # tones, noise, both
            sec = np.zeros((m, 2))
            if kind != 1:
                for _ in range(rng.integers(1, 4)):
                    f = np.exp(rng.uniform(np.log(40.0), np.log(8000.0)))
                    tone = np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
                    sec += tone[:, None] * rng.uniform(0.3, 1.0, size=2)
            if kind != 0:
                noise = rng.standard_normal((m, 2))
                if rng.random() < 0.5:  # one-pole low-pass at ~1 kHz
                    a = np.exp(-2 * np.pi * 1000.0 / RATE)
                    for c in range(2):
                        noise[:, c] = _one_pole(noise[:, c], a)
                sec += noise * (0.5 if kind == 2 else 1.0)
            if rng.random() < 1.0 / 6.0:
                target = rng.uniform(-85.0, -78.0)
            else:
                step = rng.uniform(6.0, 20.0) * rng.choice([-1.0, 1.0])
                if not -40.0 <= level + step <= -8.0:
                    step = float(np.clip(level - step, -40.0, -8.0)) - level
                level = target = level + step
            rms = np.sqrt(np.mean(sec * sec))
            out[i, pos:pos + m] = sec * (10.0 ** (target / 20.0) / max(rms, 1e-12))
            pos += m
    return out


def _one_pole(x: np.ndarray, a: float) -> np.ndarray:
    from scipy.signal import lfilter

    return lfilter([1.0 - a], [1.0, -a], x)


def _configs(reassigned: bool):
    kw = dict(spectrum=None, oscilloscope=None, stereometer=None, waveform=None, channels=2)
    return (
        JEngineConfig(spectrogram=JSpecConfig(fft_size=2048, hop_size=64, use_reassignment=reassigned), **kw),
        EngineConfig(spectrogram=SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=reassigned), **kw),
    )


def exact_windows(audio: np.ndarray, restart: int, hops: list) -> dict:
    """The trailing-window loudness fields at the ends of ``hops``, in
    float64 from the audio: K-weighting (the JAX package's sections) from
    each stream's start or restart, then the mean square of the last ``W`` samples
    (all of them while fewer have come), as ``LoudnessSnapshot`` reads
    them.  ``{field: [len(hops), S] or [len(hops), S, C]}``."""
    from scipy.signal import sosfilt

    from openmeters_tpu.utils.weighting import k_weighting_sos

    sos = k_weighting_sos(float(RATE))
    lengths = [int(RATE * w) for w in WINDOW_SECONDS]
    hops = np.asarray(hops)
    s = audio.shape[0]
    ms = np.zeros((len(WINDOW_SECONDS), len(hops), s, 2))
    for i in range(s):
        for start, stop in ((0, restart), (restart, None)) if i == 1 else ((0, None),):
            x = audio[i, start * BLOCK:None if stop is None else stop * BLOCK]
            kx = sosfilt(sos, x.astype(np.float64), axis=0)
            csum = np.concatenate([np.zeros((1, 2)), np.cumsum(kx * kx, axis=0)])
            del kx
            at = (hops >= start) & (hops < (stop if stop is not None else hops.max() + 1))
            end = (hops[at] + 1 - start) * BLOCK
            for w, length in enumerate(lengths):
                ms[w, at, i] = (csum[end] - csum[np.maximum(end - length, 0)]) / np.minimum(end, length)[:, None]
    lufs = LOUDNESS_OFFSET + 10.0 * np.log10(np.maximum(ms[:2].sum(-1), 1e-300))
    db = 10.0 * np.log10(np.maximum(ms[2:], 1e-300))
    return {
        "short_term_lufs": np.maximum(lufs[0], FLOOR_DB), "momentary_lufs": np.maximum(lufs[1], FLOOR_DB),
        "rms_fast_db": np.maximum(db[0], FLOOR_DB), "rms_slow_db": np.maximum(db[1], FLOOR_DB),
    }


def exact_codes(analyzer, audio: np.ndarray, h: int, valid) -> torch.Tensor:
    """The classic spectrogram's columns of hop ``h`` computed per column in
    float64 from the audio (``_classic``: DC removed, windowed rFFT, dB,
    u16 codes): column k's window ends ``(3 - k) * 64`` samples before the
    hop's last sample."""
    mid = 0.5 * (audio[..., 0].astype(np.float64) + audio[..., 1])
    n, hop = analyzer.config.fft_size, analyzer.config.hop_size
    ends = [(h + 1) * BLOCK - (3 - k) * hop for k in range(4)]
    frames = np.stack([mid[:, max(e - n, 0):e] if e >= n else np.zeros((mid.shape[0], n)) for e in ends], 1)
    return analyzer._classic(torch.from_numpy(frames), valid).codes  # noqa: SLF001


def hold_classic(ours, ref, exact: torch.Tensor, where: str, reference_off: dict) -> None:
    """Hold the port's classic columns to the JAX package's (``valid``
    equal; codes within 2 at valid bins within 60 dB of the exact column's
    peak).  Where either package is more than 2 codes off the exact
    columns there (the f32 sliding states after a large drop in level,
    ROADMAP section C), hold the port within 1.5 times the JAX package's
    own distance from them instead, and count the hop in
    ``reference_off["codes"]`` as ``(hops, the port's largest, the JAX
    package's largest)``."""
    valid = torch.from_numpy(np.asarray(ref.valid))
    assert torch.equal(ours.valid, valid), where
    exact = exact.to(torch.int64)
    held = chip_smoke.resolved_bins(exact, valid)

    def off(a):
        return int(((torch.as_tensor(np.asarray(a)).to(torch.int64) - exact).abs() * held).max())

    port, jax_off = off(ours.codes), off(ref.codes)
    if max(port, jax_off) <= CLASSIC_CODES:
        gap = int(((ours.codes.to(torch.int64) - torch.from_numpy(np.asarray(ref.codes).astype(np.int64))).abs()
                   * held).max())
        assert gap <= CLASSIC_CODES, f"{where}: codes differ from the JAX package's by {gap}"
        return
    hops, most, jax_most = reference_off.get("codes", (0, 0, 0))
    reference_off["codes"] = (hops + 1, max(most, port), max(jax_most, jax_off))
    assert port <= max(CLASSIC_CODES, REFERENCE_MULTIPLE * jax_off), (
        f"{where}: codes {port} off the exact columns, the JAX package's {jax_off}")


def hold_hop(tsnaps: dict, jsnaps: dict, exact: dict, where: str, reference_off: dict) -> None:
    """Hold one hop of the port against the JAX package by
    ``check_snapshots``' bars (classic columns by :func:`hold_classic`
    against ``exact["codes"]``), and the port's trailing-window loudness
    fields against ``exact`` (:func:`exact_windows`) too.  Where the JAX
    package's window field itself is off the exact value by more than its
    bar, the port is held to the exact value alone there;
    ``reference_off[field]`` is ``(streams so counted, the JAX package's
    largest distance from the exact value)``."""
    classic = "codes" in exact
    if classic:
        hold_classic(tsnaps["spectrogram"], jsnaps["spectrogram"], exact["codes"], where, reference_off)
    check_snapshots({k: v for k, v in tsnaps.items() if k not in ("loudness", "spectrogram" if classic else "")},
                    {k: v for k, v in jsnaps.items() if k not in ("loudness", "spectrogram" if classic else "")},
                    where)
    tl, jl = tsnaps["loudness"], jsnaps["loudness"]
    for f in tl._fields:
        ours, ref = getattr(tl, f).double().numpy(), np.asarray(getattr(jl, f), np.float64)
        bar = TRUE_PEAK_DB if f == "true_peak_db" else LOUDNESS_LU
        assert ours.shape == ref.shape, (where, f)
        held = np.ones(ref.shape, bool)
        if f in exact and f != "codes":
            off = np.abs(ours - exact[f]).max()
            assert off <= bar, f"{where}: {f} is {off} off the exact trailing window"
            held = np.abs(ref - exact[f]) <= bar
            count, largest = reference_off.get(f, (0, 0.0))
            reference_off[f] = (count + int((~held).sum()), max(largest, float(np.abs(ref - exact[f]).max())))
        gap = np.abs(ours - ref)[held].max(initial=0.0)
        assert gap <= bar, f"{where}: {f} differs from the JAX package's by {gap}"


def run_long(reassigned: bool, hops: int, every: int, chunk: int, seed: int, s: int = 2) -> dict:
    """Both packages over ``hops`` hops of :func:`programme` audio at ``s``
    streams, stream 1 restarting at the hop halfway (rounded down to a
    multiple of ``ALIGN``).  Each ``every``-th hop and each of the last 200
    are held by :func:`hold_hop`.  Returns both packages' last loudness
    snapshots, the audio, the restart hop, the hops held and the
    ``reference_off`` counts."""
    assert hops % ALIGN == 0 and hops % chunk == 0
    jcfg, tcfg = _configs(reassigned)
    audio = programme(s, hops, seed)
    restart = (hops // 2) // ALIGN * ALIGN
    resets = np.zeros((hops, s), bool)
    resets[restart, 1] = True
    held = [h for h in range(hops) if (h + 1) % every == 0 or h >= hops - TAIL]
    exact = exact_windows(audio, restart, held)
    at = {h: j for j, h in enumerate(held)}

    jeng, teng = JMeterEngine(jcfg), MeterEngine(tcfg)
    jmeta = JStreamMeta.default(s, channels=2, pad_channels=2)
    tmeta = StreamMeta.default(s, channels=2, pad_channels=2)
    jcarry, tcarry = jeng.init(s), teng.init(s, device="cpu")
    jstep = jax.jit(jeng.super_step)
    reference_off = {}
    for c0 in range(0, hops, chunk):
        blocks = np.ascontiguousarray(
            audio[:, c0 * BLOCK:(c0 + chunk) * BLOCK].reshape(s, chunk, BLOCK, 2).transpose(1, 0, 2, 3))
        jcarry, jsnaps = jstep(jcarry, blocks, jmeta, resets[c0:c0 + chunk])
        jsnaps = jax.device_get(jsnaps)
        for k in range(chunk):
            h = c0 + k
            rst = torch.from_numpy(resets[h]) if resets[h].any() else None
            tcarry, tsnaps = teng.step(tcarry, torch.from_numpy(blocks[k]), tmeta, rst)
            if h in at:
                ref = {name: type(snap)(*(np.asarray(x)[k] for x in snap)) for name, snap in jsnaps.items()}
                ex = {f: v[at[h]] for f, v in exact.items()}
                if not reassigned:
                    ex["codes"] = exact_codes(teng.analyzers["spectrogram"], audio, h, tsnaps["spectrogram"].valid)
                hold_hop(tsnaps, ref, ex, f"hop {h}", reference_off)
    jl = jsnaps["loudness"]
    return {"port": tsnaps["loudness"], "jax": type(jl)(*(np.asarray(x)[-1] for x in jl)), "audio": audio,
            "restart": restart, "held": len(held), "reference_off": reference_off}


def lra_nearest_rank(x: np.ndarray) -> float:
    """``ebur_ref.loudness_range`` with its percentiles read at the nearest
    rank, ``ceil(q N)`` of the N gated short-term blocks, as the meters'
    histograms read them (``ebur_ref`` reads rank ``round(q (N - 1)) +
    1``).  EBU Tech 3342 fixes no rank; for the few dozen blocks of a
    short run the two readings part by up to 2.4 LU on this audio."""
    blocks = ebur_ref._block_loudness(ebur_ref.k_weight(x), RATE, 3.0, 0.1, None)
    z = 10.0 ** ((blocks - ebur_ref.OFFSET) / 10.0)
    gated = blocks > ebur_ref.ABS_GATE
    if not gated.any():
        return 0.0
    gate = ebur_ref.OFFSET + 10.0 * np.log10(z[gated].mean()) - 20.0
    keep = np.sort(blocks[gated & (blocks > gate)])
    if keep.size == 0:
        return 0.0
    n = keep.size
    return float(keep[int(np.ceil(0.95 * n)) - 1] - keep[int(np.ceil(0.10 * n)) - 1])


def check_against_ebur(out: dict, nearest_rank: bool) -> dict:
    """Both packages' last integrated loudness and LRA against
    ``ebur_ref`` over each stream's audio since its last start: within
    0.02 LU and 0.2 LU.  With ``nearest_rank`` the LRA is held to
    :func:`lra_nearest_rank` instead.  Returns the differences."""
    audio, restart = out["audio"], out["restart"]
    errors = {}
    for i in range(audio.shape[0]):
        x = audio[i, restart * BLOCK:] if i == 1 else audio[i]
        want_i = ebur_ref.integrated_lufs(x)
        want_lra = lra_nearest_rank(x) if nearest_rank else ebur_ref.loudness_range(x)
        for side in ("port", "jax"):
            snap = out[side]
            got_i = float(np.asarray(snap.integrated_lufs)[i])
            got_lra = float(np.asarray(snap.lra_lu)[i])
            errors[f"{side} stream {i}"] = (float(got_i - want_i), float(got_lra - want_lra))
            assert abs(got_i - want_i) <= INTEGRATED_LU, (side, i, got_i, want_i)
            assert abs(got_lra - want_lra) <= LRA_LU, (side, i, got_lra, want_lra)
    return errors


@pytest.fixture
def one_thread():
    """The port's hop at S=2 runs fastest on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize(
    "reassigned,hops,every",
    [
        (False, 1_800, 100),  # the flagship, 9.6 s
        (True, 600, 100),  # the reassigned default, 3.2 s: 18 re-anchor periods
    ],
)
def test_long_run_matches_jax_and_ebur(reassigned, hops, every, one_thread, record_property):
    out = run_long(reassigned, hops, every, chunk=ALIGN, seed=15)
    record_property("reference_off", out["reference_off"])
    record_property("ebur", check_against_ebur(out, nearest_rank=True))
    assert out["held"] == (hops - TAIL) // every + TAIL


@pytest.mark.slow
def test_flagship_ten_minutes(one_thread, record_property):
    """The flagship for 114,000 hops (608 s), past 2^24 samples."""
    hops = 114_000
    assert hops * BLOCK > 2**24
    out = run_long(False, hops, 1_000, chunk=1_000, seed=15)
    record_property("reference_off", out["reference_off"])
    record_property("ebur", check_against_ebur(out, nearest_rank=False))


def test_windowed_means_exact_after_a_drop(record_property):
    """The loudness windows (3, 0.4, 0.3 and 1 s at 48 kHz) after 700 hops
    of loud blocks and 700 of blocks 70 dB quieter, each mean held to the
    float64 trailing mean of the pushed values within 1e-5 relative at
    every push.  The re-reductions every 32 pushes land while a window
    spans both levels: summed in f32, as the JAX package sums them, the
    error of ~1e-7 of the loud blocks stayed in the quiet sums until the
    next one (``reference_rel`` records the JAX package's)."""
    b, lanes = BLOCK, (3, 2)
    lengths = tuple(int(RATE * w) for w in WINDOW_SECONDS)
    tw, jw = twindowed.BlockWindowedMeans(b, lengths), jwindowed.BlockWindowedMeans(b, lengths)
    tc, jc = tw.init(lanes), jw.init(lanes)
    jpush, jmeans = jax.jit(jw.push_block), jax.jit(jw.means)
    rng = np.random.default_rng(21)
    pushes = 1_400
    values = rng.random((pushes, b, *lanes)).astype(np.float32)
    values[pushes // 2:] *= np.float32(1e-7)
    csum = np.concatenate([np.zeros((1, *lanes)), np.cumsum(values.reshape(-1, *lanes), axis=0, dtype=np.float64)])
    ours, ref = [], []
    for i in range(pushes):
        tc = tw.push_block(tc, torch.from_numpy(values[i]))
        jc = jpush(jc, jnp.asarray(values[i]))
        if i >= pushes // 2:
            ours.append(tw.means(tc).double().numpy())
            ref.append(np.asarray(jmeans(jc), np.float64))
    end = (np.arange(pushes // 2, pushes) + 1) * b
    exact = np.stack([(csum[end] - csum[end - n]) / n for n in lengths], axis=1)  # [pushes, windows, lanes]
    port = np.abs(np.stack(ours) / exact - 1.0).max(axis=(1, 2, 3))
    record_property("port_rel", float(port.max()))
    record_property("reference_rel", float(np.abs(np.stack(ref) / exact - 1.0).max()))
    assert port.max() <= 1e-5, (int(port.argmax()) + pushes // 2, float(port.max()))


def test_f32_plain_hop_against_float64(one_thread, record_property):
    """The reassigned default's sliding hop as its f32 plain version
    against the port's CPU path (the float64 plain hop), both free-running
    over 640 hops (20 re-anchor periods) of the first six streams of
    ``chip_smoke.py`` phase 24a's audio, the time error tallied at the held
    bins as a multiple of ``DRIFT_TIME_HOPS``.  The f32 hop crosses the
    bar: no f32 hop holds it against float64 over a run, so the card (B2)
    is held to ``REFERENCE_MULTIPLE`` times the f32 plain hop's own distance
    (``check_near_reference``).  Readings: max 1.27 of the bar, 21 bins over
    1.0 (52 to 59 dB down, 10 to 31 hops after a re-anchor), 99.9th
    percentile 0.130."""
    s, hops = 6, 640
    engine = MeterEngine(chip_smoke.reassigned_config())
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    audio = chip_smoke.drift_audio(s, hops)
    outs = {}
    for name in ("float64", "f32"):
        carry, cols = engine.init(s, device="cpu"), []
        for h in range(hops):
            blk = torch.from_numpy(np.ascontiguousarray(audio[:, h * BLOCK:(h + 1) * BLOCK]))
            if name == "f32":
                with chip_smoke.f32_plain_hop():
                    carry, snaps = engine.step(carry, blk, meta)
            else:
                carry, snaps = engine.step(carry, blk, meta)
            cols.append((snaps["spectrogram"], (carry["spectrogram"]["srs"]["count"] - 1) % 32))
        outs[name] = cols
    tally = DriftTally()
    for h, ((ref, since), (ours, _)) in enumerate(zip(outs["float64"], outs["f32"])):
        assert torch.equal(ours.valid, ref.valid), h
        tally.add(h, since, ours.time_offset, ref.time_offset, ref.power, ref.valid)
    got = tally.summary()
    record_property("drift", {k: v for k, v in got.items() if k != "worst"})
    record_property("worst", got["worst"])
    assert got["over"] > 0 and got["max_ratio"] > 1.0, got  # the f32 hop has the tail
    assert got["p999_ratio"] <= 0.5, got
    assert got["max_ratio"] <= 2.5, got


def test_drift_tally_reads_bands_percentiles_and_crossings():
    """``DriftTally`` on made-up columns: one stream, one column of four
    bins at 0, 45, 55 and 70 dB below the peak; the held bins' time errors
    over their bars (0.015 hop within 50 dB, 0.03 beyond), the 70 dB bin
    not held."""
    from openmeters_tpu_torch.utils.parity import check_near_reference

    power = torch.tensor([[[1.0, 10 ** -4.5, 10 ** -5.5, 1e-7]]])
    ref_time = torch.zeros((1, 1, 4))
    valid = torch.ones((1, 1), dtype=torch.bool)
    tally = DriftTally()
    tally.add(0, 5, torch.tensor([[[0.0015, 0.018, 0.015, 9.0]]]), ref_time, power, valid)
    tally.add(1, 6, torch.tensor([[[0.0, 0.0075, 0.006, 9.0]]]), ref_time, power, valid)
    got = tally.summary()
    assert got["held"] == [4, 2]
    assert got["max_hops"] == pytest.approx([0.018, 0.015])
    assert got["max_ratio"] == pytest.approx(1.2)
    assert got["over"] == 1 and got["worst"][0][:3] == (0, 0, 0) and got["worst"][0][3] == 1
    assert got["worst"][0][5] == 5 and got["worst"][0][-1] == pytest.approx(1.2)
    assert got["p999_ratio"] == pytest.approx(1.2, abs=2e-4)
    assert got["max_ratio_bands"] == pytest.approx([1.2, 0.5]) and got["over_bands"] == [1, 0]
    assert got["p999_ratio_bands"] == pytest.approx([1.2, 0.5], abs=2e-4)
    # the rule: within the bar, or 1.5 times the reference path's own distance
    ours, bars = {"near": got["max_hops"][0], "far": got["max_hops"][1]}, {"near": 0.015, "far": 0.03}
    with pytest.raises(AssertionError, match="near is 0.0179"):
        check_near_reference(ours, {"near": 0.011, "far": 0.01}, bars)
    assert check_near_reference(ours, {"near": 0.0125, "far": 0.01}, bars) == pytest.approx(
        {"near": 0.01875, "far": 0.03})
    assert check_near_reference({"codes": 5}, {"codes": 4}, {"codes": 2}) == {"codes": 6.0}
    with pytest.raises(AssertionError, match="codes is 5"):
        check_near_reference({"codes": 5}, {"codes": 1}, {"codes": 2})


@pytest.mark.parametrize("reassigned", [False, True])
def test_reanchor_lands_on_the_exact_spectrum(reassigned, monkeypatch):
    """On a re-anchor hop column 0 is the exact spectrum of its window
    whatever arithmetic the hop's delta products take: here the hop's
    products come out 5 % off the wrapper's (the card's hop computes them
    in 3xTF32, the wrapper in cuBLAS).  The carry substitution zeroes
    column 0's deltas; when it subtracted the wrapper's own column-0
    product instead, column 0 kept the difference: 477 codes at bins within
    60 dB of a column's peak here, and the reassigned column off its bars.  Held by the one-hop bars: codes
    within 2, the reassigned column by ``check_reassigned`` (0.01 hop)."""
    from openmeters_tpu_torch.ops import reassigned_hop, sliding_hop, sliding_reassigned, sliding_stft
    from openmeters_tpu_torch.utils.parity import check_reassigned, reassigned_errors

    def classic(ready, fr, fi, deltas, upd_r, upd_i, *rest, tiles=None, **kw):
        return sliding_hop.sliding_hop_reference(ready, fr, fi, deltas, upd_r * 1.05, upd_i * 1.05, *rest, **kw)

    def analytic(ready, states, dx, dh, upd, *rest, tiles=None, **kw):
        return reassigned_hop.slide_reassigned(ready, states, (dx @ upd) * 1.05, (dh @ upd) * 1.05, *rest,
                                               hop=dx.shape[2] // 2, **kw)

    monkeypatch.setattr(sliding_stft, "sliding_hop", classic)
    monkeypatch.setattr(sliding_reassigned, "reassigned_sliding_hop", analytic)
    engine, s = MeterEngine(_configs(reassigned)[1]), 2
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    audio = chip_smoke.drift_audio(s, 65)
    carry = engine.init(s, device="cpu")
    for h in range(65):  # hop 64 re-anchors
        carry, snaps = engine.step(carry, torch.from_numpy(np.ascontiguousarray(audio[:, h * BLOCK:(h + 1) * BLOCK])),
                                   meta)
    sg, out = engine.analyzers["spectrogram"], snaps["spectrogram"]
    info = chip_smoke.last_frames(sg, carry["spectrogram"], 4)
    info = {**info, "buf": info["buf"].double()}
    valid = out.valid[:, 0]
    assert bool(valid.all())
    if not reassigned:
        exact = sg._classic(sg._frames.extract(info)[:, :1], None).codes[:, 0].to(torch.int32)  # noqa: SLF001
        held = chip_smoke.resolved_bins(exact, valid)
        assert int(((out.codes[:, 0].to(torch.int32) - exact).abs() * held).max()) <= 2
        return
    sr = sg._sliding_reassigned  # noqa: SLF001
    t = sr._tensors(torch.device("cpu"))  # noqa: SLF001
    states = sr._exact_states(info, carry["spectrogram"]["srs"]["hx"].double(), t["ramp"].double())  # noqa: SLF001
    exact = reassigned_hop._column(states, t["normq"].double(), t["freqb"].double(), n=sr.n, zpf=sr.zpf,
                                   coeffs=sr.coeffs(), inv_2pi=sr.sample_rate / (2.0 * np.pi), inv_hop=1.0 / sr.hop,
                                   latency_hops=sr.center / sr.hop)
    err, _ = reassigned_errors((out.freq_hz[:, 0], out.time_offset[:, 0], out.power[:, 0]), exact, valid, drift=False)
    check_reassigned(err, "column 0 of the re-anchor hop")
