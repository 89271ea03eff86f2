"""PyTorch port, spectrum: the same seeded inputs through the JAX package and
the port, on the CPU.

- The analyzer on every path: the direct rFFT (16384/1024), the sliding DFT
  through the B1b hop (16384/512 at block = hop, as the engine cadences it;
  16384/128 dual trace, two columns a hop) and the B1a hop with power out
  (8192/128), ``hop > block`` with its held outputs, each averaging mode,
  and resets.
- B1b's plain version against the JAX package's XLA ``SlidingSTFT.step`` at
  4096/2048 and 16384/128 for every ``ready``, both output modes, and
  against its Pallas kernel in interpret mode where the Nyquist bin sits
  alone at the first lane of the last 512-bin tile (2048/1024).
- B1a's power output against its Pallas kernel in interpret mode.
- The engine's cadence: ``spectrum_step`` with ``[R, S]`` masks,
  ``super_step`` and ``AnalysisSession.feed`` with the held snapshot.

Bars (``openmeters_tpu_torch/utils/parity.py``): the averaging state within
1e-5 of each trace's peak amplitude at every bin (the -100 dB spectral
bar), raw and weighted dB within 0.01 dB at bins within 50 dB of the
trace's peak; hop states within 1e-5 of their row's largest bin; codes
within 2 at bins within 60 dB of their column's peak.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openmeters_tpu import api as japi  # noqa: E402
from openmeters_tpu.analyzers import spectrum as js  # noqa: E402
from openmeters_tpu.analyzers.spectrogram import pack_classic_db  # noqa: E402
from openmeters_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from openmeters_tpu.engine import MeterEngine as JMeterEngine  # noqa: E402
from openmeters_tpu.engine import StreamMeta as JStreamMeta  # noqa: E402
from openmeters_tpu.ops import pallas_sliding as jpallas  # noqa: E402
from openmeters_tpu.ops import sliding_stft as jsliding  # noqa: E402
from openmeters_tpu.utils.channels import Channel as JChannel  # noqa: E402
from openmeters_tpu.utils.level import DB_FLOOR, power_to_db  # noqa: E402
from openmeters_tpu.utils.windows import WindowKind as JWindowKind  # noqa: E402
from openmeters_tpu.utils.windows import fft_bin_normalization, window_coefficients  # noqa: E402
from openmeters_tpu_torch import api as tapi  # noqa: E402
from openmeters_tpu_torch.analyzers import spectrum as ts  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta  # noqa: E402
from openmeters_tpu_torch.ops import sliding_hop as thop  # noqa: E402
from openmeters_tpu_torch.ops import sliding_stft as tsliding  # noqa: E402
from openmeters_tpu_torch.utils.channels import Channel  # noqa: E402
from openmeters_tpu_torch.utils.parity import check_spectrum, spectrum_errors  # noqa: E402
from openmeters_tpu_torch.utils.windows import WindowKind  # noqa: E402

RATE = 48_000.0
RESOLVED_CODES = round(60.0 * 65535 / 156)  # see tests/test_torch_sliding.py


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than many and
    leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    """The same ``SpectrumConfig`` in both packages; enums by value."""
    jkw, tkw = dict(kw), dict(kw)
    for key, jenum, tenum in (
        ("averaging", js.AveragingMode, ts.AveragingMode),
        ("source", JChannel, Channel),
        ("secondary_source", JChannel, Channel),
        ("window", JWindowKind, WindowKind),
    ):
        if key in kw:
            jkw[key], tkw[key] = jenum(kw[key]), tenum(kw[key])
    return js.SpectrumConfig(**jkw), ts.SpectrumConfig(**tkw)


def _stereo(s, n, seed):
    """``[s, n, 2]``: a sine per stream (50 Hz-8 kHz) plus faint noise, the
    right channel at half the left plus a second tone."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    f = rng.uniform(50.0, 8000.0, (s, 1))
    left = 0.3 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((s, n))
    right = 0.5 * left + 0.1 * np.sin(2 * np.pi * 1.7 * f * t)
    return np.stack([left, right], -1).astype(np.float32)


def _check_snap(tcarry, tsnap, jcarry, jsnap, where, state_floor):
    """Hold the port's spectrum state and snapshot to the JAX package's;
    returns the errors (``floor_flips``: the bins zeroed at the state
    floor on one side only)."""
    err = spectrum_errors(tcarry["smoothed"], np.asarray(jcarry["smoothed"]), tsnap, jsnap, state_floor)
    check_spectrum(err, where)
    return err


ANALYZER_CASES = {
    # name: (config, hops, reset hops)
    "direct_16384_1024": (dict(fft_size=16384, hop_size=1024, block_frames=1024), 24, ()),
    "b1b_16384_512": (dict(fft_size=16384, hop_size=512, block_frames=512), 80, (60,)),
    "b1b_16384_128_dual_peak": (
        dict(fft_size=16384, hop_size=128, source="left", secondary_source="right",
             averaging="peak_hold"), 100, (80,),
    ),
    "b1a_8192_128_exponential": (
        dict(fft_size=8192, hop_size=128, averaging="exponential", exp_factor=0.7), 70, (50,),
    ),
    "held_4096_512_exponential": (
        dict(fft_size=4096, hop_size=512, averaging="exponential"), 60, (40, 41),
    ),
    "b1a_2048_64_blackman_side": (
        dict(fft_size=2048, hop_size=64, window="blackman_harris", source="side",
             secondary_source="mid", averaging="peak_hold", peak_decay_db_per_s=60.0), 40, (20,),
    ),
}


@pytest.mark.parametrize("case", list(ANALYZER_CASES))
def test_analyzer_matches_jax(case, record_property):
    kw, hops, resets = ANALYZER_CASES[case]
    jcfg, tcfg = _configs(**kw)
    ja, ta = js.SpectrumAnalyzer(jcfg), ts.SpectrumAnalyzer(tcfg)
    assert ta.use_sliding == ja.use_sliding and ta.bins == ja.bins
    if ta.use_sliding:
        assert ta._sliding.whole_row == jpallas.fits_vmem(ta.config.hop_size, ta.bins)
    np.testing.assert_array_equal(ta.a_weighting, ja.a_weighting)
    assert ta.state_floor == ja.state_floor
    s, b = 3, tcfg.block_frames
    audio = _stereo(s, hops * b, seed=len(case))
    jc, tc = ja.init(s), ta.init(s, device="cpu")
    jstep = jax.jit(ja.step)
    updated = flips = 0
    worst = {"amplitude": 0.0, "db": 0.0}
    for i in range(hops):
        blk = audio[:, i * b : (i + 1) * b]
        rm = np.array([False, True, i % 2 == 0]) if i in resets else None
        jc, jsnap = jstep(jc, jnp.asarray(blk), reset_mask=None if rm is None else jnp.asarray(rm))
        tc, tsnap = ta.step(tc, torch.from_numpy(blk), reset_mask=None if rm is None else torch.from_numpy(rm))
        err = _check_snap(tc, tsnap, jc, jsnap, f"{case} hop {i}", ta.state_floor)
        flips += err["floor_flips"]
        worst = {k: max(v, err[k]) for k, v in worst.items()}
        updated += int(tsnap.updated.sum())
        if "sdft" in tc:
            assert tc["sdft"]["count"] == int(jc["sdft"]["count"])
            assert tc["sdft"]["anchored"] == bool(jc["sdft"]["anchored"])
    for k, v in worst.items():
        record_property(f"{k}_gap", v)
    record_property("floor_flips", flips)
    assert updated > 0 and flips <= 2, (updated, flips)
    emitted = ta.emit(tc)
    _check_snap(tc, emitted, jc, ja.emit(jc), f"{case} emit", ta.state_floor)
    assert not bool(emitted.updated.any())


def _synthetic_hop(sl, s, seed):
    """A ring holding random audio, ``info`` pointing into it (the same in
    both packages), and a spectrum state of a real frame."""
    rng = np.random.default_rng(seed)
    fb = sl.frames
    buf = (rng.standard_normal((s, 2 * fb.cap)) * 0.2).astype(np.float32)
    buf[:, fb.cap :] = buf[:, : fb.cap]  # the mirrored ring
    base = int(rng.integers(0, fb.cap))
    spec = np.fft.rfft(buf[:, : sl.fft_size].astype(np.float64), axis=-1)
    return buf, base, spec.real.astype(np.float32), spec.imag.astype(np.float32)


@pytest.mark.parametrize("fft,hop", [(4096, 2048), (16384, 128)])
def test_spectra_hop_plain_matches_jax_step(fft, hop):
    """B1b's plain version through ``SlidingSTFT.step_fused`` against the JAX
    package's XLA ``SlidingSTFT.step`` (its CPU path), from an anchored
    state, for every ``ready``, power and codes."""
    s, block = 2, 256
    jsl = jsliding.SlidingSTFT(fft, hop, block, JWindowKind.HANN)
    tsl = tsliding.SlidingSTFT(fft, hop, block, WindowKind.HANN)
    assert not tsl.whole_row and not jpallas.fits_vmem(hop, tsl.bins)
    cols = tsl.frames.cols_cap
    buf, base, fr, fi = _synthetic_hop(tsl, s, seed=fft + hop)
    norm = fft_bin_normalization(window_coefficients(JWindowKind.HANN, fft), fft)
    jstep = jax.jit(jsl.step)
    for ready in range(cols + 1):
        valid = np.ones((s, cols), bool)
        jinfo = {"buf": jnp.asarray(buf), "base": jnp.int32(base), "ready": jnp.int32(ready),
                 "valid": jnp.asarray(valid)}
        tinfo = {"buf": torch.from_numpy(buf), "base": base, "ready": ready, "valid": torch.from_numpy(valid)}
        jsd = {"re": jnp.asarray(fr), "im": jnp.asarray(fi), "count": jnp.int32(5), "anchored": jnp.bool_(True)}
        jsd2, jpow = jstep(jsd, jinfo)
        ref = np.asarray(jpow) * norm
        for emit_codes in (False, True):
            tsd = {"re": torch.from_numpy(fr), "im": torch.from_numpy(fi), "count": 5, "anchored": True}
            tsd2, out = tsl.step_fused(tsd, tinfo, torch.from_numpy(norm), DB_FLOOR, emit_codes=emit_codes)
            rowmax = np.max(np.hypot(np.asarray(jsd2["re"]), np.asarray(jsd2["im"])), axis=1, keepdims=True)
            err = np.maximum(np.abs(tsd2["re"].numpy() - np.asarray(jsd2["re"])),
                             np.abs(tsd2["im"].numpy() - np.asarray(jsd2["im"]))) / rowmax
            assert float(err.max()) <= 1e-5, (ready, emit_codes)
            if emit_codes:
                codes = np.asarray(pack_classic_db(power_to_db(jnp.asarray(ref), DB_FLOOR))).astype(np.int64)
                ours = out.numpy().astype(np.int64)
                held = codes >= codes.max(-1, keepdims=True) - RESOLVED_CODES
                assert int((np.abs(ours - codes) * held).max()) <= 2, ready
            else:
                amp = np.abs(np.sqrt(out.numpy()) - np.sqrt(ref)) / np.sqrt(ref).max(-1, keepdims=True)
                assert float(amp.max()) <= 1e-5, ready
            if ready == 0:
                np.testing.assert_array_equal(tsd2["re"].numpy(), fr)


def _pallas_interpret(fn):
    old = os.environ.get("OPENMETERS_PALLAS_INTERPRET")
    os.environ["OPENMETERS_PALLAS_INTERPRET"] = "1"
    jax.clear_caches()
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("OPENMETERS_PALLAS_INTERPRET", None)
        else:
            os.environ["OPENMETERS_PALLAS_INTERPRET"] = old
        jax.clear_caches()


@pytest.mark.parametrize("emit_codes", [False, True])
@pytest.mark.parametrize("fft,hop", [(64, 16), (2048, 1024)])
def test_hop_plain_matches_pallas_kernel(fft, hop, emit_codes):
    """The plain hops against the JAX package's kernel in interpret mode:
    B1a at 64/16 (whole row) and B1b at 2048/1024 (bin-tiled: 1025 bins,
    the Nyquist bin alone at lane 0 of the third 512-bin tile)."""
    s, block, ready = 8, 2 * hop, 2
    jsl = jsliding.SlidingSTFT(fft, hop, block, JWindowKind.HANN)
    tsl = tsliding.SlidingSTFT(fft, hop, block, WindowKind.HANN)
    cols, bins = tsl.frames.cols_cap, tsl.bins
    assert tsl.whole_row == (fft == 64) == jpallas.fits_vmem(hop, bins)
    rng = np.random.default_rng(fft)
    x = (rng.standard_normal((s, fft + cols * hop)) * 0.3).astype(np.float32)
    spec = np.fft.rfft(x[:, :fft].astype(np.float64), axis=-1)
    fr, fi = spec.real.astype(np.float32), spec.imag.astype(np.float32)
    deltas = np.stack([x[:, fft + k * hop : fft + (k + 1) * hop] - x[:, k * hop : (k + 1) * hop]
                       for k in range(cols)], axis=1)
    rot_r, rot_i, upd_r, upd_i = jsl._consts()
    dc = jsl._dc_corr_vector()
    norm = fft_bin_normalization(window_coefficients(JWindowKind.HANN, fft), fft)
    coeffs = tuple(float(a) for a in jsl._stencil())
    jr, ji, jout = _pallas_interpret(lambda: jax.device_get(jpallas.sliding_hop(
        ready, jnp.asarray(fr), jnp.asarray(fi), jnp.asarray(deltas), jnp.asarray(upd_r),
        jnp.asarray(upd_i), jnp.asarray(rot_r)[None], jnp.asarray(rot_i)[None],
        jnp.asarray(dc)[None], jnp.asarray(norm)[None], cols=cols, hop=hop, bins=bins, n=fft,
        coeffs=coeffs, floor_db=DB_FLOOR, emit_codes=emit_codes,
    )))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        fr=fr, fi=fi, rot_r=rot_r, rot_i=rot_i, dc=dc, norm=norm).items()}
    kw = dict(n=fft, coeffs=coeffs, floor_db=DB_FLOOR, emit_codes=emit_codes)
    if tsl.whole_row:
        tr, ti, out = thop.sliding_hop(
            ready, t["fr"], t["fi"], torch.from_numpy(deltas), torch.from_numpy(upd_r),
            torch.from_numpy(upd_i), t["rot_r"], t["rot_i"], t["dc"], t["norm"], **kw)
    else:
        tr, ti, out = thop.sliding_hop_spectra(
            ready, t["fr"], t["fi"], torch.from_numpy(deltas), t["rot_r"], t["rot_i"], t["dc"],
            t["norm"], **kw)
    assert tuple(out.shape) == (s, cols, bins)
    rowmax = np.max(np.hypot(jr, ji), axis=1, keepdims=True)
    err = np.maximum(np.abs(tr.numpy() - jr), np.abs(ti.numpy() - ji)) / rowmax
    assert float(err.max()) <= 1e-5
    if emit_codes:
        assert out.dtype == torch.uint16
        ref = np.asarray(jout).astype(np.int64)
        held = ref >= ref.max(-1, keepdims=True) - RESOLVED_CODES
        assert int((np.abs(out.numpy().astype(np.int64) - ref) * held).max()) <= 2
    else:
        assert out.dtype == torch.float32
        amp = np.abs(np.sqrt(out.numpy()) - np.sqrt(jout)) / np.sqrt(jout).max(-1, keepdims=True)
        assert float(amp.max()) <= 1e-5


# -- the engine's cadence ------------------------------------------------------------


def _engines(**spectrum_kw):
    jsp, tsp = _configs(**spectrum_kw)
    kw = dict(loudness=None, spectrogram=None, oscilloscope=None, stereometer=None,
              waveform=None, channels=2)
    return JMeterEngine(JEngineConfig(spectrum=jsp, **kw)), MeterEngine(EngineConfig(spectrum=tsp, **kw))


def test_spectrum_step_with_per_hop_masks():
    """16384/512 at cadence 2: ``spectrum_step`` with ``[R, S]`` masks
    zeroes the blocks before a stream's last reset, as the JAX one does."""
    je, te = _engines(fft_size=16384, hop_size=512)
    assert te.spectrum_cadence == je.spectrum_cadence == 2
    assert te.analyzers["spectrum"].config.block_frames == 512
    s, r, b = 3, 2, 256
    audio = _stereo(s, 50 * r * b, seed=7)
    jmeta, tmeta = JStreamMeta.default(s, 2, 2), StreamMeta.default(s, 2, 2)
    jc, tc = je.init(s)["spectrum"], te.init(s, device="cpu")["spectrum"]
    jstep = jax.jit(je.spectrum_step)
    for i in range(50):
        blocks = audio[:, i * r * b : (i + 1) * r * b].reshape(s, r, b, 2).transpose(1, 0, 2, 3)
        masks = np.zeros((r, s), bool)
        if i in (40, 44):
            masks[i % 2, 1] = masks[1, 2] = True
        jc, jsnap = jstep(jc, jnp.asarray(blocks), jmeta, jnp.asarray(masks))
        tc, tsnap = te.spectrum_step(tc, torch.from_numpy(np.ascontiguousarray(blocks)), tmeta,
                                     torch.from_numpy(masks))
        _check_snap(tc, tsnap, jc, jsnap, f"spectrum hop {i}", te.analyzers["spectrum"].state_floor)
    assert bool(tsnap.updated[0])


def test_super_step_matches_jax():
    """``super_step``: two engine hops of loudness, then the 16384/512
    spectrum hop, snapshots stacked per hop."""
    jsp, tsp = _configs(fft_size=16384, hop_size=512, averaging="exponential")
    kw = dict(spectrogram=None, oscilloscope=None, stereometer=None, waveform=None, channels=2)
    je, te = JMeterEngine(JEngineConfig(spectrum=jsp, **kw)), MeterEngine(EngineConfig(spectrum=tsp, **kw))
    s, r, b = 2, 2, 256
    audio = _stereo(s, 40 * r * b, seed=8)
    jmeta, tmeta = JStreamMeta.default(s, 2, 2), StreamMeta.default(s, 2, 2)
    jc, tc = je.init(s), te.init(s, device="cpu")
    jsuper = jax.jit(je.super_step)
    for i in range(40):
        blocks = audio[:, i * r * b : (i + 1) * r * b].reshape(s, r, b, 2).transpose(1, 0, 2, 3)
        resets = np.zeros((r, s), bool)
        resets[1, 0] = i == 30
        jc, jsnaps = jsuper(jc, jnp.asarray(blocks), jmeta, jnp.asarray(resets))
        tc, tsnaps = te.super_step(tc, torch.from_numpy(np.ascontiguousarray(blocks)), tmeta,
                                   torch.from_numpy(resets))
        _check_snap(tc["spectrum"], tsnaps["spectrum"], jc["spectrum"], jsnaps["spectrum"], f"hop {i}",
                    te.analyzers["spectrum"].state_floor)
        for f in jsnaps["loudness"]._fields:
            ours, ref = getattr(tsnaps["loudness"], f).numpy(), np.asarray(getattr(jsnaps["loudness"], f))
            assert ours.shape == ref.shape == (r, s, *ref.shape[2:])
            np.testing.assert_allclose(ours, ref, rtol=0, atol=0.01, err_msg=f"hop {i} {f}")
    folded_c, (folded, sp) = te.super_step(
        tc, torch.from_numpy(np.ascontiguousarray(blocks)), tmeta,
        fold_snaps=lambda snaps: float(snaps["loudness"].momentary_lufs.sum()),
    )
    assert len(folded) == r and isinstance(sp, ts.SpectrumSnapshot)


def test_session_holds_spectrum_between_hops():
    """``AnalysisSession.feed`` at cadence 2: the spectrum hop runs on every
    second feed with the OR of the two hops' masks, and the newest
    snapshot is held in between."""
    je, te = _engines(fft_size=16384, hop_size=512, averaging="peak_hold")
    s, b = 3, 256
    audio = _stereo(s, 100 * b, seed=9)
    jsess, tsess = japi.AnalysisSession(je, s), tapi.AnalysisSession(te, s, "cpu")
    prev = None
    for i in range(100):
        blk = audio[:, i * b : (i + 1) * b]
        reset = np.array([False, True, False]) if i in (71, 80) else None
        jsnaps, tsnaps = jsess.feed(blk, reset), tsess.feed(blk, reset)
        assert ("spectrum" in tsnaps) == ("spectrum" in jsnaps) == (i >= 1), i
        if "spectrum" in tsnaps:
            _check_snap(tsess.carry["spectrum"], tsnaps["spectrum"], jsess.carry["spectrum"],
                        jsnaps["spectrum"], f"feed {i}", te.analyzers["spectrum"].state_floor)
            # a feed without a spectrum hop returns the last one's snapshot
            assert (tsnaps["spectrum"] is prev) == (i % 2 == 0), i
            prev = tsnaps["spectrum"]
    assert bool(tsnaps["spectrum"].updated[0]) and not bool(tsnaps["spectrum"].updated[1])


def test_session_copies_the_callers_block():
    """A caller that refills one buffer every hop: the session copies each
    block of a spectrum hop, so the spectra equal those fed fresh arrays."""
    _, te = _engines(fft_size=16384, hop_size=512)
    s, b = 2, 256
    audio = _stereo(s, 80 * b, seed=10)
    fresh, reused = tapi.AnalysisSession(te, s, "cpu"), tapi.AnalysisSession(te, s, "cpu")
    buf = np.empty((s, b, 2), np.float32)
    for i in range(80):
        blk = audio[:, i * b : (i + 1) * b]
        buf[...] = blk
        reset = np.array([i == 70, False])
        a, c = fresh.feed(blk.copy(), reset), reused.feed(buf, reset)
    assert bool(a["spectrum"].updated.any())
    for f in a["spectrum"]._fields:
        assert torch.equal(getattr(a["spectrum"], f), getattr(c["spectrum"], f)), f
    assert torch.equal(fresh.carry["spectrum"]["smoothed"], reused.carry["spectrum"]["smoothed"])
