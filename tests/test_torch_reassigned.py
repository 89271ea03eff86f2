"""PyTorch port, reassigned spectrogram: the same seeded inputs through the
JAX package and the port, on the CPU.

Bars (``openmeters_tpu_torch/utils/parity.py``), at valid bins within 60 dB
of their column's peak power: |d freq| <= 0.5 Hz, |d power| / power <= 5e-3,
|d time| <= 0.01 hop; at each column's peak bin |d time| <= 1e-4 hop.
``valid`` equal; ``point_valid`` equal at the held bins.

The sliding path's time is held with ``drift=True``: 0.015 hop within 50 dB
of the peak, 0.03 hop from 50 to 60 dB.  Its f32 states drift between exact
re-anchors (and the Pallas kernel's delta products are bf16x3 splits), and
the ramp-weighted spectrum V carries that into the time correction over
the bin's own |B|.  Measured here: up to 1.9e-3 hop within 50 dB and
4.3e-3 hop within 60 dB, since the port's CPU hop runs in float64 (8.2e-3
and 1.5e-2 while it ran in f32); the JAX package holds its own sliding
kernel to 0.01 hop within 50 dB (tests/test_sliding_reassigned.py:386-392).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openmeters_tpu import api as japi  # noqa: E402
from openmeters_tpu.analyzers import spectrogram as jspec  # noqa: E402
from openmeters_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from openmeters_tpu.engine import MeterEngine as JMeterEngine  # noqa: E402
from openmeters_tpu.ops import pallas_sliding_reassigned as jpallas  # noqa: E402
from openmeters_tpu.ops import sliding_reassigned as jsr  # noqa: E402
from openmeters_tpu.utils.windows import WindowKind as JWindowKind  # noqa: E402
from openmeters_tpu.utils.windows import fft_bin_normalization  # noqa: E402
from openmeters_tpu.utils.windows import window_coefficients  # noqa: E402
from openmeters_tpu_torch import api as tapi  # noqa: E402
from openmeters_tpu_torch import convert  # noqa: E402
from openmeters_tpu_torch.analyzers import spectrogram as tspec  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine  # noqa: E402
from openmeters_tpu_torch.ops import reassigned_columns as tcols  # noqa: E402
from openmeters_tpu_torch.ops import reassigned_hop as thop  # noqa: E402
from openmeters_tpu_torch.ops import sliding_reassigned as tsr  # noqa: E402
from openmeters_tpu_torch.utils import windows as twindows  # noqa: E402
from openmeters_tpu_torch.utils.parity import check_reassigned, reassigned_errors  # noqa: E402
from openmeters_tpu_torch.utils.windows import WindowKind  # noqa: E402

RESOLVED_CODES = round(60.0 * 65535 / 156)


def _pallas_interpret(fn):
    """Run ``fn`` with the Pallas interpreter on, restoring the env after."""
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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_columns_match(ours, ref, valid, *, drift: bool, where=""):
    """``ours``/``ref``: ``(freq, time, power)`` ``[..., bins]``; ``valid``
    ``[...]`` bool.  Holds the bars above; returns the held mask."""
    t = lambda a: torch.from_numpy(np.array(_np(a)))  # noqa: E731
    ours, ref = tuple(map(t, ours)), tuple(map(t, ref))
    assert [a.shape for a in ours] == [b.shape for b in ref], where
    errors, held = reassigned_errors(ours, ref, t(valid), drift=drift)
    check_reassigned(errors, where)
    return held.numpy()


def assert_reassigned_match(tcols_, jcols_, *, drift: bool, where=""):
    valid = np.asarray(jcols_.valid)
    np.testing.assert_array_equal(_np(tcols_.valid), valid, err_msg=where)
    held = assert_columns_match(
        (tcols_.freq_hz, tcols_.time_offset, tcols_.power),
        (jcols_.freq_hz, jcols_.time_offset, jcols_.power),
        valid, drift=drift, where=where,
    )
    pv_ours, pv_ref = _np(tcols_.point_valid), np.asarray(jcols_.point_valid)
    assert pv_ours.dtype == bool and pv_ours.shape == pv_ref.shape, where
    np.testing.assert_array_equal(pv_ours[held], pv_ref[held], err_msg=where)


# -- window helpers -----------------------------------------------------------


def test_window_helpers_bit_identical():
    for size in (1, 2, 3, 500, 512, 1000, 2048, 16384):
        assert twindows.hilbert_len_for(size) == jspec.hilbert_len_for(size)
    for kind in WindowKind:
        for size in (1, 2, 7, 512, 1000, 2048):
            w = window_coefficients(JWindowKind(kind.value), size)
            np.testing.assert_array_equal(twindows.derivative_window(w), jspec.derivative_window(w))
            tw, jw = twindows.time_weighted_window(w), jspec.time_weighted_window(w)
            assert tw.dtype == jw.dtype == np.float32
            np.testing.assert_array_equal(tw, jw)
            if size > 1:
                for fft in (size, 2 * size):
                    assert twindows.reassigned_power_scale(w, fft) == jspec.reassigned_power_scale(w, fft)


# -- the sliding hop (kernel B2's plain version) -------------------------------


def _hop_inputs(sl, s, seed):
    """States that are the exact spectra of a window of x and hx, and the
    deltas of the next ``cols`` hops.  x is two sines per stream plus faint
    noise and hx its Hilbert transform (sines turn to minus cosines) plus
    faint noise, as the analyzer sees them."""
    rng = np.random.default_rng(seed)
    n, hop, cols, pfft = sl.n, sl.hop, sl.cols_cap, sl.pfft
    t = np.arange(n + cols * hop) / 48_000.0
    f0 = rng.uniform(200.0, 16_000.0, size=(2, s, 1))
    ph = rng.uniform(0.0, 2 * np.pi, size=(2, s, 1))
    amp = np.array([0.4, 0.1])[:, None, None]
    arg = 2 * np.pi * f0 * t + ph
    x = np.stack([(amp * np.sin(arg)).sum(0), -(amp * np.cos(arg)).sum(0)])
    x = (x + 0.005 * rng.standard_normal(x.shape)).astype(np.float32)
    ramp = np.arange(n) - (n - 1) * 0.5
    states = []
    for sig in (x[0, :, :n], x[1, :, :n], x[0, :, :n] * ramp, x[1, :, :n] * ramp):
        spec = np.fft.rfft(sig.astype(np.float64), n=pfft, axis=-1)
        states += [spec.real.astype(np.float32), spec.imag.astype(np.float32)]

    def deltas(sig):
        return np.stack(
            [
                np.concatenate(
                    [sig[:, n + k * hop : n + (k + 1) * hop], sig[:, k * hop : (k + 1) * hop]], -1
                )
                for k in range(cols)
            ],
            axis=1,
        )

    return states, deltas(x[0]), deltas(x[1])


@pytest.mark.parametrize("zpf", [1, 2])
@pytest.mark.parametrize("window", ["hann", "blackman_harris"])
def test_reference_hop_matches_pallas_kernel(window, zpf):
    """The plain hop against the Pallas kernel in interpret mode, for ready
    in {0, 1, cols}, at n 512, hop 64 (4 columns a hop)."""
    n, hop, s = 512, 64, 8
    jsl = jsr.SlidingReassigned(n, hop, 256, JWindowKind(window), 48_000.0, zpf=zpf)
    tsl = tsr.SlidingReassigned(n, hop, 256, WindowKind(window), 48_000.0, zpf=zpf)
    cols, bins = tsl.cols_cap, tsl.bins
    assert cols == 4 and bins == n * zpf // 2 + 1
    states, dx, dh = _hop_inputs(tsl, s, seed=41 + zpf)
    rot_r, rot_i, upd, _ = jsl._consts()
    w = window_coefficients(JWindowKind(window), n)
    normq = (0.25 * fft_bin_normalization(w, n * zpf)).astype(np.float32)
    freqb = np.arange(bins, dtype=np.float32) * np.float32(48_000.0 / (n * zpf))
    coeffs = tsl.coeffs()
    scal = dict(inv_2pi=48_000.0 / (2.0 * np.pi), inv_hop=1.0 / hop, latency_hops=tsl.center / hop)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for ours, ref in zip(tsl._consts(), jsl._consts()):
        np.testing.assert_array_equal(ours, ref)

    readies = (0, 1, cols)
    jouts = _pallas_interpret(lambda: [jax.device_get(jpallas.reassigned_sliding_hop(
        ready, tuple(jnp.asarray(a) for a in states), jnp.asarray(dx), jnp.asarray(dh),
        jnp.asarray(upd), jnp.asarray(rot_r)[None], jnp.asarray(rot_i)[None],
        jnp.asarray(normq)[None], jnp.asarray(freqb)[None],
        cols=cols, hop=hop, bins=bins, n=n, coeffs=coeffs, zpf=zpf, **scal,
    )) for ready in readies])
    for ready, (jst, jf, jt, jp) in zip(readies, jouts):
        tst, tf, tt, tp = thop.reassigned_sliding_hop(
            ready, tuple(t(a) for a in states), t(dx), t(dh), t(upd), t(rot_r), t(rot_i),
            t(normq), t(freqb), n=n, zpf=zpf, coeffs=coeffs, **scal,
        )
        assert tf.shape == (s, cols, bins) and tf.dtype == torch.float32
        for i in range(0, 8, 2):  # each complex state relative to its row max
            scale = np.max(np.hypot(jst[i], jst[i + 1]), axis=1, keepdims=True)
            for j in (i, i + 1):
                err = np.abs(tst[j].numpy() - jst[j]) / scale
                assert float(err.max()) <= 1e-5, (ready, j, float(err.max()))
        if ready == 0:  # the states are held
            for ours, ref in zip(tst, states):
                np.testing.assert_array_equal(ours.numpy(), ref)
        assert_columns_match(
            (tf, tt, tp), (jf, jt, jp), np.ones((s, cols), bool), drift=True,
            where=f"ready {ready}",
        )


def test_reassigned_hop_rejects_other_devices():
    m = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError):
        thop.reassigned_sliding_hop(
            1, tuple(m(2, 257) for _ in range(8)), m(2, 4, 128), m(2, 4, 128), m(128, 4 * 257),
            m(257), m(257), m(257), m(257), n=512, zpf=1, coeffs=(0.5, -0.5),
            inv_2pi=1.0, inv_hop=1.0, latency_hops=1.0,
        )
    with pytest.raises(ValueError):
        tcols.reassigned_columns(
            m(3, 1024), n=512, h=1024, coeffs=(0.5, -0.5), sample_rate=48_000.0, hop=64
        )


# -- the per-column transform (kernel B3's plain version) -----------------------


@pytest.mark.parametrize("n", [512, 2048])
def test_reference_columns_match_jax(n):
    """``reassigned_columns`` (CPU: its plain version) against the JAX
    analyzer's ``_reassigned`` (its XLA path on the CPU) on ``[S, 1, h]``
    frames of sines plus noise."""
    h = 2 * n
    rng = np.random.default_rng(n)
    s = 5
    t = np.arange(h) / 48_000.0
    f0 = rng.uniform(100.0, 12_000.0, size=(s, 1))
    frames = (0.4 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6, (s, 1)))
              + 0.01 * rng.standard_normal((s, h))).astype(np.float32)
    cfg = jspec.SpectrogramConfig(fft_size=n, hop_size=n // 4, use_reassignment=True)
    ana = jspec.SpectrogramAnalyzer(cfg)
    assert ana.read_len == h
    ref = ana._reassigned(jnp.asarray(frames[:, None, :]), jnp.ones((s, 1), bool))
    assert tcols.kernel_supports(n, h)
    out = tcols.reassigned_columns(
        torch.from_numpy(frames), n=n, h=h, coeffs=(0.5, -0.5), sample_rate=48_000.0, hop=n // 4,
    )
    assert all(o.shape == (s, n // 2 + 1) for o in out)
    assert_columns_match(
        out, (np.asarray(ref.freq_hz)[:, 0], np.asarray(ref.time_offset)[:, 0],
              np.asarray(ref.power)[:, 0]),
        np.ones((s,), bool), drift=False, where=f"n {n}",
    )


def test_columns_kernel_support_is_decided_by_config():
    assert all(tcols.kernel_supports(n, 2 * n) for n in (512, 1024, 2048, 4096, 8192))
    assert not tcols.kernel_supports(16384, 32768)  # 256 KB of shared memory
    assert not tcols.kernel_supports(1000, 2048)  # not a power of two
    ana = tspec.SpectrogramAnalyzer(tspec.SpectrogramConfig(fft_size=8192, hop_size=512))
    assert not ana.use_sliding_reassigned and ana.use_reassigned_kernel
    ana = tspec.SpectrogramAnalyzer(tspec.SpectrogramConfig(fft_size=2048, zero_padding_factor=4))
    assert not ana.use_sliding_reassigned and not ana.use_reassigned_kernel
    assert tspec.SpectrogramAnalyzer().use_sliding_reassigned


# -- the analyzer --------------------------------------------------------------


def _signal(s, hops, seed, block=256):
    rng = np.random.default_rng(seed)
    t = np.arange(hops * block) / 48_000.0
    f0 = rng.uniform(100.0, 8000.0, size=(s, 1))
    sig = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal((s, hops * block))
    return (sig * rng.uniform(0.05, 1.0, size=(s, 1))).astype(np.float32)


@pytest.mark.parametrize(
    "fft,hop,zpf,window,hops",
    [
        (2048, 64, 1, "hann", 80),  # the default: sliding, two periodic re-anchors
        (512, 64, 2, "blackman_harris", 40),  # sliding, zero-padded, reach 6
        (512, 256, 1, "hann", 30),  # per-column (B3), ungated
        (2048, 512, 1, "hann", 40),  # per-column (B3), gated: hop > block
        (2048, 512, 2, "hann", 30),  # per-column, zero-padded, gated
    ],
)
def test_analyzer_matches_jax(fft, hop, zpf, window, hops):
    s = 3
    kw = dict(fft_size=fft, hop_size=hop, zero_padding_factor=zpf, use_reassignment=True)
    ja = jspec.SpectrogramAnalyzer(jspec.SpectrogramConfig(window=JWindowKind(window), **kw))
    ta = tspec.SpectrogramAnalyzer(tspec.SpectrogramConfig(window=WindowKind(window), **kw))
    assert ta.use_sliding_reassigned == ja.use_sliding_reassigned
    sliding = ta.use_sliding_reassigned
    sig = _signal(s, hops, seed=fft + hop + zpf)
    jc, tc = ja.init(s), ta.init(s)
    assert set(tc) == set(jc)
    jstep = jax.jit(ja.step)
    reset_at, reset = hops // 2, np.array([False, True, False])
    emitted = 0
    for i in range(hops):
        blk = sig[:, i * 256 : (i + 1) * 256]
        r = reset if i == reset_at else None
        jc, jo = jstep(jc, jnp.asarray(blk), None if r is None else jnp.asarray(r))
        tc, to = ta.step(tc, torch.from_numpy(blk), None if r is None else torch.from_numpy(r))
        assert type(to).__name__ == "ReassignedColumns"
        assert_reassigned_match(to, jo, drift=sliding, where=f"hop {i}")
        if sliding:
            srs = tc["srs"]
            assert (srs["count"], srs["anchored"], srs["hx_avail"]) == (
                int(jc["srs"]["count"]), bool(jc["srs"]["anchored"]), int(jc["srs"]["hx_avail"])
            )
        emitted += int(np.asarray(jo.valid).sum())
    assert emitted >= s * 4  # columns were held, not only empty ones


@pytest.mark.parametrize("fft,hop,zpf", [(1000, 250, 1), (512, 64, 2), (512, 512, 1)])
def test_classic_per_column_matches_jax(fft, hop, zpf):
    """The per-column classic path: a non-power-of-two fft, zero padding,
    and hop > block (gated)."""
    s, hops = 3, 24
    kw = dict(fft_size=fft, hop_size=hop, zero_padding_factor=zpf, use_reassignment=False)
    ja = jspec.SpectrogramAnalyzer(jspec.SpectrogramConfig(**kw))
    ta = tspec.SpectrogramAnalyzer(tspec.SpectrogramConfig(**kw))
    assert not ja.use_sliding  # the port computes every classic column from its frame
    sig = _signal(s, hops, seed=fft + zpf)
    jc, tc = ja.init(s), ta.init(s)
    jstep = jax.jit(ja.step)
    held_any = False
    for i in range(hops):
        blk = sig[:, i * 256 : (i + 1) * 256]
        jc, jo = jstep(jc, jnp.asarray(blk))
        tc, to = ta.step(tc, torch.from_numpy(blk))
        valid = np.asarray(jo.valid)
        np.testing.assert_array_equal(to.valid.numpy(), valid)
        assert to.codes.dtype == torch.uint16
        ref = np.asarray(jo.codes).astype(np.int64)
        ours = to.codes.numpy().astype(np.int64)
        held = valid[..., None] & (ref >= ref.max(axis=-1, keepdims=True) - RESOLVED_CODES)
        assert int((np.abs(ours - ref) * held).max(initial=0)) <= 2, i
        held_any |= bool(held.any())
    assert held_any


# -- the engine ----------------------------------------------------------------


def _engine_configs():
    kw = dict(spectrum=None, oscilloscope=None, stereometer=None, waveform=None, channels=2)
    return JEngineConfig(**kw), EngineConfig(**kw)


def _audio(s, hops, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(hops * 256) / 48_000.0
    freqs = rng.uniform(60.0, 6000.0, size=(s, 1, 1))
    audio = 0.25 * np.sin(2 * np.pi * freqs * t[None, :, None]) + 0.05 * rng.standard_normal(
        (s, hops * 256, 2)
    )
    return (audio * rng.uniform(0.01, 1.0, size=(s, 1, 2))).astype(np.float32)


def _assert_snapshots_match(jsnaps, tsnaps, hop):
    jl, tl = jsnaps["loudness"], tsnaps["loudness"]
    for field in jl._fields:
        tol = 1e-3 if field == "true_peak_db" else 0.01
        np.testing.assert_allclose(
            _np(getattr(tl, field)), np.asarray(getattr(jl, field)), rtol=0, atol=tol,
            err_msg=f"hop {hop} {field}",
        )
    assert_reassigned_match(tsnaps["spectrogram"], jsnaps["spectrogram"], drift=True,
                            where=f"hop {hop}")


def test_engine_default_spectrogram_matches():
    """Loudness plus the default reassigned 2048/64 spectrogram, through
    both packages' ``AnalysisSession``, with a reset."""
    jcfg, tcfg = _engine_configs()
    assert tcfg.spectrogram == tspec.SpectrogramConfig()
    s, hops = 3, 56
    audio = _audio(s, hops, seed=51)
    jsess = japi.AnalysisSession(JMeterEngine(jcfg), s)
    tsess = tapi.AnalysisSession(MeterEngine(tcfg), s, "cpu")
    valid = 0
    for i in range(hops):
        blk = audio[:, i * 256 : (i + 1) * 256]
        reset = np.array([False, False, True]) if i == 30 else None
        jsn, tsn = jsess.feed(blk, reset), tsess.feed(blk, reset)
        _assert_snapshots_match(jsn, tsn, i)
        valid += int(np.asarray(jsn["spectrogram"].valid).sum())
    assert valid > 0


def test_carry_from_jax_continues_reassigned():
    """JAX runs 40 hops; the carry (with the ``srs`` subtree) round-trips
    bit-equal, and both packages continue 30 more hops from it."""
    jcfg, tcfg = _engine_configs()
    s = 2
    audio = _audio(s, 70, seed=52)
    jsess = japi.AnalysisSession(JMeterEngine(jcfg), s)
    for i in range(40):
        jsess.feed(audio[:, i * 256 : (i + 1) * 256])
    carry_np = jax.device_get(jsess.carry)
    assert set(carry_np["spectrogram"]) == {"fb", "srs"}
    tsess = tapi.AnalysisSession(MeterEngine(tcfg), s, "cpu")
    tsess.carry = convert.carry_from_jax(carry_np, tsess.engine, device="cpu")
    srs = tsess.carry["spectrogram"]["srs"]
    assert isinstance(srs["count"], int) and isinstance(srs["hx_avail"], int)
    assert srs["anchored"] is True and srs["hx"].shape == carry_np["spectrogram"]["srs"]["hx"].shape

    back = convert.carry_to_numpy(tsess.carry)
    flat_j = jax.tree_util.tree_leaves_with_path(carry_np)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        ours = flat_t[path]
        assert ours.dtype == np.asarray(leaf).dtype and ours.shape == np.shape(leaf), path
        np.testing.assert_array_equal(ours, np.asarray(leaf), err_msg=str(path))

    for i in range(40, 70):
        blk = audio[:, i * 256 : (i + 1) * 256]
        _assert_snapshots_match(jsess.feed(blk), tsess.feed(blk), i)
