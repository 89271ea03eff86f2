"""PyTorch port, oscilloscope: the same seeded inputs through the JAX package
and the port, on the CPU.

- The correlation search's plain versions (``ops/corr.py``) against the JAX
  package's Pallas kernels in interpret mode, at that package's shapes and
  bars (tests/test_pallas_corr.py): dots within 5e-6 of max |dots|; sx,
  sxx and wmean within 1e-5 of max(|ref|, 1).
- ``window_rows`` against the JAX one, bit-exact.
- The analyzer against the JAX analyzer over 80 hops per config and
  signal set, and on noise one step at a time from the JAX carry; the
  engine and session of ``EngineConfig(spectrum=None, stereometer=None,
  waveform=None, channels=2)`` against the JAX package's.

The analyzer's bars are in ``openmeters_tpu_torch/utils/parity.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openmeters_tpu import api as japi  # noqa: E402
from openmeters_tpu.analyzers import oscilloscope as jo  # noqa: E402
from openmeters_tpu.engine import EngineConfig as JEngineConfig  # noqa: E402
from openmeters_tpu.engine import MeterEngine as JMeterEngine  # noqa: E402
from openmeters_tpu.ops import pallas_corr as jcorr  # noqa: E402
from openmeters_tpu.ops.pallas_rows import window_rows as jwindow_rows  # noqa: E402
from openmeters_tpu.utils.channels import Channel as JChannel  # noqa: E402
from openmeters_tpu_torch import api as tapi  # noqa: E402
from openmeters_tpu_torch import convert  # noqa: E402
from openmeters_tpu_torch.analyzers import oscilloscope as to  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine  # noqa: E402
from openmeters_tpu_torch.ops import corr as tcorr  # noqa: E402
from openmeters_tpu_torch.ops import rows as trows  # noqa: E402
from openmeters_tpu_torch.utils.channels import Channel  # noqa: E402
from openmeters_tpu_torch.utils.parity import (  # noqa: E402
    check_corr,
    check_oscilloscope,
    check_reassigned,
    corr_errors,
    oscilloscope_errors,
    reassigned_errors,
)

RATE, B = 48_000.0, 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These shapes are small: one intra-op thread runs them faster than
    many and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("OPENMETERS_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- (a) the correlation search -----------------------------------------------


@pytest.mark.parametrize("s,lw,lt,out", [(8, 7200, 4800, 2401), (5, 6000, 4000, 130)])
def test_corr_dots_plain_matches_pallas(interpret, s, lw, lt, out):
    rng = np.random.default_rng(lw)
    work = rng.standard_normal((s, lw)).astype(np.float32)
    tmpl = rng.standard_normal((s, lt)).astype(np.float32) * (np.arange(lt) < 3000)
    shift = rng.integers(-1440, 2400, size=s).astype(np.int32)
    want = np.asarray(jcorr.corr_dots(jnp.asarray(work), jnp.asarray(tmpl), jnp.asarray(shift), 8192, out))
    got = tcorr.corr_dots(_t(work), _t(tmpl), _t(shift), 8192, out)
    assert got.shape == (s, out) and got.dtype == torch.float32
    check_corr(corr_errors(got, _t(want)), "corr_dots")


def _search_inputs(seed, s, kcap=4800, wcap=7200):
    rng = np.random.default_rng(seed)
    tmpl = rng.standard_normal((s, kcap)).astype(np.float32)
    klen = rng.integers(1920, kcap + 1, s).astype(np.int32)
    wlen = np.minimum(klen + 1000, wcap).astype(np.int32)
    shift = rng.integers(-1440, 1, s).astype(np.int32)
    return rng, tmpl, klen, wlen, shift


def test_corr_dots_sums_plain_matches_pallas(interpret):
    rng, tmpl, klen, wlen, shift = _search_inputs(7, 6)
    work = rng.standard_normal((6, 7200)).astype(np.float32)
    want = jcorr.corr_dots_sums(*map(jnp.asarray, (work, tmpl, klen, wlen, shift)), 8192, 2401)
    got = tcorr.corr_dots_sums(*map(_t, (work, tmpl, klen, wlen, shift)), 8192, 2401)
    assert [tuple(g.shape) for g in got] == [(6, 2401)] * 3 + [(6,)]
    check_corr(corr_errors(got, tuple(_t(np.asarray(w)) for w in want)), "corr_dots_sums")


def test_corr_dots_sums_ring_plain_matches_pallas(interpret):
    """Starts 0, 127, 9727 and 12256 hit the kernel's coarse-block clamp;
    -5 and 19000 are clipped to the ring."""
    s, lanes = 8, 19456
    rng, tmpl, klen, wlen, shift = _search_inputs(9, s)
    ring = rng.standard_normal((s, lanes)).astype(np.float32)
    starts = np.array([0, 1, 127, 5000, 9727, 12256, -5, 19000], np.int32)
    args = (ring, starts, tmpl, klen, wlen, shift)
    want = jcorr.corr_dots_sums_ring(*map(jnp.asarray, args), 8192, 2401, wcap=7200)
    got = tcorr.corr_dots_sums_ring(*map(_t, args), 8192, 2401, 7200)
    check_corr(corr_errors(got, tuple(_t(np.asarray(w)) for w in want)), "corr_dots_sums_ring")
    # and the plain ring read is the plain search on the clipped window
    work = np.stack([ring[i, st : st + 7200] for i, st in enumerate(np.clip(starts, 0, lanes - 7200))])
    direct = tcorr.corr_dots_sums(*map(_t, (work, tmpl, klen, wlen, shift)), 8192, 2401)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))


def test_corr_sums_match_direct_windows():
    """The plain sums against direct numpy window sums in float64."""
    rng, tmpl, klen, wlen, shift = _search_inputs(11, 4)
    work = rng.standard_normal((4, 7200)).astype(np.float32)
    _, sx, sxx, wmean = tcorr.corr_dots_sums(*map(_t, (work, tmpl, klen, wlen, shift)), 8192, 2401)
    w64 = work.astype(np.float64)
    for i in range(4):
        k = klen[i]
        ref_sx = np.array([w64[i, o : o + k].sum() for o in range(2401)])
        ref_sxx = np.array([(w64[i, o : o + k] ** 2).sum() for o in range(2401)])
        assert np.abs(sx[i].numpy() - ref_sx).max() <= 1e-5 * max(np.abs(ref_sx).max(), 1.0)
        assert np.abs(sxx[i].numpy() - ref_sxx).max() <= 1e-5 * max(np.abs(ref_sxx).max(), 1.0)
        assert abs(float(wmean[i]) - w64[i, : wlen[i]].mean()) <= 1e-5


# -- (b) window_rows ------------------------------------------------------------


@pytest.mark.parametrize("s,n,length", [(16, 1024, 512), (8, 9603, 7200), (3, 257, 100), (4, 19456, 4802)])
def test_window_rows_matches_jax(s, n, length):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((s, n)).astype(np.float32)
    starts = rng.integers(-5, n, s).astype(np.int32)  # clip cases included
    want = np.asarray(jwindow_rows(jnp.asarray(x), jnp.asarray(starts), length))
    got = trows.window_rows(_t(x), _t(starts), length)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_rows_multi_window_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    starts = rng.integers(-10, 2048, (8, 3)).astype(np.int32)
    want = np.asarray(jwindow_rows(jnp.asarray(x), jnp.asarray(starts), 300))
    got = trows.window_rows(_t(x), _t(starts), 300)
    assert got.shape == (8, 3, 300)
    np.testing.assert_array_equal(got.numpy(), want)


# -- (c) the analyzer over runs -------------------------------------------------

HOPS = 80
RESET_HOP = 50


def _signals(kind: str, hops: int = HOPS):
    """``[4, hops * B, 2]`` stereo, from a seed, and the reset mask at
    ``RESET_HOP``.

    ``tones``: sines at 110, 440 and 1234 Hz and a 220 Hz sawtooth.
    ``changes``: a 220 -> 880 Hz glide, silence then a 330 Hz onset at hop
    30, a 440 Hz sine reset at ``RESET_HOP``, a quiet 660 Hz sine plus its
    octave.  Right is left at 0.8 with an added 1.5x tone, so the four
    projections differ."""
    rng = np.random.default_rng({"tones": 31, "changes": 32}[kind])
    n = hops * B
    t = np.arange(n) / RATE
    if kind == "tones":
        left = np.stack([
            0.6 * np.sin(2 * np.pi * 110.0 * t),
            0.5 * np.sin(2 * np.pi * 440.0 * t),
            0.4 * np.sin(2 * np.pi * 1234.0 * t),
            0.5 * (2.0 * ((220.0 * t) % 1.0) - 1.0),
        ])
        base = np.array([110.0, 440.0, 1234.0, 220.0])
    else:
        k = 2.0 * np.log(2.0) / (n / RATE)
        glide = 0.5 * np.sin(2 * np.pi * 220.0 * (np.exp(k * t) - 1.0) / k)
        onset = np.where(t >= 30 * B / RATE, 0.5 * np.sin(2 * np.pi * 330.0 * t), 0.0)
        quiet = 0.003 * (np.sin(2 * np.pi * 660.0 * t) + 0.5 * np.sin(2 * np.pi * 1320.0 * t))
        left = np.stack([glide, onset, 0.5 * np.sin(2 * np.pi * 440.0 * t), quiet])
        base = np.array([220.0, 330.0, 440.0, 660.0])
    right = 0.8 * left + 0.2 * np.sin(2 * np.pi * 1.5 * base[:, None] * t + rng.uniform(0, 6, (4, 1)))
    audio = np.stack([left, right], -1) + 1e-4 * rng.standard_normal((4, n, 2))
    reset = np.array([False, False, kind == "changes", kind == "tones"])
    return audio.astype(np.float32), reset


CONFIGS = {
    "default": {},
    "external": dict(snapshot_every=0),
    "every_hop_snapshot": dict(snapshot_every=1),
    "zero_crossing": dict(trigger_mode="zero_crossing", channel_1="left", channel_2="right"),
    "independent": dict(trigger_source="none", channel_1="left", channel_2="right"),
    "separate_source": dict(trigger_source="side", channel_1="left", channel_2="right"),
    "trigger_every_3": dict(trigger_every=3),
}


def _osc_configs(name):
    kw = CONFIGS[name]
    jkw, tkw = dict(kw), dict(kw)
    if "trigger_mode" in kw:
        jkw["trigger_mode"] = jo.TriggerMode(kw["trigger_mode"])
        tkw["trigger_mode"] = to.TriggerMode(kw["trigger_mode"])
    for f in ("trigger_source", "channel_1", "channel_2"):
        if f in kw:
            jkw[f], tkw[f] = JChannel(kw[f]), Channel(kw[f])
    return jo.OscilloscopeAnalyzer(jo.OscilloscopeConfig(**jkw)), to.OscilloscopeAnalyzer(
        to.OscilloscopeConfig(**tkw)
    )


def _state(carry):
    return {k: v for k, v in carry.items() if k in ("has_period", "missed", "reference", "pspec_re", "pspec_im")}


def _jax_state(carry):
    return {k: np.asarray(v) for k, v in _state(carry).items()}


@pytest.mark.parametrize("kind", ["tones", "changes"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_analyzer_matches_jax(name, kind, record_property):
    ja, ta = _osc_configs(name)
    audio, reset = _signals(kind)
    s = audio.shape[0]
    jc, tc = ja.init(s), ta.init(s)
    step = ja.step
    locked_hops = 0
    position, moved = 0.0, 0
    for i in range(HOPS):
        blk = audio[:, i * B : (i + 1) * B]
        rm = reset if i == RESET_HOP else None
        jc, js = step(jc, blk, None if rm is None else jnp.asarray(rm))
        tc, ts = ta.step(tc, _t(blk), None if rm is None else _t(rm))
        if ja.external_capture:
            js, ts = ja.extract(jc), ta.extract(tc)
        assert ts.samples.shape == js.samples.shape and ts.start.dtype == torch.int32
        errors = oscilloscope_errors(ts, js, _state(tc), _jax_state(jc))
        check_oscilloscope(errors, f"{name}/{kind} hop {i}")
        locked_hops += int(ts.locked.sum())
        position, moved = max(position, errors["position"]), moved + errors["start_moved"]
    # the largest capture-position gap and the one-sample start moves, for
    # the bars' record (``--junitxml``)
    record_property("position_gap", position)
    record_property("start_moved", moved)
    assert tc["origin"] == int(jc["origin"]) and tc["tick"] == int(jc["tick"])
    if ja.config.trigger_mode is jo.TriggerMode.STABLE:
        assert locked_hops > 0


# -- (d) noise, one step at a time from the JAX carry ----------------------------


@pytest.mark.parametrize("name", ["default", "independent", "trigger_every_3"])
def test_analyzer_single_steps_on_noise(name, record_property):
    """Each hop the JAX carry is converted into the port's and both step
    once: one step's error, apart from trajectories that part on a near
    tie (noise locks and unlocks on decisions at their thresholds)."""
    ja, ta = _osc_configs(name)
    rng = np.random.default_rng(21)
    s, hops = 3, 60
    t = np.arange(hops * B) / RATE
    audio = 0.3 * rng.standard_normal((s, hops * B, 2))
    audio[1] += 0.3 * np.sin(2 * np.pi * 150.0 * t)[:, None]  # tone in noise
    audio = audio.astype(np.float32)
    reset = np.array([True, False, True])
    jc = ja.init(s)
    step = ja.step
    position = 0.0
    for i in range(hops):
        blk = audio[:, i * B : (i + 1) * B]
        rm = reset if i == 40 else None
        tc = convert.carry_from_jax(jax.device_get(jc), ta, device="cpu")
        tc, ts = ta.step(tc, _t(blk), None if rm is None else _t(rm))
        jc, js = step(jc, blk, None if rm is None else jnp.asarray(rm))
        errors = oscilloscope_errors(ts, js, _state(tc), _jax_state(jc))
        check_oscilloscope(errors, f"{name} hop {i}")
        position = max(position, errors["position"])
    record_property("position_gap", position)


# -- (e) the engine and session ---------------------------------------------------


def test_engine_session_matches_jax():
    """``EngineConfig()`` minus the analyzers not ported yet, through both
    packages' ``AnalysisSession.feed`` with a reset at hop 45."""
    kw = dict(spectrum=None, stereometer=None, waveform=None, channels=2)
    audio, reset = _signals("changes", hops=60)
    audio = audio[:2]
    reset = reset[1:3]
    jsess = japi.AnalysisSession(JMeterEngine(JEngineConfig(**kw)), 2)
    tsess = tapi.AnalysisSession(MeterEngine(EngineConfig(**kw)), 2, "cpu")
    osc = tsess.engine.analyzers["oscilloscope"]
    assert osc.external_capture and osc.config.snapshot_every == 0
    locked = 0
    for i in range(60):
        blk = audio[:, i * B : (i + 1) * B]
        rm = reset if i == 45 else None
        js, ts = jsess.feed(blk, rm), tsess.feed(blk, rm)
        assert set(ts) == {"loudness", "spectrogram", "oscilloscope"}
        jl, tl = js["loudness"], ts["loudness"]
        for f in jl._fields:
            tol = 1e-3 if f == "true_peak_db" else 0.01
            np.testing.assert_allclose(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)), rtol=0, atol=tol)
        jg, tg = js["spectrogram"], ts["spectrogram"]
        valid = torch.from_numpy(np.asarray(jg.valid))
        assert torch.equal(tg.valid, valid)
        err, _ = reassigned_errors(
            (tg.freq_hz, tg.time_offset, tg.power),
            tuple(torch.from_numpy(np.asarray(x)) for x in (jg.freq_hz, jg.time_offset, jg.power)),
            valid, drift=True,
        )
        check_reassigned(err, f"hop {i}")
        errors = oscilloscope_errors(
            ts["oscilloscope"], js["oscilloscope"],
            _state(tsess.carry["oscilloscope"]), _jax_state(jsess.carry["oscilloscope"]),
        )
        check_oscilloscope(errors, f"hop {i}")
        assert ts["oscilloscope"].samples.shape == (2, 2, osc.window_cap)
        locked += int(ts["oscilloscope"].locked.sum())
    assert locked > 0


def test_engine_defaults_and_carry_tree():
    engine = MeterEngine(EngineConfig(spectrum=None, stereometer=None, waveform=None))
    osc = engine.analyzers["oscilloscope"]
    assert (osc.history_frames, osc.ring_cap, osc.probe_frames, osc.nsdf_fft) == (9603, 9728, 4800, 8192)
    assert (osc.kernel_cap, osc.search_cap, osc.work_cap, osc.corr_fft, osc.window_cap) == (
        4800, 2400, 7200, 8192, 4802,
    )
    assert osc.n_trig == 1 and osc.slides_probe and osc.external_capture
    carry = engine.init(2, device="meta")["oscilloscope"]
    jcarry = JMeterEngine(JEngineConfig(spectrum=None, stereometer=None, waveform=None)).init(2)[
        "oscilloscope"
    ]
    back = convert.carry_to_numpy(convert.carry_from_jax(jax.device_get(jcarry), osc, device="cpu"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(jcarry)):
        ours = back
        for key in path:
            ours = ours[getattr(key, "key", getattr(key, "idx", None))]
        assert ours.dtype == np.asarray(leaf).dtype and ours.shape == np.shape(leaf), path
    assert isinstance(carry["hist"], tuple) and len(carry["hist"]) == 3
    assert carry["hist"][0].shape == (2, 19456) and carry["pspec_re"].shape == (2, 4097)


def test_independent_triggers_lock_to_their_own_periods():
    """No trigger source: left and right lock to their own periods
    (tests/test_oscilloscope.py's case, on the port alone)."""
    _, ta = _osc_configs("independent")
    assert ta.independent_triggers and ta.n_trig == 2
    t = np.arange(40 * B) / RATE
    audio = np.stack([np.sin(2 * np.pi * 220.0 * t), np.sin(2 * np.pi * 347.0 * t)], -1)[None]
    audio = audio.astype(np.float32)
    carry = ta.init(1)
    for i in range(40):
        carry, snap = ta.step(carry, _t(audio[:, i * B : (i + 1) * B]))
    assert bool(snap.locked.all())
    np.testing.assert_allclose(snap.period[0].numpy(), [RATE / 220.0, RATE / 347.0], atol=2.0)


def test_port_configs_match_reference_sizing():
    """Static sizes agree for every config here and at other rates."""
    for name in CONFIGS:
        ja, ta = _osc_configs(name)
        for rate in (44_100.0, 48_000.0, 96_000.0):
            jr = jo.OscilloscopeAnalyzer(dataclasses.replace(ja.config, sample_rate=rate))
            tr = to.OscilloscopeAnalyzer(dataclasses.replace(ta.config, sample_rate=rate))
            for prop in ("history_frames", "ring_cap", "window_cap", "corr_fft", "nsdf_fft",
                         "work_cap", "n_trig", "slides_probe", "holds_snap", "trigger_lane_slots"):
                assert getattr(tr, prop) == getattr(jr, prop), (name, rate, prop)
