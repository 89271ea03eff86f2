"""PyTorch port, stereometer, waveform and the literal default: the same
seeded inputs through the JAX package and the port, on the CPU.

- The three-band crossover's plain version against the JAX package's
  ``three_band_scan`` (its ``lax.scan``), both cascade settings, with
  non-finite samples, over several blocks.
- The stereometer (full band, LR4 bands, band points) and the waveform
  (bands, RMS history at a fast scroll, no bands at a slow one) against the
  JAX analyzers over 40-80 hops with a reset and non-finite samples.
- ``api.analyze`` of the literal ``EngineConfig()`` -- all six analyzers,
  the spectrum at its cadence of 4 -- against the JAX package's, 80 hops.

Bars (``openmeters_tpu_torch/utils/parity.py``): the stereometer's points
and points_valid and the waveform's min/max and valid equal, NaN where
NaN; correlations and band points within 1e-4, colour within 1e-5, RMS
within 0.01 dB, progress within 1e-6; the crossover's bands within 5e-5 of
full scale (the JAX package's scan rounds its products differently: 1.5e-5
at most here, recorded as ``band_gap``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openmeters_tpu import api as japi  # noqa: E402
from openmeters_tpu.analyzers import stereometer as jst  # noqa: E402
from openmeters_tpu.analyzers import waveform as jw  # noqa: E402
from openmeters_tpu.ops import iir as jiir  # noqa: E402
from openmeters_tpu_torch import api as tapi  # noqa: E402
from openmeters_tpu_torch.analyzers import stereometer as tst  # noqa: E402
from openmeters_tpu_torch.analyzers import waveform as tw  # noqa: E402
from openmeters_tpu_torch.ops import iir as tiir  # noqa: E402
from openmeters_tpu_torch.utils.parity import (  # noqa: E402
    check_snapshot,
    check_snapshots,
    snapshot_errors,
)

B = 256
BAND_ABS = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread runs them faster than many and
    leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stereo(s, hops, seed, bad=True):
    """``[s, hops * 256, 2]``: a sine per stream plus noise on the left, the
    right correlated with it plus a second tone; with ``bad`` a NaN, an
    inf and a -inf pair early, in different streams."""
    rng = np.random.default_rng(seed)
    n = hops * B
    t = np.arange(n) / 48_000.0
    f = rng.uniform(60.0, 6000.0, (s, 1))
    left = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((s, n))
    right = 0.7 * left + 0.2 * np.sin(2 * np.pi * 2.3 * f * t)
    audio = np.stack([left, right], -1).astype(np.float32)
    if bad:
        audio[0, 3000, 0] = np.nan
        audio[1 % s, 7000, 1] = np.inf
        audio[0, 9001, :] = -np.inf
    return audio


@pytest.mark.parametrize(
    "cascade_n,cascade_high,t,lanes",
    [pytest.param(1, False, B, (3, 2), id="1-False"), pytest.param(2, True, B, (3, 2), id="2-True")]
    + [pytest.param(cn, high, t, (37, 2), id=f"{cn}-{high}-{t}-37x2")
       for cn, high in ((1, False), (2, True)) for t in (235, 256, 1024)],
)
def test_three_band_plain_matches_jax(cascade_n, cascade_high, t, lanes, record_property):
    """Also at the block lengths of 44.1, 48 and 192 kHz (235, 256 and 1024
    samples: the chunking the kernel must get right, a short last chunk
    among them) and a lane count that leaves a partial 32-lane tile."""
    rng = np.random.default_rng(cascade_n)
    jstate = jiir.three_band_init(lanes, cascade_n)
    tstate = tiir.three_band_init(lanes, cascade_n)
    gap = 0.0
    for blk in range(3):
        x = (rng.standard_normal((t, *lanes)) * 0.3).astype(np.float32)
        if blk == 1:
            x[10, 1, 0], x[50, 2, 1], x[200, 0, 0] = np.nan, np.inf, -np.inf
        jb, jstate = jiir.three_band_scan(jnp.asarray(x), jstate, 48_000.0, cascade_n=cascade_n,
                                          cascade_high=cascade_high)
        tb, tstate = tiir.three_band_scan(torch.from_numpy(x), tstate, 48_000.0, cascade_n=cascade_n,
                                          cascade_high=cascade_high)
        assert tuple(tb.shape) == (t, 3, *lanes) and tuple(tstate.shape) == tuple(jstate.shape)
        assert bool(torch.isfinite(tb).all())
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=BAND_ABS)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=0, atol=BAND_ABS)
        gap = max(gap, float(np.abs(tb.numpy() - np.asarray(jb)).max()))
    record_property("band_gap", gap)
    # the zeros a non-finite output leaves fall on the same samples
    np.testing.assert_array_equal(tb.numpy() == 0, np.asarray(jb) == 0)


def _run_analyzer(ja, ta, hops, s=3, reset_at=20, seed=3):
    audio = _stereo(s, hops, seed)
    jc, tc = ja.init(s), ta.init(s, device="cpu")
    jstep = jax.jit(ja.step)
    worst = {}
    for i in range(hops):
        blk = audio[:, i * B : (i + 1) * B]
        rm = np.array([False, True, False]) if i == reset_at else None
        jc, jsnap = jstep(jc, jnp.asarray(blk), None if rm is None else jnp.asarray(rm))
        tc, tsnap = ta.step(tc, torch.from_numpy(blk), None if rm is None else torch.from_numpy(rm))
        err = snapshot_errors(tsnap, jsnap)
        check_snapshot(err, f"hop {i}")
        for k, v in err.items():
            if k != "mismatch":
                worst[k] = max(worst.get(k, 0.0), v)
    return tc, tsnap, worst


@pytest.mark.parametrize("kw", [{}, {"analyze_bands": True}, {"emit_band_points": True}],
                         ids=["full_band", "bands", "band_points"])
def test_stereometer_matches_jax(kw, record_property):
    ja = jst.StereometerAnalyzer(jst.StereometerConfig(**kw))
    ta = tst.StereometerAnalyzer(tst.StereometerConfig(**kw))
    tc, snap, worst = _run_analyzer(ja, ta, 40)
    for k, v in worst.items():
        record_property(k, v)
    assert tuple(snap.points.shape) == (3, 4, 960, 2) and bool(snap.points_valid.all())
    # the NaN in stream 0 stays in its moments; stream 1 was reset after its inf
    assert float(snap.correlations[0, 0]) == 0.0 and 0.5 < float(snap.correlations[2, 0]) <= 1.0
    if kw:
        assert "tb" in tc and bool(torch.isfinite(tc["tb"]).all())


@pytest.mark.parametrize(
    "kw,hops",
    [({}, 40), ({"track_history": True, "scroll_speed": 1234.5}, 80),
     ({"analyze_bands": False, "scroll_speed": 47.0}, 40)],
    ids=["bands", "history_fast", "no_bands_slow"],
)
def test_waveform_matches_jax(kw, hops, record_property):
    ja = jw.WaveformAnalyzer(jw.WaveformConfig(**kw))
    ta = tw.WaveformAnalyzer(tw.WaveformConfig(**kw))
    assert ta.cols_cap == ja.cols_cap and ta.ring_blocks == ja.ring_blocks
    tc, snap, worst = _run_analyzer(ja, ta, hops)
    for k, v in worst.items():
        record_property(k, v)
    assert bool(snap.col_valid.any())
    if ta.config.analyze_bands:
        assert tc["ring_head"] == hops % ta.ring_blocks
        assert worst["col_color"] > 0.0 and float(snap.col_color.max()) > 0.01


def test_literal_default_analyze_matches_jax(record_property):
    """``api.analyze`` of ``EngineConfig()``: loudness, the reassigned
    spectrogram, the 16384/1024 spectrum (cadence 4, its first column at
    hop 63), the oscilloscope, the stereometer and the waveform."""
    s, hops = 2, 80
    audio = _stereo(s, hops, seed=11, bad=False)
    jout = japi.analyze(audio)
    tout = tapi.analyze(audio, device="cpu")
    assert len(jout) == len(tout) == hops
    updated = 0
    for i, (js, ts) in enumerate(zip(jout, tout)):
        assert set(ts) == {"loudness", "spectrogram", "oscilloscope", "stereometer", "waveform"} | (
            {"spectrum"} if i >= 3 else set()
        )
        err = check_snapshots(ts, js, f"hop {i}")
        if "spectrum" in ts:
            updated += int(ts["spectrum"].updated.sum())
    record_property("spectrum_db_gap", err["spectrum"]["db"])
    assert updated >= s and bool(tout[-1]["spectrum"].updated.all())
    assert float(tout[-1]["loudness"].integrated_lufs.min()) > -70.0
