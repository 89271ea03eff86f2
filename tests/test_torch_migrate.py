"""PyTorch port, reconfiguration: ``utils/migrate.py``, each analyzer's
``migrate_from`` and ``MeterEngine.migrate_carry``, held against the JAX
package on the CPU.

Each kept case runs N hops under config A in both packages, migrates both
carries to config B, runs M more hops and holds every hop after the
migration to the JAX package's by the bars of ``utils/parity.py``
(``check_snapshots``).  What each change keeps and what it starts afresh
follows the JAX package's own migrate tests in
``tests/test_engine_semantics.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_pairs import NONE, EnginePair, stereo_audio  # noqa: E402

from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.oscilloscope import (  # noqa: E402
    OscilloscopeConfig,
    TriggerMode,
)
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import AveragingMode, SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.stereometer import (  # noqa: E402
    StereometerAnalyzer,
    StereometerConfig,
)
from openmeters_tpu_torch.analyzers.waveform import WaveformAnalyzer, WaveformConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta  # noqa: E402
from openmeters_tpu_torch.utils.channels import Channel  # noqa: E402
from openmeters_tpu_torch.utils.migrate import _compatible, merge_carry  # noqa: E402
from openmeters_tpu_torch.utils.parity import check_snapshots  # noqa: E402

S, B = 2, 256


def engine(**analyzers) -> EngineConfig:
    return EngineConfig(channels=2, **{**NONE, **analyzers})


def run_pair(cfg_a: EngineConfig, cfg_b: EngineConfig, before: int, after: int, seed: int):
    """``before`` hops under ``cfg_a`` in both packages, both migrated to
    ``cfg_b``, then ``after`` hops held to each other.  Returns the pair."""
    pair = EnginePair(cfg_a, S)
    audio = stereo_audio(S, (before + after) * B, seed)
    for i in range(before):
        pair.step(np.ascontiguousarray(audio[:, i * B : (i + 1) * B]))
    pair.migrate(cfg_b)
    for i in range(before, before + after):
        js, ts = pair.step(np.ascontiguousarray(audio[:, i * B : (i + 1) * B]))
        check_snapshots(ts, js, f"hop {i} after the migration")
    return pair


# -- utils/migrate.py ---------------------------------------------------------------


def test_merge_carry_keeps_what_fits_key_by_key():
    old = {
        "a": {"x": torch.ones(2), "n": 3},
        "b": torch.ones(4),
        "c": (torch.ones(1), True),
        "gone": torch.ones(1),
    }
    fresh = {
        # the same keys in another insertion order still fit
        "a": {"n": 0, "x": torch.zeros(2)},
        "b": torch.zeros(5),  # resized
        "c": (torch.zeros(1), 0),  # host bool against host int
        "new": torch.zeros(1),
    }
    out = merge_carry(fresh, old)
    assert out["a"] is old["a"]
    assert out["b"] is fresh["b"]
    assert out["c"] is fresh["c"]
    assert out["new"] is fresh["new"]
    assert "gone" not in out
    assert not _compatible(torch.zeros(2), torch.zeros(2, dtype=torch.int32))
    assert not _compatible({"x": torch.zeros(2)}, {"x": torch.zeros(2), "y": 1})
    assert _compatible({"x": 1, "y": torch.zeros(2)}, {"y": torch.ones(2), "x": 5})


# -- loudness ---------------------------------------------------------------------------


def test_loudness_floor_change_keeps_the_window_and_matches_jax():
    a = engine(loudness=LoudnessConfig(gating=True))
    b = dataclasses.replace(a, loudness=LoudnessConfig(gating=True, floor_db=-80.0))
    pair = run_pair(a, b, 40, 10, seed=1)
    snaps = pair.step(np.zeros((S, B, 2), np.float32))[1]
    # the short-term window still holds the tone
    assert bool((snaps["loudness"].short_term_lufs > -40).all())


def test_loudness_migrate_keeps_fields():
    a = engine(loudness=LoudnessConfig(gating=True))
    e1 = MeterEngine(a)
    carry = e1.init(1, device="cpu")
    e2 = MeterEngine(dataclasses.replace(a, loudness=LoudnessConfig(gating=True, floor_db=-80.0)))
    m = e2.migrate_carry(e1, carry, 1)
    for k in ("kw", "wm", "tp", "gate"):
        assert m["loudness"][k] is carry["loudness"][k], k
    # gating off: the window is kept, the gate goes; on again: a fresh gate
    e3 = MeterEngine(dataclasses.replace(a, loudness=LoudnessConfig(gating=False)))
    m3 = e3.migrate_carry(e1, carry, 1)
    assert "gate" not in m3["loudness"]
    assert m3["loudness"]["wm"] is carry["loudness"]["wm"]
    m4 = e1.migrate_carry(e3, m3, 1)
    assert m4["loudness"]["wm"] is carry["loudness"]["wm"]
    assert m4["loudness"]["gate"]["chunk_pos"] == 0


def test_loudness_gating_on_matches_jax():
    a = engine(loudness=LoudnessConfig(gating=False))
    run_pair(a, engine(loudness=LoudnessConfig(gating=True)), 30, 20, seed=2)


# -- spectrum ----------------------------------------------------------------------------

SP1 = SpectrumConfig(fft_size=1024, hop_size=256, averaging=AveragingMode.EXPONENTIAL, exp_factor=0.5)


@pytest.mark.parametrize(
    "change",
    [dict(floor_db=-90.0), dict(averaging=AveragingMode.PEAK_HOLD), dict(exp_factor=0.9),
     dict(source=Channel.LEFT)],
    ids=["floor", "mode", "factor", "source"],
)
def test_spectrum_migration_matches_jax(change):
    a = engine(loudness=LoudnessConfig(), spectrum=SP1)
    run_pair(a, engine(loudness=LoudnessConfig(), spectrum=dataclasses.replace(SP1, **change)), 8, 12, seed=3)


def test_spectrum_migrate_keeps_fields():
    a = engine(spectrum=SP1)
    e1 = MeterEngine(a)
    carry = e1.init(S, device="cpu")
    meta = StreamMeta.default(S, channels=2, pad_channels=2)
    audio = torch.from_numpy(stereo_audio(S, 8 * B, 4))
    for i in range(8):
        carry, snaps = e1.step(carry, audio[:, i * B : (i + 1) * B], meta)
    assert float(snaps["spectrum"].raw_db[0, 0].max()) > -60

    def migrate(**kw):
        e2 = MeterEngine(engine(spectrum=dataclasses.replace(SP1, **kw)))
        return e2, e2.migrate_carry(e1, carry, S)

    # floor: the PCM is kept, the averaging starts afresh, and the kept PCM
    # makes a column on the very next hop
    e2, m = migrate(floor_db=-90.0)
    assert m["spectrum"]["fb"] is carry["spectrum"]["fb"]
    assert bool((m["spectrum"]["smoothed"] == 0).all())
    _, snaps2 = e2.step(m, audio[:, :B], meta)
    assert bool(snaps2["spectrum"].updated[0])
    assert float(snaps2["spectrum"].raw_db[0, 0].max()) > -60
    # a factor within the mode: all is kept
    assert migrate(exp_factor=0.9)[1]["spectrum"] is carry["spectrum"]
    # a source: fresh buffers
    m = migrate(source=Channel.LEFT)[1]
    assert bool((m["spectrum"]["smoothed"] == 0).all())
    assert int(m["spectrum"]["fb"]["fresh"][0]) == 0
    # an FFT size: a new carry of the new shape
    assert migrate(fft_size=512)[1]["spectrum"]["smoothed"].shape[-1] == 257


def test_sliding_spectrum_floor_change_keeps_the_sliding_state():
    """A held sliding spectrum (hop > block): the sliding-DFT state, in the
    port's layout, with its host ``count`` and ``anchored``, carries over."""
    from openmeters_tpu_torch.analyzers.spectrum import SpectrumAnalyzer

    sp = SpectrumConfig(fft_size=4096, hop_size=512, block_frames=256)
    old = SpectrumAnalyzer(sp)
    assert old.use_sliding and old._held
    carry = old.init(S, device="cpu")
    m = SpectrumAnalyzer(dataclasses.replace(sp, floor_db=-90.0)).migrate_from(old, carry, S)
    assert m["sdft"] is carry["sdft"] and m["fb"] is carry["fb"]
    assert bool((m["raw_db"] == -90.0).all())
    assert SpectrumAnalyzer(dataclasses.replace(sp, fft_size=2048)).migrate_from(old, carry, S) is None


# -- oscilloscope ------------------------------------------------------------------------


def test_oscilloscope_cadence_change_keeps_the_lock_and_matches_jax():
    a = engine(oscilloscope=OscilloscopeConfig(trigger_every=1, snapshot_every=1))
    b = engine(oscilloscope=OscilloscopeConfig(trigger_every=3, snapshot_every=3))
    pair = run_pair(a, b, 45, 12, seed=5)
    assert bool(pair.tc["oscilloscope"]["has_period"].any())


def test_oscilloscope_migrate_keeps_fields():
    a = engine(oscilloscope=OscilloscopeConfig(trigger_every=1, snapshot_every=1))
    e1 = MeterEngine(a)
    carry = e1.init(1, device="cpu")
    meta = StreamMeta.default(1, channels=2, pad_channels=2)
    t = np.arange(40 * B) / 48_000.0
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    audio = torch.from_numpy(np.stack([x, x], -1)[None])
    for i in range(40):
        carry, snaps = e1.step(carry, audio[:, i * B : (i + 1) * B], meta)
    assert bool(e1.extract_oscilloscope(carry).locked[0].any())
    e2 = MeterEngine(engine(oscilloscope=OscilloscopeConfig(trigger_every=3, snapshot_every=3)))
    m = e2.migrate_carry(e1, carry, 1)["oscilloscope"]
    for k in ("period", "has_period", "reference", "ref_period", "hist", "origin", "tick"):
        assert m[k] is carry["oscilloscope"][k], k
    # trigger every 3 hops does not slide the probe: its state goes
    assert "pspec_re" not in m
    # back to every hop: a fresh probe that re-anchors exactly
    back = e1.migrate_carry(e2, e2.migrate_carry(e1, carry, 1), 1)["oscilloscope"]
    assert back["panchored"] is False and back["hist"] is carry["oscilloscope"]["hist"]
    # a trigger-mode change starts over
    e3 = MeterEngine(engine(oscilloscope=OscilloscopeConfig(trigger_mode=TriggerMode.ZERO_CROSSING)))
    assert not bool(e3.migrate_carry(e1, carry, 1)["oscilloscope"]["has_period"].any())


# -- stereometer and waveform ------------------------------------------------------------


@pytest.mark.parametrize(
    "a,b",
    [(StereometerConfig(), StereometerConfig(correlation_window=0.2)),
     (StereometerConfig(), StereometerConfig(analyze_bands=True)),
     (StereometerConfig(emit_band_points=True), StereometerConfig())],
    ids=["window", "bands-on", "bands-off"],
)
def test_stereometer_migration_matches_jax(a, b):
    run_pair(engine(stereometer=a), engine(stereometer=b), 20, 10, seed=6)


def test_stereometer_migrate_fields():
    old = StereometerAnalyzer(StereometerConfig())
    carry = old.init(S, device="cpu")
    new = StereometerAnalyzer(StereometerConfig(analyze_bands=True))
    m = new.migrate_from(old, carry, S)
    assert m["moments"] is carry["moments"] and m["ring"] is carry["ring"]
    assert "tb" in m
    assert StereometerAnalyzer(StereometerConfig(segment_duration=0.05)).migrate_from(old, carry, S) is None


@pytest.mark.parametrize(
    "a,b",
    [(WaveformConfig(), WaveformConfig(scroll_speed=150.0)),
     (WaveformConfig(), WaveformConfig(track_history=True)),
     (WaveformConfig(analyze_bands=False), WaveformConfig())],
    ids=["speed", "history-on", "bands-on"],
)
def test_waveform_migration_matches_jax(a, b):
    run_pair(engine(waveform=a), engine(waveform=b), 20, 10, seed=7)


def test_waveform_migrate_fields():
    old = WaveformAnalyzer(WaveformConfig())
    carry = old.init(S, device="cpu")
    carry["ring_head"] = 3
    m = WaveformAnalyzer(WaveformConfig(scroll_speed=150.0)).migrate_from(old, carry, S)
    assert all(m[k] is carry[k] for k in carry)
    m = WaveformAnalyzer(WaveformConfig(track_history=True)).migrate_from(old, carry, S)
    assert m["cur_min"] is carry["cur_min"] and m["tb"] is not carry["tb"]
    assert m["ring_head"] == 0 and "power_tot" in m
    assert WaveformAnalyzer(WaveformConfig(sample_rate=44_100.0)).migrate_from(old, carry, S) is None


# -- the engine -----------------------------------------------------------------------------


def test_migrate_carry_keeps_unchanged_analyzers_and_reinits_the_spectrogram():
    """The spectrogram has no ``migrate_from``: a change to it starts it
    afresh, and the unchanged loudness carry is kept as it is."""
    a = engine(loudness=LoudnessConfig(),
               spectrogram=SpectrogramConfig(fft_size=256, hop_size=64, use_reassignment=False))
    b = dataclasses.replace(a, spectrogram=SpectrogramConfig(fft_size=512, hop_size=64, use_reassignment=False))
    pair = run_pair(a, b, 12, 12, seed=8)
    e1, e2 = MeterEngine(a), MeterEngine(b)
    carry = e1.init(1, device="cpu")
    m = e2.migrate_carry(e1, carry, 1)
    assert m["loudness"] is carry["loudness"]
    assert m["spectrogram"]["fb"]["buf"].shape != carry["spectrogram"]["fb"]["buf"].shape
    assert pair.t.config == MeterEngine(b).config


def test_migrate_carry_stays_on_its_device():
    e1 = MeterEngine(engine(loudness=LoudnessConfig()))
    carry = e1.init(2, device="meta")
    e2 = MeterEngine(engine(loudness=LoudnessConfig(), waveform=WaveformConfig()))
    m = e2.migrate_carry(e1, carry, 2)
    assert m["waveform"]["cur_min"].device.type == "meta"
    assert m["loudness"] is carry["loudness"]
