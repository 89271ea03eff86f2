"""PyTorch port, the carry checkpoint (``checkpoint.py``) against the JAX
package's on the CPU: a round trip in the port continues exactly like an
uninterrupted run; a ``.npz`` the JAX package wrote restores into the port
and its next hops agree with the JAX package's own continuation, within
the bars of ``utils/parity.py``; a mismatched config raises; the format
(paths, order, fingerprint) is the JAX package's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_pairs import NONE, EnginePair, stereo_audio, to_jax  # noqa: E402

from openmeters_tpu import checkpoint as jck  # noqa: E402
from openmeters_tpu.engine import MeterEngine as JMeterEngine  # noqa: E402
from openmeters_tpu_torch import checkpoint as tck  # noqa: E402
from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.oscilloscope import OscilloscopeConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.stereometer import StereometerConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.waveform import WaveformConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta  # noqa: E402
from openmeters_tpu_torch.utils.parity import check_snapshots  # noqa: E402

S, B = 2, 256


def mixed_engine() -> EngineConfig:
    """Every kind of carry leaf: host ints and bools (ring origins, the
    sliding states' ``count``/``anchored``, the oscilloscope's ``tick``, the
    waveform's ``ring_head``), a sliding spectrum (8192/256) whose state the
    JAX package stores padded to its kernel's 512-bin tiles where that
    kernel runs, and nested tuples."""
    return EngineConfig(
        channels=2,
        loudness=LoudnessConfig(),
        spectrogram=SpectrogramConfig(fft_size=512, hop_size=16, use_reassignment=False),
        spectrum=SpectrumConfig(fft_size=8192, hop_size=256),
        oscilloscope=OscilloscopeConfig(),
        stereometer=StereometerConfig(),
        waveform=WaveformConfig(),
    )


def blocks(hops: int, seed: int) -> list:
    audio = stereo_audio(S, hops * B, seed)
    return [np.ascontiguousarray(audio[:, i * B : (i + 1) * B]) for i in range(hops)]


def test_port_round_trip_continues_exactly(tmp_path):
    engine = MeterEngine(mixed_engine())
    assert engine.analyzers["spectrogram"].use_classic_kernel
    meta = StreamMeta.default(S, channels=2, pad_channels=2)
    carry = engine.init(S, device="cpu")
    data = [torch.from_numpy(b) for b in blocks(50, seed=11)]
    for blk in data[:30]:
        carry, _ = engine.step(carry, blk, meta)
    path = str(tmp_path / "carry.npz")
    tck.save_state(path, engine, carry)
    restored = tck.load_state(path, engine, device="cpu")
    assert restored["oscilloscope"]["tick"] == carry["oscilloscope"]["tick"] == 30
    assert isinstance(restored["spectrum"]["sdft"]["anchored"], bool)
    for i, blk in enumerate(data[30:]):
        carry, a = engine.step(carry, blk, meta)
        restored, b = engine.step(restored, blk, meta)
        for name in a:
            for f in a[name]._fields:
                x, y = getattr(a[name], f), getattr(b[name], f)
                assert torch.equal(x, y) or torch.equal(x.isnan(), y.isnan()) and torch.equal(
                    x.nan_to_num(), y.nan_to_num()
                ), (i, name, f)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """The JAX package runs 36 hops (the spectrum's first column lands at
    hop 31) and writes its carry, its sliding spectrum state padded to
    4608 bins as its kernel stores it; the port loads it (cut to 4097) and
    both continue 16 hops."""
    cfg = mixed_engine()
    pair = EnginePair(cfg, S)
    assert pair.t.analyzers["spectrum"].use_sliding
    data = blocks(52, seed=12)
    for blk in data[:36]:
        pair.jc, _ = pair.j.step(pair.jc, blk, pair.jm)
    saved = dict(pair.jc, spectrum=dict(pair.jc["spectrum"]))
    sdft = dict(saved["spectrum"]["sdft"])
    for k in ("re", "im"):
        sdft[k] = np.pad(np.asarray(sdft[k]), ((0, 0), (0, 4608 - 4097)))
    saved["spectrum"]["sdft"] = sdft
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, pair.j, saved)
    pair.tc = tck.load_state(path, pair.t, device="cpu")
    assert tuple(pair.tc["spectrum"]["sdft"]["re"].shape) == (S, 4097)
    assert isinstance(pair.tc["spectrum"]["sdft"]["count"], int)
    for i, blk in enumerate(data[36:]):
        js, ts = pair.step(blk)
        check_snapshots(ts, js, f"hop {36 + i} after the restore")


def test_mismatched_config_raises(tmp_path):
    engine = MeterEngine(mixed_engine())
    path = str(tmp_path / "carry.npz")
    tck.save_state(path, engine, engine.init(S, device="cpu"))
    other = MeterEngine(dataclasses.replace(mixed_engine(), loudness=LoudnessConfig(floor_db=-80.0)))
    with pytest.raises(ValueError, match="different engine config"):
        tck.load_state(path, other, device="cpu")
    # a JAX checkpoint of another config too
    jpath = str(tmp_path / "jax.npz")
    jengine = JMeterEngine(to_jax(dataclasses.replace(mixed_engine(), **{**NONE, "loudness": LoudnessConfig()})))
    jck.save_state(jpath, jengine, jengine.init(S))
    with pytest.raises(ValueError, match="different engine config"):
        tck.load_state(jpath, engine, device="cpu")


@pytest.mark.parametrize(
    "cfg",
    [EngineConfig(), mixed_engine(), EngineConfig(channels=2, spectrum=SpectrumConfig(hop_size=512)),
     EngineConfig.at_rate(96_000.0, channels=2, spectrogram=None)],
    ids=["default", "mixed", "spectrum-512", "96k"],
)
def test_format_is_the_jax_packages(cfg):
    """The same fingerprint, leaf paths and order, and stream count; the
    port holds no classic-spectrogram sliding state, which the JAX package
    carries (``convert.RETIRED``)."""
    t, j = MeterEngine(cfg), JMeterEngine(to_jax(cfg))
    assert tck._config_fingerprint(t) == jck._config_fingerprint(j)
    import jax

    jpaths, jleaves, _ = jck._flatten(jax.eval_shape(lambda: j.init(3)))
    tflat = tck._flatten(t.init(3, device="meta"))
    assert [p for p, _ in tflat] == [p for p in jpaths if not p.startswith("spectrogram/sdft/")]
    assert tck._infer_streams(t, dict(tflat)) == jck._infer_streams(j, jleaves) == 3


def test_port_checkpoint_of_scalar_leaves_loads_into_jax(tmp_path):
    """Where no leaf is padded (loudness alone), a checkpoint the port wrote
    loads into the JAX package too: host scalars are saved as 0-d arrays."""
    cfg = EngineConfig(channels=2, **{**NONE, "loudness": LoudnessConfig()})
    t, j = MeterEngine(cfg), JMeterEngine(to_jax(cfg))
    meta = StreamMeta.default(S, channels=2, pad_channels=2)
    carry = t.init(S, device="cpu")
    for blk in blocks(12, seed=13):
        carry, _ = t.step(carry, torch.from_numpy(blk), meta)
    path = str(tmp_path / "port.npz")
    tck.save_state(path, t, carry)
    jc = jck.load_state(path, j)
    assert int(np.asarray(jc["loudness"]["gate"]["chunk_pos"])) == carry["loudness"]["gate"]["chunk_pos"]
    np.testing.assert_array_equal(np.asarray(jc["loudness"]["kw"]), carry["loudness"]["kw"].numpy())
