"""Helpers for the port's serving-side tests: a port config as the JAX
package's, the same seeded audio for both, and an engine stepped in both
packages side by side on the CPU."""

import dataclasses
import enum

import numpy as np
import torch

from openmeters_tpu.analyzers.loudness import LoudnessConfig as JLoudnessConfig
from openmeters_tpu.analyzers.oscilloscope import OscilloscopeConfig as JOscilloscopeConfig
from openmeters_tpu.analyzers.oscilloscope import TriggerMode as JTriggerMode
from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig as JSpectrogramConfig
from openmeters_tpu.analyzers.spectrum import AveragingMode as JAveragingMode
from openmeters_tpu.analyzers.spectrum import SpectrumConfig as JSpectrumConfig
from openmeters_tpu.analyzers.stereometer import StereometerConfig as JStereometerConfig
from openmeters_tpu.analyzers.waveform import WaveformConfig as JWaveformConfig
from openmeters_tpu.engine import EngineConfig as JEngineConfig
from openmeters_tpu.engine import MeterEngine as JMeterEngine
from openmeters_tpu.engine import StreamMeta as JStreamMeta
from openmeters_tpu.serve import ServeConfig as JServeConfig
from openmeters_tpu.utils.channels import Channel as JChannel
from openmeters_tpu.utils.windows import WindowKind as JWindowKind
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta

_JAX_TYPES = {
    cls.__name__: cls
    for cls in (
        JEngineConfig, JLoudnessConfig, JSpectrogramConfig, JSpectrumConfig, JOscilloscopeConfig,
        JStereometerConfig, JWaveformConfig, JServeConfig, JWindowKind, JAveragingMode, JChannel,
        JTriggerMode,
    )
}
NONE = dict(loudness=None, spectrogram=None, spectrum=None, oscilloscope=None, stereometer=None,
            waveform=None)


def to_jax(x):
    """The JAX package's counterpart of a port config (dataclasses and
    enums by name and value, recursively)."""
    if dataclasses.is_dataclass(x):
        return _JAX_TYPES[type(x).__name__](
            **{f.name: to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)}
        )
    if isinstance(x, enum.Enum):
        return _JAX_TYPES[type(x).__name__](x.value)
    return x


def tiny_engine(**kw) -> EngineConfig:
    """The JAX serve tests' tiny engine: loudness and a classic 256/64
    spectrogram at two channels."""
    cfg = EngineConfig(
        channels=2,
        spectrogram=SpectrogramConfig(fft_size=256, hop_size=64, use_reassignment=False),
        spectrum=None, oscilloscope=None, stereometer=None, waveform=None,
    )
    return dataclasses.replace(cfg, **kw)


def stereo_audio(s: int, frames: int, seed: int, bad: bool = False) -> np.ndarray:
    """``[s, frames, 2]`` f32: a tone a stream (60 Hz-6 kHz) and a second
    tone on the right, faint noise, levels drawn per stream; with ``bad`` a
    NaN, an inf and a -inf early, in streams 0 and 1."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / 48_000.0
    f = rng.uniform(60.0, 6000.0, (s, 1))
    amp = rng.uniform(0.05, 0.5, (s, 1))
    left = amp * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((s, frames))
    right = 0.5 * left + 0.1 * np.sin(2 * np.pi * 1.7 * f * t)
    audio = np.stack([left, right], -1).astype(np.float32)
    if bad:
        audio[0, 3000, 0], audio[1, 5000, 1], audio[0, 6001, :] = np.nan, np.inf, -np.inf
    return audio


class EnginePair:
    """One engine config in both packages, ``s`` streams, stepped on the
    same blocks; the port on the CPU."""

    def __init__(self, cfg: EngineConfig, s: int):
        self.s = s
        self.t = MeterEngine(cfg)
        self.j = JMeterEngine(to_jax(cfg))
        self.tc = self.t.init(s, device="cpu")
        self.jc = self.j.init(s)
        c = self.t.config.channels
        self.tm = StreamMeta.default(s, channels=2, pad_channels=c)
        self.jm = JStreamMeta.default(s, channels=2, pad_channels=c)

    def step(self, block: np.ndarray, reset=None):
        """One hop of ``block [s, B, C]``; returns ``(jax snaps, port snaps)``."""
        self.jc, js = self.j.step(self.jc, block, self.jm, None if reset is None else np.asarray(reset))
        self.tc, ts = self.t.step(
            self.tc, torch.from_numpy(block), self.tm, None if reset is None else torch.as_tensor(reset)
        )
        if "oscilloscope" in js:
            js = dict(js, oscilloscope=self.j.extract_oscilloscope(self.jc))
            ts = dict(ts, oscilloscope=self.t.extract_oscilloscope(self.tc))
        return js, ts

    def migrate(self, cfg: EngineConfig) -> None:
        """Both packages' ``migrate_carry`` to ``cfg``."""
        t, j = MeterEngine(cfg), JMeterEngine(to_jax(cfg))
        self.tc = t.migrate_carry(self.t, self.tc, self.s)
        self.jc = j.migrate_carry(self.j, self.jc, self.s)
        self.t, self.j = t, j
