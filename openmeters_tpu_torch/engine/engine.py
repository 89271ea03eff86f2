"""The batched meter engine: one step over all streams and analyzers (port
of ``engine/engine.py``).

A step takes a ``[S, B, C]`` block plus per-stream fold/weight matrices
(:class:`StreamMeta`) and a per-stream reset mask, folds it to stereo and
its mid projection, and fans out to the enabled analyzers.  Ported
analyzers: loudness, the spectrogram and the oscilloscope.  A config that
enables any other analyzer raises ``NotImplementedError`` when the engine
is built.

The oscilloscope runs in external-capture mode (``snapshot_every`` forced
to 0): the step keeps capture metadata only, and
:meth:`MeterEngine.extract_oscilloscope` reads the trace windows.

State updates in place where an analyzer says so (the framing ring, the
loudness rings and histograms, the oscilloscope's history rings): a carry
must not be reused after it has been stepped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from openmeters_tpu_torch.analyzers.loudness import LoudnessAnalyzer, LoudnessConfig
from openmeters_tpu_torch.analyzers.oscilloscope import (
    OscilloscopeAnalyzer,
    OscilloscopeConfig,
)
from openmeters_tpu_torch.analyzers.spectrogram import (
    SpectrogramAnalyzer,
    SpectrogramConfig,
)
from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig
from openmeters_tpu_torch.analyzers.stereometer import StereometerConfig
from openmeters_tpu_torch.analyzers.waveform import WaveformConfig
from openmeters_tpu_torch.utils.channels import (
    MAX_AUDIO_CHANNELS,
    channel_fallback,
    channel_weights,
    stereo_matrix,
)

DSP_BATCH_FRAMES_AT_48K = 256

# analyzers whose port has not landed, with the ROADMAP item that ports them
PENDING = {
    "spectrum": "A8",
    "stereometer": "A9",
    "waveform": "A9",
}


class StreamMeta(NamedTuple):
    fold: torch.Tensor  # [S, C, 2] stereo fold matrices
    weights: torch.Tensor  # [S, C] BS.1770 channel weights

    @staticmethod
    def default(
        n_streams: int, channels: int = 2, pad_channels: int = MAX_AUDIO_CHANNELS
    ) -> "StreamMeta":
        positions = channel_fallback(channels)
        fold = torch.from_numpy(stereo_matrix(channels, positions)[:pad_channels])
        weights = torch.from_numpy(channel_weights(positions)[:pad_channels])
        return StreamMeta(
            fold=fold[None].repeat(n_streams, 1, 1),
            weights=weights[None].repeat(n_streams, 1),
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    sample_rate: float = 48_000.0
    block_frames: int = DSP_BATCH_FRAMES_AT_48K
    channels: int = MAX_AUDIO_CHANNELS
    loudness: LoudnessConfig | None = LoudnessConfig()
    spectrogram: SpectrogramConfig | None = SpectrogramConfig()
    spectrum: SpectrumConfig | None = SpectrumConfig()
    oscilloscope: Any = dataclasses.field(default_factory=OscilloscopeConfig)
    stereometer: Any = dataclasses.field(default_factory=StereometerConfig)
    waveform: Any = dataclasses.field(default_factory=WaveformConfig)

    def resolve(self) -> "EngineConfig":
        """Propagate engine-level rate/block into analyzer configs."""
        kw = dict(sample_rate=self.sample_rate, block_frames=self.block_frames)

        def fix(cfg):
            return dataclasses.replace(cfg, **kw) if cfg is not None else None

        return dataclasses.replace(
            self,
            loudness=(
                dataclasses.replace(self.loudness, channels=self.channels, **kw)
                if self.loudness
                else None
            ),
            spectrogram=fix(self.spectrogram),
            spectrum=fix(self.spectrum),
            oscilloscope=fix(self.oscilloscope),
            stereometer=fix(self.stereometer),
            waveform=fix(self.waveform),
        )


@dataclasses.dataclass(frozen=True)
class MeterEngine:
    config: EngineConfig = EngineConfig()

    def __post_init__(self):
        object.__setattr__(self, "config", self.config.resolve())
        for name, item in PENDING.items():
            if getattr(self.config, name):
                raise NotImplementedError(
                    f"the {name} analyzer is not ported yet (ROADMAP {item}); "
                    f"pass {name}=None"
                )
        self.analyzers  # builds each analyzer, which validates its config

    @property
    def analyzers(self) -> dict:
        cfg = self.config
        out = {}
        if cfg.loudness:
            out["loudness"] = LoudnessAnalyzer(cfg.loudness)
        if cfg.spectrogram:
            out["spectrogram"] = SpectrogramAnalyzer(cfg.spectrogram)
        if cfg.oscilloscope:
            # external capture: the step keeps capture metadata only
            oc = dataclasses.replace(cfg.oscilloscope, snapshot_every=0)
            out["oscilloscope"] = OscilloscopeAnalyzer(oc)
        return out

    def init(self, n_streams: int, device="cuda") -> dict:
        return {
            name: a.init(n_streams, device=device) for name, a in self.analyzers.items()
        }

    def step(self, carry: dict, block: torch.Tensor, meta: StreamMeta, reset_mask=None):
        """One engine hop over ``block [S, B, C]``; ``reset_mask [S]`` bool
        restarts streams.  Returns ``(carry, {name: snapshot})``."""
        block = block.to(torch.float32)
        stereo = torch.einsum("sbc,sct->sbt", block, meta.fold)  # [S, B, 2]
        mid = 0.5 * (stereo[..., 0] + stereo[..., 1])  # [S, B]

        new_carry, snaps = {}, {}
        analyzers = self.analyzers
        if "loudness" in analyzers:
            new_carry["loudness"], snaps["loudness"] = analyzers["loudness"].step(
                carry["loudness"], block, meta.weights, reset_mask
            )
        if "spectrogram" in analyzers:
            new_carry["spectrogram"], snaps["spectrogram"] = analyzers[
                "spectrogram"
            ].step(carry["spectrogram"], mid, reset_mask)
        if "oscilloscope" in analyzers:
            new_carry["oscilloscope"], snaps["oscilloscope"] = analyzers[
                "oscilloscope"
            ].step(carry["oscilloscope"], stereo, reset_mask)
        return new_carry, snaps

    def extract_oscilloscope(self, carry: dict):
        """The oscilloscope's capture windows from the live carry."""
        return self.analyzers["oscilloscope"].extract(carry["oscilloscope"])
