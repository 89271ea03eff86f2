"""Batch API: arrays in, per-hop snapshots out (port of ``api.py``).

``analyze()`` is the single-call entry; ``AnalysisSession`` holds state for
incremental feeding.  Both run on the card (``"cuda"``) unless given
another torch device, and return snapshots as tensors on it.  Where no card
is present ``"cuda"`` raises; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta


@dataclasses.dataclass
class AnalysisSession:
    """Incremental batched analysis over ``[n_streams]`` recordings."""

    engine: MeterEngine
    n_streams: int
    device: torch.device | str = "cuda"
    meta: StreamMeta | None = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.carry = self.engine.init(self.n_streams, device=self.device)
        if self.meta is None:
            self.meta = StreamMeta.default(
                self.n_streams, channels=2, pad_channels=self.engine.config.channels
            )
        self.meta = StreamMeta(*(torch.as_tensor(m).to(self.device) for m in self.meta))
        # a cadenced spectrum (hop = R engine blocks): the R blocks of the
        # current spectrum hop are copied into a [R, S, B, C] buffer on the
        # device (a copy, so a caller may refill its own block), and the
        # newest spectrum snapshot is held between spectrum hops
        self._pending_blocks: torch.Tensor | None = None
        self._pending_resets: torch.Tensor | None = None  # [R, S], once a hop carries a mask
        self._n_pending = 0
        self._held_spectrum = None

    def feed(self, block, reset_mask=None) -> dict:
        """One hop of ``[n_streams, block_frames, channels]`` audio."""
        block = torch.as_tensor(block, dtype=torch.float32).to(self.device)
        if reset_mask is not None:
            reset_mask = torch.as_tensor(reset_mask, dtype=torch.bool).to(self.device)
        self.carry, snaps = self.engine.step(self.carry, block, self.meta, reset_mask)
        if "oscilloscope" in snaps:
            # the engine's oscilloscope keeps capture metadata only; offline
            # analysis reads the trace windows every hop
            snaps["oscilloscope"] = self.engine.extract_oscilloscope(self.carry)
        r = self.engine.spectrum_cadence
        if r > 1:
            if self._pending_blocks is None:
                self._pending_blocks = torch.empty((r, *block.shape), device=self.device)
            self._pending_blocks[self._n_pending].copy_(block)
            if reset_mask is not None:
                if self._pending_resets is None:
                    self._pending_resets = torch.zeros((r, self.n_streams), dtype=torch.bool,
                                                       device=self.device)
                self._pending_resets[self._n_pending].copy_(reset_mask)
            self._n_pending += 1
            if self._n_pending == r:
                # the spectrum hop takes the OR of its engine hops' masks
                resets = None if self._pending_resets is None else self._pending_resets.any(dim=0)
                self.carry["spectrum"], self._held_spectrum = self.engine.spectrum_step(
                    self.carry["spectrum"], self._pending_blocks, self.meta, resets
                )
                self._n_pending = 0
                self._pending_resets = None
            if self._held_spectrum is not None:
                snaps["spectrum"] = self._held_spectrum
        return snaps

    def run(self, audio, collect: bool = True) -> list[dict]:
        """Feed ``[n_streams, frames, channels]`` fully; returns the
        snapshots of each hop."""
        b = self.engine.config.block_frames
        n = audio.shape[1] // b
        out = []
        for i in range(n):
            snaps = self.feed(audio[:, i * b : (i + 1) * b])
            if collect:
                out.append(snaps)
        return out


def _pad_channels(audio: np.ndarray, channels: int) -> np.ndarray:
    s, t, c = audio.shape
    if c == channels:
        return audio
    if c > channels:
        return audio[:, :, :channels]
    out = np.zeros((s, t, channels), np.float32)
    out[:, :, :c] = audio
    return out


def analyze(
    audio: np.ndarray,
    sample_rate: float = 48_000.0,
    config: EngineConfig | None = None,
    *,
    device: torch.device | str = "cuda",
) -> list[dict]:
    """Analyze recordings on ``device``.

    Args:
      audio: ``[frames, channels]`` (one stream) or
        ``[n_streams, frames, channels]`` float32.
      sample_rate: shared sample rate.
      config: engine config; defaults to all default analyzers.
      device: torch device to run on: the card by default, or ``"cpu"``.

    Returns a list of per-hop snapshot dicts (final entry = end state).
    """
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 2:
        audio = audio[None]
    if config is None:
        config = EngineConfig(sample_rate=sample_rate)
    else:
        config = dataclasses.replace(config, sample_rate=sample_rate)
    engine = MeterEngine(config)
    audio = _pad_channels(audio, engine.config.channels)
    session = AnalysisSession(engine, audio.shape[0], device)
    return session.run(audio)


def analyze_wav(
    path: str, config: EngineConfig | None = None, *, device: torch.device | str = "cuda"
) -> list[dict]:
    """Analyze one WAV file through every configured analyzer, at the
    file's own sample rate, on ``device``."""
    from openmeters_tpu_torch.io.wav import read_wav

    samples, rate = read_wav(path)
    return analyze(samples, rate, config, device=device)
