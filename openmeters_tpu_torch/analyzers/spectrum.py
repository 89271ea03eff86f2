"""Spectrum analyzer: dual-trace FFT with power-domain averaging (port of
``analyzers/spectrum.py``).

Up to two traces (primary and secondary source in {L, R, Mid, Side,
None}), each transformed every hop; averaging None / Exponential / Peak
hold runs in the power domain with a state floor lifted by the largest
positive A-weighting, so weighting cannot bring sub-floor bins back; the
outputs are A-weighted and raw dB per trace.  The active traces of all
streams run as one ``[S * trace_count]``-lane framing and transform; the
per-stream trace projections are data (``[S, trace_count, 2]``).

Three paths, by config:

- ``fft / hop <= 16`` (the stock 16384/1024, which the engine runs at
  block = hop): a windowed ``torch.fft.rfft`` of each ready frame;
- otherwise the sliding DFT (``ops/sliding_stft.py``) with power out, every
  hop: the B1a hop for small ``[hop, bins]`` (8192/128), the B1b hop on
  rFFT'd delta spectra past that (16384/512, 16384/128);
- ``hop > block`` slides only on hops that emit a column or carry a reset,
  holding its dB outputs in the carry between them.  ``ready`` is a host
  int; a reset mask costs one ``any()`` sync on the hops that carry one.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import NamedTuple

import numpy as np
import torch

from openmeters_tpu_torch.ops.framing import FrameBuffer
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT
from openmeters_tpu_torch.utils.channels import Channel, projection_vector
from openmeters_tpu_torch.utils.level import (
    LN_TO_DB,
    db_to_power_host,
    sanitize_negative_db,
    sanitize_sample_rate,
)
from openmeters_tpu_torch.utils.migrate import carry_device
from openmeters_tpu_torch.utils.weighting import a_weight_db
from openmeters_tpu_torch.utils.windows import (
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

DEFAULT_FFT_SIZE = 16_384
DEFAULT_HOP_DIVISOR = 16
DEFAULT_DB_FLOOR = -100.0


class AveragingMode(enum.Enum):
    NONE = "none"
    EXPONENTIAL = "exponential"
    PEAK_HOLD = "peak_hold"


class SpectrumSnapshot(NamedTuple):
    weighted_db: torch.Tensor  # [S, trace_count, bins] A-weighted dB
    raw_db: torch.Tensor  # [S, trace_count, bins]
    updated: torch.Tensor  # [S] bool, a column was produced this step


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    sample_rate: float = 48_000.0
    fft_size: int = DEFAULT_FFT_SIZE
    hop_size: int = DEFAULT_FFT_SIZE // DEFAULT_HOP_DIVISOR
    window: WindowKind = WindowKind.HANN
    averaging: AveragingMode = AveragingMode.NONE
    exp_factor: float = 0.5
    peak_decay_db_per_s: float = 12.0
    source: Channel = Channel.MID
    secondary_source: Channel = Channel.NONE
    floor_db: float = DEFAULT_DB_FLOOR
    block_frames: int = 256

    def normalized(self) -> "SpectrumConfig":
        fft = max(self.fft_size, 1)
        hop = self.hop_size or max(fft // DEFAULT_HOP_DIVISOR, 1)
        return dataclasses.replace(
            self,
            sample_rate=sanitize_sample_rate(self.sample_rate),
            fft_size=fft,
            hop_size=hop,
            floor_db=sanitize_negative_db(self.floor_db, DEFAULT_DB_FLOOR),
        )

    @property
    def active_sources(self) -> tuple[Channel, ...]:
        """The traces that run: ``Channel.NONE`` and a duplicate secondary
        are skipped; an all-NONE config keeps one silent trace."""
        out = []
        for ch in (self.source, self.secondary_source):
            if ch is not Channel.NONE and ch not in out:
                out.append(ch)
        return tuple(out) or (Channel.NONE,)

    @property
    def trace_count(self) -> int:
        return len(self.active_sources)

    def default_projections(self) -> np.ndarray:
        """``[trace_count, 2]`` stereo projections of the active traces."""
        return np.stack([projection_vector(ch) for ch in self.active_sources])


@dataclasses.dataclass(frozen=True)
class SpectrumAnalyzer:
    config: SpectrumConfig = SpectrumConfig()

    @property
    def bins(self) -> int:
        return self.config.fft_size // 2 + 1

    @property
    def _frames(self) -> FrameBuffer:
        cfg = self.config
        return FrameBuffer(cfg.fft_size, cfg.hop_size, cfg.block_frames)

    @property
    def frequency_bins(self) -> np.ndarray:
        bin_hz = self.config.sample_rate / self.config.fft_size
        return (np.arange(self.bins) * bin_hz).astype(np.float32)

    @property
    def a_weighting(self) -> np.ndarray:
        return a_weight_db(self.frequency_bins)

    @property
    def state_floor(self) -> float:
        """Power floor of the averaging state: the floor less the largest
        positive weighting, so weighting cannot lift sub-floor bins."""
        headroom = float(np.maximum(np.max(self.a_weighting), 0.0))
        return max(
            db_to_power_host(self.config.floor_db - headroom),
            float(np.finfo(np.float32).tiny),
        )

    @property
    def _sliding(self) -> SlidingSTFT:
        cfg = self.config
        return SlidingSTFT(cfg.fft_size, cfg.hop_size, cfg.block_frames, cfg.window)

    @property
    def use_sliding(self) -> bool:
        """Sliding DFT where many hops share one window (``fft / hop >
        16``) and always when ``hop > block``; else the direct rFFT."""
        cfg = self.config
        if not self._sliding.supported:
            return False
        if cfg.hop_size > cfg.block_frames:
            return True
        return cfg.fft_size // cfg.hop_size > 16

    @property
    def _held(self) -> bool:
        """The dB outputs are held in the carry between sliding hops."""
        return self.use_sliding and self.config.hop_size > self.config.block_frames

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _tensors(self, device: torch.device):
        """``(window, norm, a_weighting, projections)`` on ``device``."""
        cfg = self.config
        w = window_coefficients(cfg.window, cfg.fft_size)
        arrs = (w, fft_bin_normalization(w, cfg.fft_size), self.a_weighting,
                cfg.default_projections().astype(np.float32))
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrs)

    def init(self, n_streams: int, device=None) -> dict:
        floor = self.config.floor_db
        tc = self.config.trace_count
        shape = (n_streams, tc, self.bins)
        carry = {
            "fb": self._frames.init(n_streams * tc, device=device),
            "smoothed": torch.zeros(shape, dtype=torch.float32, device=device),
        }
        if self._held:
            carry["raw_db"] = torch.full(shape, floor, dtype=torch.float32, device=device)
            carry["weighted_db"] = torch.full(shape, floor, dtype=torch.float32, device=device)
        if self.use_sliding:
            carry["sdft"] = self._sliding.init(n_streams * tc, device=device)
        return carry

    def migrate_from(self, old: "SpectrumAnalyzer", carry: dict, n_streams: int):
        """Field-level retention across a config change:

        - FFT size, window or block changed: start over (``None``);
        - rate, hop or sources changed: fresh PCM and level state;
        - averaging mode or floor changed: the framing and sliding state
          are kept (the next hop emits a column from the audio already
          held), the averaging state and held dB start afresh;
        - a factor within the same mode changed: all is kept.
        """
        a, b = old.config, self.config
        if a == b:
            return carry
        if (a.fft_size, a.window, a.block_frames) != (b.fft_size, b.window, b.block_frames):
            return None
        fresh = self.init(n_streams, device=carry_device(carry))
        if (a.sample_rate, a.hop_size, a.source, a.secondary_source) != (
            b.sample_rate, b.hop_size, b.source, b.secondary_source
        ):
            return fresh
        if a.averaging is not b.averaging or a.floor_db != b.floor_db:
            out = dict(fresh)
            out["fb"] = carry["fb"]
            if "sdft" in carry and "sdft" in fresh:
                out["sdft"] = carry["sdft"]
            return out
        return carry

    def _to_db(self, power: torch.Tensor):
        """Power -> ``(raw_db, weighted_db)`` under the state floor."""
        floor = self.config.floor_db
        weighting = self._tensors(power.device)[2]
        db = torch.log(torch.clamp_min(power, 1e-45)) * LN_TO_DB
        below = power < self.state_floor
        raw_db = torch.where(below, floor, torch.clamp_min(db, floor))
        weighted_db = torch.where(below, floor, torch.clamp_min(db + weighting, floor))
        return raw_db, weighted_db

    def emit(self, carry: dict) -> SpectrumSnapshot:
        """Snapshot of the carry's averaging state without advancing it;
        ``updated`` is all false."""
        if self._held:
            raw_db, weighted_db = carry["raw_db"], carry["weighted_db"]
        else:
            raw_db, weighted_db = self._to_db(carry["smoothed"])
        s = raw_db.shape[0]
        return SpectrumSnapshot(
            weighted_db=weighted_db, raw_db=raw_db,
            updated=torch.zeros((s,), dtype=torch.bool, device=raw_db.device),
        )

    def _smooth_cols(self, smoothed, power, valid):
        """Fold ``power [S, tc, cols, bins]`` into the averaging state,
        column by column where ``valid [S, tc, cols]``."""
        cfg = self.config
        state_floor = self.state_floor
        for col in range(power.shape[2]):
            p = power[:, :, col]
            v = valid[:, :, col][..., None]
            if cfg.averaging is AveragingMode.NONE:
                # 'smoothed' doubles as the last raw power, so snapshots
                # hold between hops
                smoothed = torch.where(v, p, smoothed)
                continue
            if cfg.averaging is AveragingMode.EXPONENTIAL:
                alpha = min(max(cfg.exp_factor, 0.0), 0.9999)
                nxt = torch.where(smoothed <= 0.0, p, smoothed * alpha + p * (1 - alpha))
            else:  # PEAK_HOLD
                dt = cfg.hop_size / cfg.sample_rate
                decay = db_to_power_host(-max(cfg.peak_decay_db_per_s, 0.0) * dt)
                nxt = torch.maximum(smoothed * decay, p)
            nxt = torch.where(nxt < state_floor, 0.0, nxt)
            smoothed = torch.where(v, nxt, smoothed)
        return smoothed

    def step(self, carry: dict, block: torch.Tensor, projections=None, reset_mask=None, any_reset=None):
        """One hop of ``[S, B, 2]`` folded stereo samples.

        Args:
          projections: ``[S, trace_count, 2]`` per-stream trace projections
            (default: the config's sources).
          reset_mask: ``[S]`` bool stream restarts.
          any_reset: whether any stream of the whole batch restarts (a host
            bool; default: ``reset_mask.any()``).  A shard of a mesh passes
            the batch's, so the held branch below, which advances the
            sliding ``count``, is taken alike on every shard.

        Returns ``(carry, SpectrumSnapshot)``.
        """
        cfg = self.config
        s, b, _ = block.shape
        tc = cfg.trace_count
        window, norm, _, default_proj = self._tensors(block.device)
        if projections is None:
            projections = default_proj.expand(s, tc, 2)
        traces = torch.einsum("sbc,stc->stb", block.to(torch.float32), projections)

        lane_reset = None if reset_mask is None else torch.repeat_interleave(reset_mask, tc)
        fb = self._frames
        fb_carry, info = fb.advance(carry["fb"], traces.reshape(s * tc, b), lane_reset)
        valid = info["valid"].reshape(s, tc, fb.cols_cap)

        smoothed = carry["smoothed"]
        if reset_mask is not None:
            smoothed = torch.where(reset_mask[:, None, None], 0.0, smoothed)

        new_carry = {"fb": fb_carry}
        if not self.use_sliding:
            frames = fb.extract(info).reshape(s, tc, fb.cols_cap, cfg.fft_size)
            mean = frames.mean(dim=-1, keepdim=True)
            spec = torch.fft.rfft((frames - mean) * window, n=cfg.fft_size)
            power = (spec.real**2 + spec.imag**2) * norm
            smoothed = self._smooth_cols(smoothed, power, valid)
            raw_db, weighted_db = self._to_db(smoothed)
        elif self._held and not (
            info["ready"] > 0
            or (any_reset if any_reset is not None else reset_mask is not None and bool(reset_mask.any()))
        ):
            # no column and no reset: the whole spectrum state is held
            new_carry["sdft"] = carry["sdft"]
            smoothed = carry["smoothed"]
            raw_db, weighted_db = carry["raw_db"], carry["weighted_db"]
        else:
            new_carry["sdft"], power = self._sliding.step_fused(
                carry["sdft"], info, norm, cfg.floor_db, emit_codes=False
            )
            power = power.reshape(s, tc, fb.cols_cap, self.bins)
            smoothed = self._smooth_cols(smoothed, power, valid)
            raw_db, weighted_db = self._to_db(smoothed)
        if self._held:
            new_carry["raw_db"], new_carry["weighted_db"] = raw_db, weighted_db

        new_carry["smoothed"] = smoothed
        return new_carry, SpectrumSnapshot(
            weighted_db=weighted_db, raw_db=raw_db, updated=valid.any(dim=2).any(dim=1),
        )
