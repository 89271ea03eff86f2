"""BS.1770-5 loudness suite, batched over streams (port of
``analyzers/loudness.py``).

K-weighted short-term (3 s) and momentary (0.4 s) LUFS with surround
channel weights, per-channel RMS fast (0.3 s) / slow (1 s), 4x/2x
oversampled true peak, and gated integrated loudness with LRA.  The
K-weighting runs as the lifted block state-space form with ``lift = B``:
one hop is four small matrix products (``ops/iir.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from openmeters_tpu_torch.ops.gating import GatedLoudness
from openmeters_tpu_torch.ops.iir import flush_denormal_state, lifted_iir_scan
from openmeters_tpu_torch.ops.truepeak import TruePeakKernel
from openmeters_tpu_torch.ops.windowed import BlockWindowedMeans
from openmeters_tpu_torch.utils.channels import MAX_AUDIO_CHANNELS
from openmeters_tpu_torch.utils.level import power_to_db
from openmeters_tpu_torch.utils.weighting import k_weighting_sos

LOUDNESS_OFFSET = -0.691
DEFAULT_FLOOR_DB = -99.9
# short-term, momentary, RMS-fast, RMS-slow
DEFAULT_WINDOWS_SECONDS = (3.0, 0.4, 0.3, 1.0)


def window_length(sample_rate: float, seconds: float) -> int:
    n = sample_rate * seconds
    return 1 if n < 1.0 else int(n)


class LoudnessSnapshot(NamedTuple):
    short_term_lufs: torch.Tensor  # [S]
    momentary_lufs: torch.Tensor  # [S]
    rms_fast_db: torch.Tensor  # [S, C]
    rms_slow_db: torch.Tensor  # [S, C]
    true_peak_db: torch.Tensor  # [S, C]
    integrated_lufs: torch.Tensor  # [S] gated (-70 abs, -10 rel)
    lra_lu: torch.Tensor  # [S] EBU Tech 3342 loudness range


@dataclasses.dataclass(frozen=True)
class LoudnessConfig:
    sample_rate: float = 48_000.0
    floor_db: float = DEFAULT_FLOOR_DB
    block_frames: int = 256
    channels: int = MAX_AUDIO_CHANNELS
    gating: bool = True  # integrated loudness + LRA state


@dataclasses.dataclass(frozen=True)
class LoudnessAnalyzer:
    config: LoudnessConfig = LoudnessConfig()

    @property
    def _windows(self) -> BlockWindowedMeans:
        cfg = self.config
        lengths = tuple(window_length(cfg.sample_rate, s) for s in DEFAULT_WINDOWS_SECONDS)
        return BlockWindowedMeans(cfg.block_frames, lengths)

    @property
    def _kw_coeffs(self):
        sos = k_weighting_sos(self.config.sample_rate)
        return tuple(
            (float(s[0]), float(s[1]), float(s[2]), float(s[4]), float(s[5])) for s in sos
        )

    @property
    def _truepeak(self) -> TruePeakKernel:
        return TruePeakKernel(self.config.sample_rate)

    @property
    def _gate(self) -> GatedLoudness:
        cfg = self.config
        return GatedLoudness(
            sample_rate=cfg.sample_rate,
            block_frames=cfg.block_frames,
            floor_db=cfg.floor_db,
        )

    def init(self, n_streams: int, device=None) -> dict:
        c = self.config.channels
        out = {
            "kw": torch.zeros((4, n_streams, c), dtype=torch.float32, device=device),
            "wm": self._windows.init((n_streams, c), device=device),
            "tp": self._truepeak.init((n_streams, c), device=device),
        }
        if self.config.gating:
            out["gate"] = self._gate.init(n_streams, device=device)
        return out

    def step(self, carry: dict, block, channel_weights, reset_mask=None):
        """One hop of ``block [S, B, C]`` raw channel samples with
        ``channel_weights [S, C]``; ``reset_mask [S]`` restarts streams.

        Returns ``(carry, LoudnessSnapshot)``."""
        cfg = self.config
        s, b, c = block.shape
        if (b, c) != (cfg.block_frames, cfg.channels):
            raise ValueError(f"block [S, {b}, {c}], want [S, {cfg.block_frames}, {cfg.channels}]")
        floor = cfg.floor_db

        lane_reset = None
        if reset_mask is not None:
            lane_reset = reset_mask[:, None].expand(s, c)

        x = block.permute(1, 0, 2).to(torch.float32)  # [B, S, C]
        kw_state = carry["kw"]
        if lane_reset is not None:
            kw_state = torch.where(lane_reset, 0.0, kw_state)
        filtered, kw_state = lifted_iir_scan(x, kw_state, self._kw_coeffs, lift=b)
        kw_state = flush_denormal_state(kw_state)

        wm = self._windows
        k2 = filtered * filtered
        wm_carry = wm.push_block(carry["wm"], k2, lane_reset)
        means = wm.means(wm_carry)  # [4, S, C] mean squares

        tp_carry, peak = self._truepeak.process_block(carry["tp"], x, lane_reset)

        lufs_in = torch.sum(means[:2] * channel_weights[None], dim=-1)  # [2, S]
        lufs = torch.where(
            lufs_in > 0.0,
            torch.clamp_min(
                LOUDNESS_OFFSET
                + 10.0 * torch.log(torch.clamp_min(lufs_in, 1e-45)) / math.log(10.0),
                floor,
            ),
            floor,
        )

        new_carry = {"kw": kw_state, "wm": wm_carry, "tp": tp_carry}
        if cfg.gating:
            wk2 = torch.einsum("bsc,sc->sb", k2, channel_weights.to(torch.float32))
            gate_carry = self._gate.push_block(carry["gate"], wk2, reset_mask)
            new_carry["gate"] = gate_carry
            integrated = gate_carry["integrated"]
            lra = gate_carry["lra"]
        else:
            integrated = torch.full((s,), floor, dtype=torch.float32, device=block.device)
            lra = torch.zeros((s,), dtype=torch.float32, device=block.device)

        snapshot = LoudnessSnapshot(
            short_term_lufs=lufs[0],
            momentary_lufs=lufs[1],
            rms_fast_db=power_to_db(means[2], floor),
            rms_slow_db=power_to_db(means[3], floor),
            true_peak_db=power_to_db(peak * peak, floor),
            integrated_lufs=integrated,
            lra_lu=lra,
        )
        return new_carry, snapshot
