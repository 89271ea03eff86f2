"""Stereometer: Lissajous point clouds and per-band stereo correlation (port
of ``analyzers/stereometer.py``).

A full-band L/R history and, with ``analyze_bands``, a three-band LR4 split
(``ops/iir.py::three_band_scan``, two biquads a filter, the high band from
the low split's high-pass).  Correlation is a Pearson-style value of EMA
moments (cross, L^2, R^2) with ``alpha = 1 - exp(-1 / (rate * window))``,
clamped to [-1, 1]; the per-sample EMA collapses into one closed-form block
update, ``m' = (1-a)^B m + a sum_i (1-a)^(B-1-i) v_i``.  Snapshots decimate
the last ``segment_duration`` seconds to ``target_sample_count`` points,
band points scaled by 0.8.  ``migrate_from`` keeps the moments and the
ring across a change of correlation window or band analysis.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from openmeters_tpu_torch.ops.iir import three_band_init, three_band_scan
from openmeters_tpu_torch.utils.level import flush_denormal
from openmeters_tpu_torch.utils.migrate import carry_device, merge_carry

BAND_DISPLAY_GAIN = 0.8
BAND_COUNT = 3
FULL_BAND = 0  # snapshot slot order: [full, low, mid, high]


def ema_alpha(sample_rate: float, window: float) -> float:
    return 1.0 - math.exp(-1.0 / max(sample_rate * window, 1.0))


class StereometerSnapshot(NamedTuple):
    points: torch.Tensor  # [S, 4, target, 2] (full + 3 bands; bands zero unless emitted)
    correlations: torch.Tensor  # [S, 4]
    points_valid: torch.Tensor  # [S] enough history for a snapshot


@dataclasses.dataclass(frozen=True)
class StereometerConfig:
    sample_rate: float = 48_000.0
    segment_duration: float = 0.02
    target_sample_count: int = 2_000
    correlation_window: float = 0.05
    analyze_bands: bool = False
    emit_band_points: bool = False
    block_frames: int = 256

    def resolved(self) -> "StereometerConfig":
        # emit_band_points implies analyze_bands
        if self.emit_band_points and not self.analyze_bands:
            return dataclasses.replace(self, analyze_bands=True)
        return self


@dataclasses.dataclass(frozen=True)
class StereometerAnalyzer:
    config: StereometerConfig = StereometerConfig()

    def __post_init__(self):
        object.__setattr__(self, "config", self.config.resolved())

    @property
    def segment_frames(self) -> int:
        return max(int(round(self.config.sample_rate * self.config.segment_duration)), 1)

    @property
    def target(self) -> int:
        return min(max(self.config.target_sample_count, 1), self.segment_frames)

    @property
    def _n_histories(self) -> int:
        return 4 if self.config.emit_band_points else 1

    def init(self, n_streams: int, device=None) -> dict:
        f = self.segment_frames
        carry = {
            "moments": torch.zeros((4, 3, n_streams), dtype=torch.float32, device=device),
            "ring": torch.zeros((n_streams, self._n_histories, f, 2), dtype=torch.float32, device=device),
            "count": torch.zeros((n_streams,), dtype=torch.int32, device=device),
        }
        if self.config.analyze_bands:
            carry["tb"] = three_band_init((n_streams, 2), 2, device=device)
        return carry

    def stream_dims(self) -> dict:
        """Each carry leaf's stream dim (the JAX package's ``pspecs``)."""
        dims = {"moments": 2, "ring": 0, "count": 0}
        if self.config.analyze_bands:
            dims["tb"] = 3  # [4, cascade, 2, S, 2]
        return dims

    def migrate_from(self, old: "StereometerAnalyzer", carry: dict, n_streams: int):
        """A change of ``correlation_window`` swaps the EMA's alpha and the
        state goes on; a band-analysis toggle starts the band splitter
        afresh and keeps the moments and the ring.  A change of rate,
        block, segment or point count starts over (``None``)."""
        a, b = old.config, self.config
        if a == b:
            return carry
        if (a.sample_rate, a.block_frames, a.segment_duration, a.target_sample_count) != (
            b.sample_rate, b.block_frames, b.segment_duration, b.target_sample_count
        ):
            return None
        if dataclasses.replace(
            a, correlation_window=b.correlation_window, analyze_bands=b.analyze_bands,
            emit_band_points=b.emit_band_points,
        ) != b:
            return None
        fresh = self.init(n_streams, device=carry_device(carry))
        out = merge_carry(fresh, carry)
        if a.analyze_bands != b.analyze_bands and "tb" in out:
            out["tb"] = fresh["tb"]
        return out

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _consts(self, b: int, device: torch.device):
        """``(decay vector [B], (1-a)^B, decimation index, point gains)``."""
        cfg = self.config
        alpha = ema_alpha(cfg.sample_rate, cfg.correlation_window)
        decay = np.power(1.0 - alpha, np.arange(b - 1, -1, -1, dtype=np.float64))
        dvec = torch.from_numpy((alpha * decay).astype(np.float32)).to(device)
        f = self.segment_frames
        idx = torch.from_numpy(np.arange(self.target) * f // self.target).to(device)
        gains = np.ones((self._n_histories,), np.float32)
        gains[1:] = BAND_DISPLAY_GAIN
        return dvec, float((1.0 - alpha) ** b), idx, torch.from_numpy(gains).to(device)

    def _corr_update(self, moments, l, r, dvec, total, reset=None):
        """Closed-form EMA block update of one band's ``moments [3, S]``
        from ``l, r [B, S]``."""
        v = torch.stack([l * r, l * l, r * r])  # [3, B, S]
        upd = torch.einsum("vbs,b->vs", v, dvec)
        new = moments * total + upd
        if reset is not None:
            new = torch.where(reset[None, :], upd, new)
        return flush_denormal(new)

    @staticmethod
    def _corr_value(moments):
        """Pearson-style value from ``moments [..., 3, S]`` (cross, L^2, R^2
        on axis -2)."""
        cross, lp, rp = moments[..., 0, :], moments[..., 1, :], moments[..., 2, :]
        denom = torch.sqrt(lp * rp)
        val = torch.where(denom > 1e-12, cross / torch.clamp_min(denom, 1e-30), 0.0)
        return torch.clamp(torch.where(torch.isfinite(val), val, 0.0), -1.0, 1.0)

    def step(self, carry: dict, block: torch.Tensor, reset_mask=None):
        """One hop of ``[S, B, 2]`` folded stereo.  Returns ``(carry,
        StereometerSnapshot)``."""
        cfg = self.config
        s, b, _ = block.shape
        f = self.segment_frames
        dvec, total, idx, gains = self._consts(b, block.device)
        x = block.to(torch.float32).permute(1, 0, 2).contiguous()  # [B, S, 2]

        moments = carry["moments"]
        count = carry["count"]
        if reset_mask is not None:
            moments = torch.where(reset_mask[None, None, :], 0.0, moments)
            count = torch.where(reset_mask, 0, count)

        new_carry = {}
        l, r = x[..., 0], x[..., 1]
        bands = None
        if cfg.analyze_bands:
            tb = carry["tb"]
            if reset_mask is not None:
                tb = torch.where(reset_mask[None, None, None, :, None], 0.0, tb)
            bands, new_carry["tb"] = three_band_scan(
                x, tb.contiguous(), cfg.sample_rate, cascade_n=2, cascade_high=True
            )  # [B, 3, S, 2]

        upd = [self._corr_update(moments[0], l, r, dvec, total, reset_mask)]
        for band in range(BAND_COUNT):
            if cfg.analyze_bands:
                bl, br = bands[:, band, :, 0], bands[:, band, :, 1]
                upd.append(self._corr_update(moments[band + 1], bl, br, dvec, total, reset_mask))
            else:
                upd.append(moments[band + 1])
        moments = torch.stack(upd)

        # histories: right-aligned shift rings of the last `f` samples
        ring = carry["ring"]
        if reset_mask is not None:
            ring = torch.where(reset_mask[:, None, None, None], 0.0, ring)
        streams = [x]  # [B, S, 2]
        if cfg.emit_band_points:
            streams += [bands[:, band] for band in range(BAND_COUNT)]
        newest = torch.stack(streams, dim=1).permute(2, 1, 0, 3)  # [S, H, B, 2]
        if b >= f:
            ring = newest[:, :, b - f :, :].contiguous()
        else:
            ring = torch.cat([ring[:, :, b:, :], newest], dim=2)

        count = torch.clamp_max(count + b, 2**30)

        # decimated snapshot points (a fixed gather: i * frames // target)
        pts = ring[:, :, idx, :] * gains[None, :, None, None]  # [S, H, target, 2]
        if self._n_histories < 4:
            pad = torch.zeros((s, 4 - self._n_histories, self.target, 2), dtype=pts.dtype, device=pts.device)
            pts = torch.cat([pts, pad], dim=1)

        corr = self._corr_value(moments).T  # [S, 4]
        if not cfg.analyze_bands:
            corr = torch.cat([corr[:, :1], torch.zeros_like(corr[:, 1:])], dim=1)

        new_carry.update({"moments": moments, "ring": ring, "count": count})
        return new_carry, StereometerSnapshot(points=pts, correlations=corr, points_valid=count >= f)
