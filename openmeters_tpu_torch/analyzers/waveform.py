"""Waveform: min/max columns and three-band colour / RMS history (port of
``analyzers/waveform.py``).

Four derived lanes (L, R, Mid, Side) reduce to min/max columns at the
fractional cadence ``scroll_speed / sample_rate``, with the last sample of
a column carried into the next for visual continuity; non-finite samples
are left out of min/max and break that continuity.  With
``analyze_bands`` (the default) a one-biquad three-band crossover
(``ops/iir.py::three_band_scan``) runs on L and R, Mid and Side derive as
(L +- R) / 2, and each column gets trailing-window band means (colour,
gains [1.0, 0.7, 2.0]) and, with ``track_history``, fast/slow RMS in dB.

- The column phase is exact integer arithmetic: the cadence is the
  rational ``p / q``, ``p = round(scroll * 256)``, ``q = round(rate *
  256)``, carried as one int32 residue per stream.  Per-hop emissions are
  bounded by a fixed capacity, so columns are ``[S, cap, ...]`` masked
  reductions.
- Band means come from a block-granular circular ring: per hop the raw
  band samples and per-block sums; a window ending at an in-block position
  is the new block's prefix plus whole-block totals plus a suffix of the
  two oldest blocks it touches.  The ring's write slot ``ring_head`` is a
  host int; slots older than a stream's sample counter are masked, so a
  reset zeroes nothing.

The one-hot reductions are products, as in the JAX package, so a
non-finite sample spreads through them the same way.  ``migrate_from``
keeps the column state across a change of scroll speed or band options.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from openmeters_tpu_torch.ops.iir import three_band_init, three_band_scan
from openmeters_tpu_torch.utils.level import DB_FLOOR, power_to_db
from openmeters_tpu_torch.utils.migrate import carry_device, merge_carry

NUM_BANDS = 3
DERIVED_CHANNELS = 4  # L, R, Mid, Side
REFERENCE_SAMPLE_RATE = 44_100.0
BAND_COLOR_WINDOW_AT_44K1 = 2048
BAND_SLOW_WINDOW_AT_44K1 = 16_384
BAND_COLOR_GAINS = np.array([1.0, 0.7, 2.0], np.float32)
MAX_TRACKER_SAMPLE_RATE = 1_000_000.0
PHASE_SCALE = 256  # rational cadence denominator scale

# [2, 4] projection: stereo -> (L, R, M, S)
DERIVED_PROJ = np.array([[1.0, 0.0, 0.5, 0.5], [0.0, 1.0, 0.5, -0.5]], np.float32)
_BIG = 3.4e38


def window_len(samples_at_reference_rate: int, sample_rate: float) -> int:
    rate = min(sample_rate, MAX_TRACKER_SAMPLE_RATE)
    return max(int(round(samples_at_reference_rate * rate / REFERENCE_SAMPLE_RATE)), 1)


class WaveformSnapshot(NamedTuple):
    """Emitted columns and the pending column's preview."""

    col_min: torch.Tensor  # [S, cap, 4]
    col_max: torch.Tensor  # [S, cap, 4]
    col_color: torch.Tensor  # [S, cap, 4, 3]
    col_rms_db: torch.Tensor  # [S, cap, 2, 4, 3] (fast/slow, channel, band)
    col_valid: torch.Tensor  # [S, cap]
    preview_min: torch.Tensor  # [S, 4]
    preview_max: torch.Tensor  # [S, 4]
    preview_color: torch.Tensor  # [S, 4, 3]
    preview_rms_db: torch.Tensor  # [S, 2, 4, 3]
    progress: torch.Tensor  # [S] pending column phase in [0, 1)


@dataclasses.dataclass(frozen=True)
class WaveformConfig:
    sample_rate: float = 48_000.0
    scroll_speed: float = 300.0  # columns per second
    analyze_bands: bool = True
    track_history: bool = False
    block_frames: int = 256

    def resolved(self) -> "WaveformConfig":
        speed = self.scroll_speed
        if not (isinstance(speed, (int, float)) and math.isfinite(speed) and speed > 0):
            speed = 300.0
        speed = max(speed, 1.0)
        return dataclasses.replace(
            self,
            scroll_speed=float(speed),
            track_history=self.track_history and self.analyze_bands,
        )


@dataclasses.dataclass(frozen=True)
class WaveformAnalyzer:
    config: WaveformConfig = WaveformConfig()

    def __post_init__(self):
        object.__setattr__(self, "config", self.config.resolved())

    @property
    def _pq(self) -> tuple[int, int]:
        cfg = self.config
        q = max(int(round(cfg.sample_rate * PHASE_SCALE)), 1)
        p = max(int(round(cfg.scroll_speed * PHASE_SCALE)), 1)
        return min(p, q), q  # at most one column a sample

    @property
    def cols_cap(self) -> int:
        p, q = self._pq
        return (self.config.block_frames * p + q - 1) // q + 2

    @property
    def color_window(self) -> int:
        return window_len(BAND_COLOR_WINDOW_AT_44K1, self.config.sample_rate)

    @property
    def slow_window(self) -> int:
        return window_len(BAND_SLOW_WINDOW_AT_44K1, self.config.sample_rate)

    def _block_age(self, window: int) -> int:
        """Oldest whole-block age below the suffix pair for ``window``."""
        b = self.config.block_frames
        return max((window - b - 1) // b, 0)

    @property
    def ring_blocks(self) -> int:
        """Ring capacity: a window read touches block ages up to
        ``_block_age(w) + 1``."""
        w = self.slow_window if self.config.track_history else self.color_window
        return self._block_age(w) + 2

    def init(self, n_streams: int, device=None) -> dict:
        s, b = n_streams, self.config.block_frames
        d = DERIVED_CHANNELS

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        carry = {
            "phase_r": zeros(s, dtype=torch.int32),
            "cur_min": zeros(s, d),
            "cur_max": zeros(s, d),
            "cur_has": zeros(s, d, dtype=torch.bool),
            "last_val": zeros(s, d),
            "last_ok": zeros(s, d, dtype=torch.bool),
        }
        if self.config.analyze_bands:
            k, lanes = self.ring_blocks, DERIVED_CHANNELS * NUM_BANDS
            carry["tb"] = three_band_init((s, 2), 1, device=device)
            carry["count"] = zeros(s, dtype=torch.int32)
            carry["ring_head"] = 0
            carry["raw_ring"] = zeros(s, k, b, lanes)
            carry["color_tot"] = zeros(s, k, lanes)
            if self.config.track_history:
                carry["power_tot"] = zeros(s, k, lanes)
        return carry

    def stream_dims(self) -> dict:
        """Each carry leaf's stream dim, ``None`` for the ring head every
        shard holds alike (the JAX package's ``pspecs``)."""
        dims = dict.fromkeys(("phase_r", "cur_min", "cur_max", "cur_has", "last_val", "last_ok"), 0)
        if self.config.analyze_bands:
            dims.update(tb=3, count=0, ring_head=None, raw_ring=0, color_tot=0)  # tb: [4, 1, 2, S, 2]
            if self.config.track_history:
                dims["power_tot"] = 0
        return dims

    def migrate_from(self, old: "WaveformAnalyzer", carry: dict, n_streams: int):
        """A rate or block change starts over (``None``); a toggle of
        ``analyze_bands`` or ``track_history`` starts the band trackers
        afresh and keeps the min/max column state; a scroll-speed change
        keeps it all (the column phase goes on under the new cadence)."""
        a, b = old.config, self.config
        if a == b:
            return carry
        if (a.sample_rate, a.block_frames) != (b.sample_rate, b.block_frames):
            return None
        fresh = self.init(n_streams, device=carry_device(carry))
        out = merge_carry(fresh, carry)
        if (a.analyze_bands, a.track_history) != (b.analyze_bands, b.track_history):
            for k in ("tb", "count", "ring_head", "raw_ring", "color_tot", "power_tot"):
                if k in fresh:
                    out[k] = fresh[k]
        return out

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _consts(self, device: torch.device):
        """``(derived projection [2, 4], colour gains [12])``."""
        gains12 = np.tile(BAND_COLOR_GAINS, DERIVED_CHANNELS)
        return (torch.from_numpy(DERIVED_PROJ).to(device), torch.from_numpy(gains12).to(device))

    def step(self, carry: dict, block: torch.Tensor, reset_mask=None):
        """One hop of ``[S, B, 2]`` folded stereo.  Returns ``(carry,
        WaveformSnapshot)``.  ``carry["raw_ring"]`` and the block-total rings
        are written in place."""
        cfg = self.config
        s, b, _ = block.shape
        p, q = self._pq
        cap = self.cols_cap
        dev = block.device
        proj, gains12 = self._consts(dev)
        i32, f32 = torch.int32, torch.float32

        derived = torch.einsum("sbc,cd->sbd", block.to(f32), proj)
        fin = torch.isfinite(derived)  # [S, B, 4]

        phase_r = carry["phase_r"]
        cur_min, cur_max, cur_has = carry["cur_min"], carry["cur_max"], carry["cur_has"]
        last_val, last_ok = carry["last_val"], carry["last_ok"]
        if reset_mask is not None:
            phase_r = torch.where(reset_mask, 0, phase_r)
            cur_has = cur_has & ~reset_mask[:, None]
            last_ok = last_ok & ~reset_mask[:, None]

        # -- exact integer column cadence ----------------------------------------
        n = torch.arange(b, dtype=i32, device=dev)
        r64 = phase_r[:, None]
        col = torch.div(r64 + n[None, :] * p, q, rounding_mode="floor")  # [S, B]
        e_tot = torch.div(r64[:, 0] + b * p, q, rounding_mode="floor")  # [S] emissions
        new_phase_r = torch.remainder(r64[:, 0] + b * p, q)

        ks = torch.arange(cap, dtype=i32, device=dev)
        is_col = col[:, :, None] == ks[None, None, :]  # [S, B, cap]
        col_next = torch.cat([col[:, 1:], torch.full((s, 1), 2**30, dtype=i32, device=dev)], dim=1)
        closes = (col_next > col)[:, :, None]  # the sample is its column's last
        cont = (col[:, :, None] == (ks[None, None, :] - 1)) & closes
        memb = (is_col | cont)[:, :, :, None] & fin[:, :, None, :]  # [S, B, cap, 4]

        vals = derived[:, :, None, :]
        col_min = torch.where(memb, vals, _BIG).amin(dim=1)  # [S, cap, 4]
        col_max = torch.where(memb, vals, -_BIG).amax(dim=1)
        col_any = memb.any(dim=1)

        # merge the carried pending stats and continuity sample into column 0
        m0 = torch.minimum(torch.where(cur_has, cur_min, _BIG), torch.where(last_ok, last_val, _BIG))
        x0 = torch.maximum(torch.where(cur_has, cur_max, -_BIG), torch.where(last_ok, last_val, -_BIG))
        col_min = torch.cat([torch.minimum(col_min[:, :1], m0[:, None]), col_min[:, 1:]], dim=1)
        col_max = torch.cat([torch.maximum(col_max[:, :1], x0[:, None]), col_max[:, 1:]], dim=1)
        col_any = torch.cat([(col_any[:, 0] | cur_has | last_ok)[:, None], col_any[:, 1:]], dim=1)

        col_min = torch.where(col_any, col_min, 0.0)
        col_max = torch.where(col_any, col_max, 0.0)
        col_valid = ks[None, :] < e_tot[:, None]

        # the pending (preview) column sits at slot e_tot
        pend_slot = torch.clamp_max(e_tot, cap - 1)
        slot_oh = (ks[None, :] == pend_slot[:, None]).to(f32)
        pv_min = torch.einsum("sk,skd->sd", slot_oh, col_min)
        pv_max = torch.einsum("sk,skd->sd", slot_oh, col_max)

        # -- carries: pending min/max and the continuity sample -----------------
        in_pend = (col == e_tot[:, None])[:, :, None] & fin  # [S, B, 4]
        pend_min = torch.where(in_pend, derived, _BIG).amin(dim=1)
        pend_max = torch.where(in_pend, derived, -_BIG).amax(dim=1)
        pend_has = in_pend.any(dim=1)
        emitted = (e_tot > 0)[:, None]
        new_cur_has = torch.where(emitted, pend_has, cur_has | pend_has)
        new_cur_min = torch.where(
            emitted, pend_min, torch.minimum(torch.where(cur_has, cur_min, _BIG), pend_min)
        )
        new_cur_max = torch.where(
            emitted, pend_max, torch.maximum(torch.where(cur_has, cur_max, -_BIG), pend_max)
        )
        new_cur_min = torch.where(new_cur_has, new_cur_min, 0.0)
        new_cur_max = torch.where(new_cur_has, new_cur_max, 0.0)

        # continuity value: the last sample of the last emitted column, if
        # finite and no non-finite sample came after it
        bnd = torch.div(e_tot * q - r64[:, 0] + p - 1, p, rounding_mode="floor") - 1
        bnd = torch.clamp(bnd, 0, b - 1)  # [S]
        bnd_oh = (n[None, :] == bnd[:, None]).to(f32)
        bval = torch.einsum("sb,sbd->sd", bnd_oh, derived)  # [S, 4]
        bfin = torch.einsum("sb,sbd->sd", bnd_oh, fin.to(f32)) > 0.5
        after = n[None, :] > bnd[:, None]  # [S, B]
        bad_after = (after[:, :, None] & ~fin).any(dim=1)
        bad_any = (~fin).any(dim=1)
        new_last_val = torch.where(emitted, bval, last_val)
        new_last_ok = torch.where(emitted, bfin & ~bad_after, last_ok & ~bad_any)

        new_carry = {
            "phase_r": new_phase_r,
            "cur_min": new_cur_min,
            "cur_max": new_cur_max,
            "cur_has": new_cur_has,
            "last_val": new_last_val,
            "last_ok": new_last_ok,
        }

        # -- band analysis -------------------------------------------------------
        d, nb = DERIVED_CHANNELS, NUM_BANDS
        col_color = torch.zeros((s, cap, d, nb), dtype=f32, device=dev)
        col_rms = torch.full((s, cap, 2, d, nb), DB_FLOOR, dtype=f32, device=dev)
        pv_color = torch.zeros((s, d, nb), dtype=f32, device=dev)
        pv_rms = torch.full((s, 2, d, nb), DB_FLOOR, dtype=f32, device=dev)

        if cfg.analyze_bands:
            if b != cfg.block_frames:
                raise ValueError(f"block of {b} frames, want {cfg.block_frames}: the band ring needs fixed blocks")
            lanes = d * nb
            k = self.ring_blocks
            tb, count = carry["tb"], carry["count"]
            if reset_mask is not None:
                tb = torch.where(reset_mask[None, None, None, :, None], 0.0, tb)
                count = torch.where(reset_mask, 0, count)

            lr = block.to(f32).permute(1, 0, 2)  # [B, S, 2]
            lr = torch.where(fin[..., :2].permute(1, 0, 2), lr, 0.0).contiguous()
            fbands, new_carry["tb"] = three_band_scan(
                lr, tb.contiguous(), cfg.sample_rate, cascade_n=1, cascade_high=False
            )  # [B, 3, S, 2]
            fl, fr = fbands[..., 0], fbands[..., 1]
            dbands = torch.stack([fl, fr, (fl + fr) * 0.5, (fl - fr) * 0.5], dim=-1)
            dbands = dbands.permute(2, 0, 3, 1)  # [S, B, 4, 3]
            dbands = torch.where(fin[:, :, :, None], dbands, 0.0)
            dbands = torch.where(torch.isfinite(dbands), dbands, 0.0)
            flat = dbands.reshape(s, b, lanes)  # [S, B, 12]

            head = carry["ring_head"]
            raw = carry["raw_ring"]
            blocks_cnt = torch.div(count, b, rounding_mode="floor")  # whole blocks since reset
            ages = torch.remainder(head - 1 - torch.arange(k, dtype=i32, device=dev), k)  # [K]

            # positions: the last sample of column k is ceil(((k+1) q - r) / p) - 1;
            # the final slot doubles as the preview position (block end)
            kq = (ks[None, :] + 1) * q
            pos = torch.div(kq - r64 + p - 1, p, rounding_mode="floor") - 1
            pos = torch.clamp(pos, 0, b - 1)  # [S, cap]
            pos_all = torch.cat([pos, torch.full((s, 1), b - 1, dtype=i32, device=dev)], dim=1)

            def read_pair(a0: int):
                """``[S, 2B, lanes]`` raw samples of block ages a0+1 (older
                half) and a0, zeroed where the block predates the stream's
                reset."""
                pair = torch.cat([raw[:, (head - 2 - a0) % k], raw[:, (head - 1 - a0) % k]], dim=1)
                valid = torch.cat(
                    [
                        (blocks_cnt > a0 + 1)[:, None].expand(s, b),
                        (blocks_cnt > a0)[:, None].expand(s, b),
                    ],
                    dim=1,
                )
                return torch.where(valid[:, :, None], pair, 0.0)

            def base_total(tot_ring, a0: int):
                """Sum of the whole-block totals at ages 0..a0-1 since the reset."""
                mask = (ages[None, :] < a0) & (ages[None, :] < blocks_cnt[:, None])
                return torch.where(mask[:, :, None], tot_ring, 0.0).sum(dim=1)

            def window_means(new_vals, pair_vals, base_tot, window: int):
                """Trailing means over ``window`` samples ending at
                ``pos_all`` (inclusive): the new block's prefix, whole-block
                totals and a suffix of the two oldest blocks, the prefix and
                suffix as masked products."""
                a0 = self._block_age(window)
                m = window - 1 - pos_all  # [S, cap+1] history samples needed
                idx = torch.clamp(m - a0 * b, 0, 2 * b)
                bidx = torch.arange(b, dtype=i32, device=dev)
                new_mask = (bidx[None, None, :] <= pos_all[:, :, None]).to(f32)
                newsum = torch.einsum("spb,sbl->spl", new_mask, new_vals)
                pidx = torch.arange(2 * b, dtype=i32, device=dev)
                pair_mask = (pidx[None, None, :] >= (2 * b - idx)[:, :, None]).to(f32)
                hist = torch.einsum("spb,sbl->spl", pair_mask, pair_vals)
                total = newsum + hist + base_tot[:, None, :]  # [S, cap+1, lanes]
                n_at = torch.clamp_max((count[:, None] + pos_all + 1).to(f32), float(window))
                return (total / n_at[..., None]).reshape(s, -1, d, nb)

            a0_color = self._block_age(self.color_window)
            pair_color_raw = read_pair(a0_color)
            color_tot = carry["color_tot"]
            cm = window_means(
                flat.abs() * gains12,
                pair_color_raw.abs() * gains12,
                base_total(color_tot, a0_color),
                self.color_window,
            )
            col_color = torch.clamp_min(cm[:, :cap], 0.0)
            pv_color = torch.clamp_min(cm[:, cap], 0.0)

            if cfg.track_history:
                power_tot = carry["power_tot"]
                powers = flat * flat
                fast = window_means(
                    powers, pair_color_raw * pair_color_raw,
                    base_total(power_tot, a0_color), self.color_window,
                )
                a0_slow = self._block_age(self.slow_window)
                pair_slow_raw = read_pair(a0_slow)
                slow = window_means(
                    powers, pair_slow_raw * pair_slow_raw,
                    base_total(power_tot, a0_slow), self.slow_window,
                )
                rms = torch.stack(
                    [
                        power_to_db(torch.clamp_min(fast, 0.0), DB_FLOOR),
                        power_to_db(torch.clamp_min(slow, 0.0), DB_FLOOR),
                    ],
                    dim=2,
                )  # [S, cap+1, 2, 4, 3]
                col_rms = rms[:, :cap]
                pv_rms = rms[:, cap]

            # every read of the rings is done: write this block's slot
            slot = head % k
            raw[:, slot] = flat
            color_tot[:, slot] = (flat.abs() * gains12).sum(dim=1)
            new_carry.update(raw_ring=raw, color_tot=color_tot, ring_head=(head + 1) % k,
                             count=torch.clamp_max(count + b, 2**30))
            if cfg.track_history:
                carry["power_tot"][:, slot] = powers.sum(dim=1)
                new_carry["power_tot"] = carry["power_tot"]

        progress = new_phase_r.to(f32) / float(q)
        return new_carry, WaveformSnapshot(
            col_min=col_min,
            col_max=col_max,
            col_color=col_color,
            col_rms_db=col_rms,
            col_valid=col_valid,
            preview_min=pv_min,
            preview_max=pv_max,
            preview_color=pv_color,
            preview_rms_db=pv_rms,
            progress=progress,
        )
