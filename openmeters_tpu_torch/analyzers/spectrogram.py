"""Spectrogram: classic STFT and Auger-Flandrin time-frequency reassignment
(port of ``analyzers/spectrogram.py``).

- **Classic**: DC-removed, windowed, zero-padded rFFT per column; per-bin
  power packed to u16 codes over the fixed [-144, +12] dB domain.  Each
  column comes from its own frame, as upstream computes it: unpadded
  power-of-two FFTs up to 32768 points through ``ops/classic_columns.py``
  (on a card its kernel reads the frames from the framing ring), every
  other config through ``torch.fft.rfft``.  The sliding DFT is not used
  here: its f32 state carries a loud section's rounding into the quiet
  columns after it (the JAX package slides, and parts from float64 there).
- **Reassigned** (the default): per column the analytic signal over
  ``hilbert_len = next_pow2(2 * window)`` samples, the spectra windowed by
  h, dh/dt and (t - c) h, and per bin the frequency correction
  ``-Im(D conj B) / |B|^2`` and the time correction ``Re(T conj B) / |B|^2``
  in hops minus the Hilbert latency.  High-overlap configs (the stock
  2048/64) slide it (``ops/sliding_reassigned.py``); the others run the
  per-column transform (``ops/reassigned_columns.py``).

Columns come in fixed-capacity batches from
:class:`~openmeters_tpu_torch.ops.framing.FrameBuffer`: full ``[bins]``
arrays plus a ``point_valid`` mask in place of culled point lists.  Which
path, and whether the per-column transform takes its kernel, follows from
the config alone; a CUDA tensor then runs the kernel, a CPU tensor its
plain version.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from openmeters_tpu_torch.ops import classic_columns as ccols
from openmeters_tpu_torch.ops import reassigned_columns as rcols
from openmeters_tpu_torch.ops.framing import FrameBuffer
from openmeters_tpu_torch.ops.sliding_hop import CLASSIC_DB_STORE_LO, CLASSIC_DB_STORE_RANGE
from openmeters_tpu_torch.ops.sliding_reassigned import SlidingReassigned
from openmeters_tpu_torch.utils.level import DB_FLOOR, sanitize_sample_rate
from openmeters_tpu_torch.utils.windows import (
    WindowKind,
    derivative_window,
    fft_bin_normalization,
    hilbert_len_for,
    reassigned_power_scale,
    time_weighted_window,
    window_coefficients,
)

DEFAULT_FFT_SIZE = 2048
DEFAULT_HOP_SIZE = 64
ANALYSIS_FLOOR_POWER = 1e-14  # reassigned points below this are culled
MAX_HISTORY_COLUMNS = 8192
HISTORY_BYTE_BUDGET = 128 * 1024 * 1024


def unpack_classic_db(codes) -> np.ndarray:
    """u16 codes (a numpy array) -> dB over the fixed store domain."""
    return np.asarray(codes).astype(np.float32) * (CLASSIC_DB_STORE_RANGE / 65535.0) + CLASSIC_DB_STORE_LO


def history_columns(reassigned: bool, points: int, requested: int) -> int:
    """The view history's retention budget: classic columns pack two u16
    codes per u32; reassigned points are 12-byte splats with a doubled
    budget."""
    stride = points * 12 if reassigned else ((points + 1) // 2) * 4
    budget = HISTORY_BYTE_BUDGET * (2 if reassigned else 1)
    cap = max(budget // max(stride, 1), 1)
    return min(max(requested, 1), MAX_HISTORY_COLUMNS, cap)


class ClassicColumns(NamedTuple):
    codes: torch.Tensor  # [S, cols_cap, bins] uint16 packed dB
    valid: torch.Tensor  # [S, cols_cap] bool


class ReassignedColumns(NamedTuple):
    freq_hz: torch.Tensor  # [S, cols_cap, bins]
    time_offset: torch.Tensor  # [S, cols_cap, bins] in hops
    power: torch.Tensor  # [S, cols_cap, bins] scaled power
    point_valid: torch.Tensor  # [S, cols_cap, bins] bool (culling mask)
    valid: torch.Tensor  # [S, cols_cap] bool


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    sample_rate: float = 48_000.0
    fft_size: int = DEFAULT_FFT_SIZE
    hop_size: int = DEFAULT_HOP_SIZE
    window: WindowKind = WindowKind.HANN
    use_reassignment: bool = True
    zero_padding_factor: int = 1
    block_frames: int = 256

    def normalized(self) -> "SpectrogramConfig":
        fft = self.fft_size or DEFAULT_FFT_SIZE
        hop = self.hop_size or max(min(DEFAULT_HOP_SIZE, fft), 1)
        return dataclasses.replace(
            self,
            sample_rate=sanitize_sample_rate(self.sample_rate),
            fft_size=fft,
            hop_size=hop,
            zero_padding_factor=max(self.zero_padding_factor, 1),
        )


@dataclasses.dataclass(frozen=True)
class SpectrogramAnalyzer:
    config: SpectrogramConfig = SpectrogramConfig()

    @property
    def padded_fft(self) -> int:
        return self.config.fft_size * self.config.zero_padding_factor

    @property
    def bins(self) -> int:
        return self.padded_fft // 2 + 1

    @property
    def read_len(self) -> int:
        cfg = self.config
        return hilbert_len_for(cfg.fft_size) if cfg.use_reassignment else cfg.fft_size

    @property
    def _frames(self) -> FrameBuffer:
        cfg = self.config
        return FrameBuffer(self.read_len, cfg.hop_size, cfg.block_frames)

    @property
    def cols_cap(self) -> int:
        return self._frames.cols_cap

    @property
    def power_scale(self) -> float:
        """Reassigned splat power correction."""
        w = window_coefficients(self.config.window, self.config.fft_size)
        return reassigned_power_scale(w, self.padded_fft)

    @property
    def use_classic_kernel(self) -> bool:
        """Classic configs whose columns take ``ops/classic_columns.py``
        (unpadded power-of-two FFTs from 64 to 32768 points); the others
        run ``torch.fft`` on every device."""
        cfg = self.config
        return (
            not cfg.use_reassignment
            and cfg.zero_padding_factor == 1
            and ccols.kernel_supports(cfg.fft_size)
        )

    @property
    def _sliding_reassigned(self) -> SlidingReassigned:
        cfg = self.config
        return SlidingReassigned(
            cfg.fft_size, cfg.hop_size, cfg.block_frames, cfg.window,
            cfg.sample_rate, zpf=cfg.zero_padding_factor,
        )

    @property
    def use_sliding_reassigned(self) -> bool:
        """Streaming-analytic reassigned path: high-overlap configs, the
        stock 2048/64 among them."""
        cfg = self.config
        return (
            cfg.use_reassignment
            and cfg.hop_size <= cfg.block_frames
            and self._sliding_reassigned.supported
        )

    @property
    def use_reassigned_kernel(self) -> bool:
        """Per-column reassigned configs whose transform takes the
        ``reassigned_columns`` kernel (unpadded power-of-two windows up to
        8192); the others run ``torch.fft`` on every device."""
        cfg = self.config
        return (
            cfg.use_reassignment
            and not self.use_sliding_reassigned
            and self.padded_fft == cfg.fft_size
            and rcols.kernel_supports(
                cfg.fft_size, self.read_len, len(cfg.window.cosine_coefficients)
            )
        )

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _norm(self, device: torch.device) -> torch.Tensor:
        cfg = self.config
        w = window_coefficients(cfg.window, cfg.fft_size)
        return torch.from_numpy(fft_bin_normalization(w, self.padded_fft)).to(device)

    def init(self, n_streams: int, device=None) -> dict:
        carry = {"fb": self._frames.init(n_streams, device=device)}
        if self.use_sliding_reassigned:
            carry["srs"] = self._sliding_reassigned.init(n_streams, device=device)
        return carry

    def step(self, carry: dict, block: torch.Tensor, reset_mask=None):
        """One hop of ``[S, B]`` mono (mid-projected) samples.  Returns
        ``(carry, ClassicColumns | ReassignedColumns)``."""
        fb_carry, info = self._frames.advance(carry["fb"], block, reset_mask)
        new_carry = {"fb": fb_carry}
        if self.use_sliding_reassigned:
            new_carry["srs"], out = self._reassigned_sliding(carry["srs"], info)
        elif self.config.use_reassignment:
            out = self._gated(info, lambda: self._reassigned(self._frames.extract(info), info["valid"]))
        elif self.use_classic_kernel:
            out = self._gated(info, lambda: ClassicColumns(codes=self._classic_columns(info), valid=info["valid"]))
        else:
            out = self._gated(info, lambda: self._classic(self._frames.extract(info), info["valid"]))
        return new_carry, out

    def _gated(self, info, compute):
        """Run the column pipeline only on hops where a window is ready
        (hop > block configs emit columns every ``ceil(hop/block)``
        steps); on the others every column is empty.  ``ready`` is a host
        int, so this is a host branch."""
        if self.config.hop_size <= self.config.block_frames or info["ready"] > 0:
            return compute()
        valid = info["valid"]
        lanes, dev = valid.shape[0], valid.device
        shape = (lanes, self.cols_cap, self.bins)
        if self.config.use_reassignment:
            zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
            return ReassignedColumns(
                freq_hz=zeros, time_offset=zeros.clone(), power=zeros.clone(),
                point_valid=torch.zeros(shape, dtype=torch.bool, device=dev),
                valid=torch.zeros_like(valid),
            )
        return ClassicColumns(
            codes=torch.zeros(shape, dtype=torch.uint16, device=dev),
            valid=torch.zeros_like(valid),
        )

    # -- classic, per column --------------------------------------------------

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _window(self, device: torch.device) -> torch.Tensor:
        cfg = self.config
        return torch.from_numpy(window_coefficients(cfg.window, cfg.fft_size)).to(device)

    def _classic_columns(self, info) -> torch.Tensor:
        dev = info["buf"].device
        return ccols.classic_columns(self._frames, info, self._window(dev), self._norm(dev), floor_db=DB_FLOOR)

    def _classic(self, frames, valid) -> ClassicColumns:
        dev = frames.device
        codes = ccols.classic_columns_reference(frames, self._window(dev), self._norm(dev), floor_db=DB_FLOOR,
                                                n=self.padded_fft)
        return ClassicColumns(codes=codes, valid=valid)

    # -- reassigned ----------------------------------------------------------

    def _columns(self, freq_hz, time_offset, power, valid) -> ReassignedColumns:
        max_hz = self.config.sample_rate * 0.5
        point_valid = (
            (power >= ANALYSIS_FLOOR_POWER)
            & (freq_hz > 0.0)
            & (max_hz - freq_hz > 0.0)
            & valid[..., None]
        )
        return ReassignedColumns(
            freq_hz=freq_hz, time_offset=time_offset, power=power,
            point_valid=point_valid, valid=valid,
        )

    def _reassigned_sliding(self, srs_carry, info):
        new_carry, (freq, time, power, valid) = self._sliding_reassigned.step(srs_carry, info)
        return new_carry, self._columns(freq, time, power, valid)

    def _reassigned(self, frames, valid) -> ReassignedColumns:
        cfg = self.config
        n, h, pfft, bins = cfg.fft_size, self.read_len, self.padded_fft, self.bins
        s, cap, _ = frames.shape
        kw = dict(
            n=n, h=h, coeffs=cfg.window.cosine_coefficients,
            sample_rate=cfg.sample_rate, hop=cfg.hop_size,
        )
        if pfft == n:
            # the column transform: the kernel where the config takes it,
            # else the same chain in torch.fft
            fn = (
                rcols.reassigned_columns
                if self.use_reassigned_kernel
                else rcols.reassigned_columns_reference
            )
            out = fn(frames.reshape(s * cap, h), **kw)
            return self._columns(*(x.reshape(s, cap, bins) for x in out), valid)

        # zero-padded transforms: the stencil identity needs the window
        # periodic in the transform length, so pad and FFT the three
        # windowed analytic frames
        center = (h - n) // 2
        spec = torch.fft.rfft(frames, n=h)
        spec[..., 0] = 0.0  # keep bins 1..h/2 without doubling
        full = torch.zeros((s, cap, h), dtype=spec.dtype, device=frames.device)
        full[..., : h // 2 + 1] = spec
        a = torch.fft.ifft(full)[..., center : center + n]
        w = window_coefficients(cfg.window, n)
        wins = np.stack([w, derivative_window(w), time_weighted_window(w)])
        wins = torch.from_numpy(wins).to(frames.device)[:, None, None, :]
        f = torch.fft.fft(a[None] * wins, n=pfft)[..., :bins]
        br, bi = f[0].real, f[0].imag
        dr, di = f[1].real, f[1].imag
        tr, ti = f[2].real, f[2].imag

        pow_raw = br * br + bi * bi
        inv_pow = 1.0 / torch.clamp_min(pow_raw, 1e-38)
        inv_hop = 1.0 / cfg.hop_size
        d_omega = -(di * br - dr * bi) * inv_pow
        freq_base = torch.arange(bins, dtype=torch.float32, device=frames.device) * (
            cfg.sample_rate / pfft
        )
        freq_hz = freq_base + d_omega * (cfg.sample_rate / (2.0 * np.pi))
        time_offset = (tr * br + ti * bi) * inv_pow * inv_hop - center * inv_hop
        return self._columns(freq_hz, time_offset, pow_raw * self._norm(frames.device), valid)
