"""Classic spectrogram over the sliding DFT (port of the classic-sliding
branch of ``analyzers/spectrogram.py``).

Per hop, the DC-removed, windowed power of every ready column is packed to
u16 codes over the fixed [-144, +12] dB domain.  Only unpadded
power-of-two FFTs with ``hop <= fft/2`` and no reassignment are ported; any
other configuration raises ``NotImplementedError`` when the analyzer is
built.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from openmeters_tpu_torch.ops.framing import FrameBuffer
from openmeters_tpu_torch.ops.sliding_hop import pack_classic_db  # noqa: F401
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT
from openmeters_tpu_torch.utils.level import DB_FLOOR
from openmeters_tpu_torch.utils.windows import (
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

DEFAULT_FFT_SIZE = 2048
DEFAULT_HOP_SIZE = 64


class ClassicColumns(NamedTuple):
    codes: torch.Tensor  # [S, cols_cap, bins] uint16 packed dB
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


@dataclasses.dataclass(frozen=True)
class SpectrogramAnalyzer:
    config: SpectrogramConfig = SpectrogramConfig()

    def __post_init__(self):
        cfg = self.config
        if cfg.use_reassignment:
            raise NotImplementedError(
                "reassigned spectrogram is not ported yet (ROADMAP A7); "
                "use SpectrogramConfig(use_reassignment=False)"
            )
        if not self.use_sliding:
            raise NotImplementedError(
                "only the sliding-DFT classic spectrogram is ported (unpadded "
                "power-of-two fft, hop <= fft/2); the per-column classic path "
                "is ROADMAP A13"
            )

    @property
    def _frames(self) -> FrameBuffer:
        cfg = self.config
        return FrameBuffer(cfg.fft_size, cfg.hop_size, cfg.block_frames)

    @property
    def _sliding(self) -> SlidingSTFT:
        cfg = self.config
        return SlidingSTFT(cfg.fft_size, cfg.hop_size, cfg.block_frames, cfg.window)

    @property
    def use_sliding(self) -> bool:
        cfg = self.config
        return (
            not cfg.use_reassignment
            and cfg.zero_padding_factor == 1
            and self._sliding.supported
        )

    @functools.lru_cache(maxsize=None)
    def _norm(self, device: torch.device) -> torch.Tensor:
        cfg = self.config
        w = window_coefficients(cfg.window, cfg.fft_size)
        return torch.from_numpy(fft_bin_normalization(w, cfg.fft_size)).to(device)

    def init(self, n_streams: int, device=None) -> dict:
        return {
            "fb": self._frames.init(n_streams, device=device),
            "sdft": self._sliding.init(n_streams, device=device),
        }

    def step(self, carry: dict, block: torch.Tensor, reset_mask=None):
        """One hop of ``[S, B]`` mono (mid-projected) samples.
        Returns ``(carry, ClassicColumns)``."""
        fb_carry, info = self._frames.advance(carry["fb"], block, reset_mask)
        sdft, codes = self._sliding.step_fused(
            carry["sdft"], info, self._norm(block.device), DB_FLOOR
        )
        return {"fb": fb_carry, "sdft": sdft}, ClassicColumns(codes=codes, valid=info["valid"])

