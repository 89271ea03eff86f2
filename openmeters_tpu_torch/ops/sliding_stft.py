"""Sliding-DFT STFT for high-overlap hops (port of ``ops/sliding_stft.py``).

For hop << fft the unwindowed DFT advances by one hop with a ``[hop, bins]``
delta product and a phasor rotation,

    F_{t+1}[k] = e^{+i 2 pi k h / N} (F_t[k] + sum_j (x_new[j] - x_old[j])
                                       e^{-i 2 pi k j / N}),

and the window is applied in the frequency domain (see ``ops/sliding_hop``).
An exact ``torch.fft.rfft`` re-anchor every ``refresh_steps`` hops bounds
f32 drift.  The hop counter ``count`` and the ``anchored`` flag are shared
by all streams and kept as host values.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from openmeters_tpu_torch.ops.framing import FrameBuffer
from openmeters_tpu_torch.ops.sliding_hop import sliding_hop
from openmeters_tpu_torch.utils.windows import WindowKind


@dataclasses.dataclass(frozen=True)
class SlidingSTFT:
    fft_size: int
    hop: int
    block: int
    window: WindowKind
    refresh_steps: int = 32

    @property
    def bins(self) -> int:
        return self.fft_size // 2 + 1

    @property
    def supported(self) -> bool:
        n = self.fft_size
        return n >= 64 and (n & (n - 1)) == 0 and self.hop * 2 <= n

    @property
    def frames(self) -> FrameBuffer:
        return FrameBuffer(self.fft_size, self.hop, self.block)

    def init(self, lanes: int, device=None) -> dict:
        return {
            "re": torch.zeros((lanes, self.bins), dtype=torch.float32, device=device),
            "im": torch.zeros((lanes, self.bins), dtype=torch.float32, device=device),
            "count": 0,
            "anchored": False,
        }

    def _consts(self):
        n, h, bins = self.fft_size, self.hop, self.bins
        k = np.arange(bins)
        rot = np.exp(2j * np.pi * k * h / n)
        j = np.arange(h)
        upd = np.exp(-2j * np.pi * np.outer(j, k) / n)
        return (
            rot.real.astype(np.float32), rot.imag.astype(np.float32),
            upd.real.astype(np.float32), upd.imag.astype(np.float32),
        )

    def _stencil(self) -> np.ndarray:
        return np.asarray(self.window.cosine_coefficients, np.float64)

    def _dc_corr_vector(self) -> np.ndarray:
        n = self.fft_size
        coeffs = self._stencil()
        corr = np.zeros((self.bins,), np.float32)
        corr[0] = float(coeffs[0]) * n
        for j, a in enumerate(coeffs[1:], start=1):
            if j < self.bins:
                corr[j] = 0.5 * float(a) * n
        return corr

    @functools.lru_cache(maxsize=None)
    def _tensors(self, device: torch.device):
        """``(rot_r, rot_i, upd_r, upd_i, dc_corr)`` on ``device``."""
        arrs = (*self._consts(), self._dc_corr_vector())
        return tuple(torch.from_numpy(a).to(device) for a in arrs)

    def step_fused(self, sdft: dict, info: dict, norm: torch.Tensor, floor_db: float):
        """One hop through :func:`sliding_hop`: slide, window, power, dB and
        u16 codes.  Returns ``(new_sdft, codes [S, cols_cap, bins])``.

        The periodic exact re-anchor happens before the hop as a carry
        substitution: the hop's column-0 slide is affine
        (``F0 = rot * (f + d0 upd)``), so ``f' = conj(rot) F0_exact - d0 upd``
        makes it land on the freshly computed spectrum."""
        fb = self.frames
        n, h = self.fft_size, self.hop
        rot_r, rot_i, upd_r, upd_i, dc_corr = self._tensors(info["buf"].device)

        ready = info["ready"]
        count = sdft["count"]
        refresh = (count % self.refresh_steps == 0 or not sdft["anchored"]) and ready > 0

        deltas = torch.stack(
            [
                fb.slice(info, (k - 1) * h + n, h) - fb.slice(info, (k - 1) * h, h)
                for k in range(fb.cols_cap)
            ],
            dim=1,
        )  # [S, cols, h]

        fr, fi = sdft["re"], sdft["im"]
        if refresh:
            spec = torch.fft.rfft(fb.slice(info, 0, n), n=n)
            sr, si = spec.real, spec.imag
            tr = sr * rot_r + si * rot_i  # F0 * conj(rot)
            ti = si * rot_r - sr * rot_i
            d0 = deltas[:, 0]
            fr = (tr - d0 @ upd_r).contiguous()
            fi = (ti - d0 @ upd_i).contiguous()

        fr2, fi2, codes = sliding_hop(
            ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm,
            n=n, coeffs=tuple(float(a) for a in self._stencil()), floor_db=float(floor_db),
        )
        new_sdft = {
            "re": fr2,
            "im": fi2,
            "count": count + 1,
            "anchored": sdft["anchored"] or refresh,
        }
        return new_sdft, codes
