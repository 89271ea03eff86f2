"""Sliding-DFT STFT for high-overlap hops (port of ``ops/sliding_stft.py``).

For hop << fft the unwindowed DFT advances by one hop with a ``[hop, bins]``
delta product and a phasor rotation,

    F_{t+1}[k] = e^{+i 2 pi k h / N} (F_t[k] + sum_j (x_new[j] - x_old[j])
                                       e^{-i 2 pi k j / N}),

and the window is applied in the frequency domain (see ``ops/sliding_hop``).
Configs whose ``[hop, bins]`` update matrices are small take the hop that
computes the delta products itself (B1a); the others take the hop that
computes each column's delta spectrum as a pruned FFT of its samples
(B1b), by :func:`fits_whole_row`.  An exact ``torch.fft.rfft`` re-anchor
every ``refresh_steps`` hops bounds f32 drift.  The hop counter ``count``
and the ``anchored`` flag are shared by all streams and kept as host
values.  The spectrum analyzer's; the classic spectrogram computes each
column from its own frame (``ops/classic_columns.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from openmeters_tpu_torch.ops.framing import FrameBuffer
from openmeters_tpu_torch.ops.sliding_hop import hop_tiles, sliding_hop, sliding_hop_spectra
from openmeters_tpu_torch.utils.windows import WindowKind


def fits_whole_row(hop: int, bins: int) -> bool:
    """Whether a config takes the hop over update matrices (B1a): its
    ``[hop, bins]`` update matrices, re and im in f32, fit 6 MiB.  Larger
    configs take B1b, which transforms the deltas by FFT.  The bound is the
    JAX package's VMEM budget (``ops/pallas_sliding.py::fits_vmem``), kept
    so that each config takes the same formulation, B1a or B1b, that the
    JAX package's kernels take for it."""
    return 2 * 4 * hop * bins <= 6 * 2**20


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
    def whole_row(self) -> bool:
        return fits_whole_row(self.hop, self.bins)

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
    def _rows(self, device: torch.device):
        """``(rot_r, rot_i, dc_corr)`` on ``device``, as :meth:`_consts`
        computes the rotation."""
        k = np.arange(self.bins)
        rot = np.exp(2j * np.pi * k * self.hop / self.fft_size)
        arrs = (rot.real.astype(np.float32), rot.imag.astype(np.float32), self._dc_corr_vector())
        return tuple(torch.from_numpy(a).to(device) for a in arrs)

    @functools.lru_cache(maxsize=None)
    def _updates(self, device: torch.device):
        """``(upd_r, upd_i)``, the ``[hop, bins]`` update matrices, on
        ``device``."""
        return tuple(torch.from_numpy(a).to(device) for a in self._consts()[2:])

    @functools.lru_cache(maxsize=None)
    def _tiles(self, device: torch.device) -> torch.Tensor:
        """The update matrices as the B1a kernel stages them
        (:func:`~openmeters_tpu_torch.ops.sliding_hop.hop_tiles`), on
        ``device``."""
        return hop_tiles(*self._updates(device))

    def step_fused(self, sdft: dict, info: dict, norm: torch.Tensor, floor_db: float,
                   emit_codes: bool):
        """One hop: slide, window and power, emitted as float32 power or as
        dB packed to u16 codes.  Returns ``(new_sdft, out [S, cols_cap,
        bins])``.

        The periodic exact re-anchor happens before the hop as a carry
        substitution: the hop's column-0 slide is ``F0 = rot * (f + D0)``,
        ``D0`` column 0's delta spectrum, so with column 0's deltas zeroed
        ``f' = conj(rot) F0_exact`` lands it on the freshly computed
        spectrum.  Subtracting ``D0`` from ``f'`` instead would leave the
        difference between this ``D0`` and the one the hop computes (the
        kernel's own products), ~1e-7 of ``|D0|``: after a loud hop has
        left the window, far above the quiet window's spectrum."""
        fb = self.frames
        n, h = self.fft_size, self.hop
        dev = info["buf"].device
        rot_r, rot_i, dc_corr = self._rows(dev)

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
        if self.whole_row:
            upd_r, upd_i = self._updates(dev)

        fr, fi = sdft["re"], sdft["im"]
        if refresh:
            spec = torch.fft.rfft(fb.slice(info, 0, n), n=n)
            sr, si = spec.real, spec.imag
            fr = (sr * rot_r + si * rot_i).contiguous()  # F0 * conj(rot)
            fi = (si * rot_r - sr * rot_i).contiguous()
            deltas[:, 0] = 0.0

        kw = dict(n=n, coeffs=tuple(float(a) for a in self._stencil()),
                  floor_db=float(floor_db), emit_codes=emit_codes)
        if self.whole_row:
            fr2, fi2, out = sliding_hop(
                ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm, **kw,
                tiles=self._tiles(dev),
            )
        else:
            fr2, fi2, out = sliding_hop_spectra(
                ready, fr, fi, deltas, rot_r, rot_i, dc_corr, norm, **kw
            )
        new_sdft = {
            "re": fr2,
            "im": fi2,
            "count": count + 1,
            "anchored": sdft["anchored"] or refresh,
        }
        return new_sdft, out
