"""Sliding-analytic reassigned spectrogram for high-overlap hops (port of
``ops/sliding_reassigned.py``).

The reference's reassigned transform per column takes the analytic signal
over ``h = 2n`` raw samples, crops the centre ``n`` and runs three windowed
FFTs.  At hop 64 consecutive columns share 97 % of their windows, so this
module keeps streaming state instead:

1. **The analytic signal is a stream.**  Each engine hop a Toeplitz FIR
   Hilbert transform (one ``[S, block + 2K] x [block + 2K, block]``
   product) emits ``block`` new samples of ``hx`` into a ring aligned with
   the raw ring, ``margin = n/2`` samples behind it.
2. **The per-column spectra slide.**  For the window ``a = x + i*hx`` the
   unwindowed spectra ``U[k] = sum_m a[s+m] e^{-i2pi km/pfft}`` and
   ``V[k] = sum_m (m - c) a[s+m] e^{...}`` advance one hop with delta
   products and a phasor rotation; since ``x`` and ``hx`` are real, both
   split into one-sided halves (``U = Ux + i*Uhx``), eight ``[S, bins]``
   states in all.
3. **Windowing stays in the frequency domain** (cosine-sum stencils, the
   derivative window's exact stencil), then the reference's corrections.

All of 2 and 3 for one hop is :func:`~openmeters_tpu_torch.ops.
reassigned_hop.reassigned_sliding_hop` (a CUDA kernel on the card).  An
exact ``torch.fft.rfft`` re-anchor every ``refresh_steps`` hops bounds f32
drift; it enters the hop as a carry substitution.  The counters ``count``
and ``hx_avail`` and the ``anchored`` flag are shared by all streams and
kept as host values.

The ``hx`` ring is written IN PLACE: ``step`` mutates ``state["hx"]``, so a
state must not be reused after it has been stepped.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from openmeters_tpu_torch.ops.framing import FrameBuffer
from openmeters_tpu_torch.ops.reassigned_hop import hop_tiles, reassigned_sliding_hop
from openmeters_tpu_torch.utils.windows import (
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

STATE_KEYS = ("uxr", "uxi", "uhr", "uhi", "vxr", "vxi", "vhr", "vhi")


@dataclasses.dataclass(frozen=True)
class SlidingReassigned:
    fft_size: int  # n
    hop: int
    block: int
    window: WindowKind
    sample_rate: float
    # zero-padding factor: transforms at length n*zpf over window support n;
    # the window stencils land at +-(zpf*j) bins and stay exact
    zpf: int = 1
    refresh_steps: int = 32  # exact re-anchor cadence

    @property
    def n(self) -> int:
        return self.fft_size

    @property
    def pfft(self) -> int:
        return self.n * self.zpf

    @property
    def bins(self) -> int:
        return self.pfft // 2 + 1

    @property
    def h(self) -> int:
        """Hilbert segment length, the reference's ``2n``."""
        return 2 * self.n

    @property
    def center(self) -> int:
        return self.n // 2

    @property
    def margin(self) -> int:
        """Lag of the hx stream behind the raw stream (== ``center``,
        block-aligned so ring writes never wrap mid-block)."""
        return self.center

    @property
    def supported(self) -> bool:
        n, b = self.n, self.block
        return (
            n >= 512
            and (n & (n - 1)) == 0
            and self.zpf in (1, 2)
            and self.hop * 4 <= n  # high overlap: where sliding wins
            and self.margin % b == 0  # block-aligned hx ring writes
            and n >= 2 * b  # overlap-save margins stay >= n/2
        )

    @property
    def frames(self) -> FrameBuffer:
        return FrameBuffer(self.h, self.hop, self.block)

    @property
    def extra_fresh(self) -> int:
        """Post-reset guard beyond the h-window: the oldest hx sample a
        column reads was synthesized from raw samples up to
        ``n - block`` samples past the h-window start."""
        return self.h - self.margin - self.block - self.center

    @property
    def cols_cap(self) -> int:
        return self.frames.cols_cap

    @property
    def fir_half(self) -> int:
        """Half-length of the windowed Hilbert FIR (== the margin)."""
        return self.margin

    # -- host constants ------------------------------------------------------

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _consts(self):
        """``(rot_r, rot_i, upd, ramp)``: the rotation phasors, the fused
        ``[2*hop, 4*bins]`` delta matrix (rows [new; old] samples, columns
        U_re | U_im | V_re | V_im) and the time ramp, float32."""
        n, hop, bins, pfft = self.n, self.hop, self.bins, self.pfft
        k = np.arange(bins)
        rot = np.exp(2j * np.pi * k * hop / pfft)
        j = np.arange(hop)
        # entering samples sit at window positions n..n+hop-1, leaving at
        # 0..hop-1; with padding the two exponent sets differ in phase
        e_old = np.exp(-2j * np.pi * np.outer(j, k) / pfft)
        e_new = np.exp(-2j * np.pi * np.outer(n + j, k) / pfft)
        c = (n - 1) * 0.5
        w_old = (c + hop - j)[:, None]
        w_new = (n + j - hop - c)[:, None]
        upd = np.concatenate(
            [
                np.concatenate(
                    [e_new.real, e_new.imag, w_new * e_new.real, w_new * e_new.imag], 1
                ),
                np.concatenate(
                    [-e_old.real, -e_old.imag, w_old * e_old.real, w_old * e_old.imag], 1
                ),
            ],
            axis=0,
        ).astype(np.float32)
        ramp = (np.arange(n) - c).astype(np.float32)
        return rot.real.astype(np.float32), rot.imag.astype(np.float32), upd, ramp

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _hilbert_matrix(self):
        """Toeplitz ``[block + 2K, block]`` matrix turning the newest
        ``block + 2K`` raw samples into ``block`` Hilbert-transform samples
        lagging ``margin`` behind: the ideal kernel ``2/(pi t)`` at odd
        ``t``, truncated at ``+-K`` under a Blackman taper."""
        k_half = self.fir_half
        b = self.block
        t = np.arange(-k_half, k_half + 1, dtype=np.float64)
        ker = np.zeros_like(t)
        odd = (np.abs(t) % 2) == 1
        ker[odd] = 2.0 / (np.pi * t[odd])
        m = t / k_half
        ker *= 0.42 + 0.5 * np.cos(np.pi * m) + 0.08 * np.cos(2 * np.pi * m)
        win = b + 2 * k_half
        i = np.arange(win)[:, None]
        j = np.arange(b)[None, :]
        idx = k_half + j + k_half - i  # ker index of x[start+i] for output j
        inside = (idx >= 0) & (idx <= 2 * k_half)
        return (ker[np.where(inside, idx, 0)] * inside).astype(np.float32)

    def coeffs(self) -> tuple:
        return tuple(float(a) for a in self.window.cosine_coefficients)

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _tensors(self, device: torch.device) -> dict:
        rot_r, rot_i, upd, ramp = self._consts()
        w = window_coefficients(self.window, self.n)
        arrs = dict(
            rot_r=rot_r, rot_i=rot_i, upd=upd, ramp=ramp,
            hilbert=self._hilbert_matrix(),
            normq=(0.25 * fft_bin_normalization(w, self.pfft)).astype(np.float32),
            freqb=np.arange(self.bins, dtype=np.float32) * (self.sample_rate / self.pfft),
        )
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrs.items()}
        t["tiles"] = hop_tiles(t["upd"])  # upd as the kernel stages it
        return t

    # -- state ---------------------------------------------------------------

    def init(self, lanes: int, device=None) -> dict:
        state = {
            k: torch.zeros((lanes, self.bins), dtype=torch.float32, device=device)
            for k in STATE_KEYS
        }
        state["hx"] = torch.zeros((lanes, self.frames.ring_len), dtype=torch.float32, device=device)
        state["count"] = 0
        state["anchored"] = False
        state["hx_avail"] = 0
        return state

    def stream_dims(self) -> dict:
        """Each state leaf's stream dim (lanes first); ``None`` for the
        host scalars (the JAX package's ``pspecs``)."""
        dims = dict.fromkeys(STATE_KEYS, 0)
        return {**dims, "hx": 0, "count": None, "anchored": None, "hx_avail": None}

    # -- hilbert stream ------------------------------------------------------

    def _hilbert_step(self, state: dict, info: dict, hilbert: torch.Tensor):
        """Emit ``block`` new hx samples (one Toeplitz product) into the hx
        ring, in place, at the slots of their raw counterparts."""
        fb = self.frames
        b, cap = self.block, fb.cap
        win = b + 2 * self.fir_half
        # the newest needed sample is the newest sample; clipped reads
        # during warm-up produce values that hx_avail keeps out of valid
        # columns
        seg = min(max((info["origin_next"] - win) % cap, 0), fb.ring_len - win)
        emit = torch.matmul(info["buf"][:, seg : seg + win], hilbert)
        e0 = (info["origin_next"] - self.margin - b) % cap
        hx = state["hx"]
        hx[:, e0 : e0 + b] = emit
        hx[:, e0 + cap : e0 + cap + b] = emit
        hx_avail = min(state["hx_avail"] + b, cap) if info["avail"] >= win else 0
        return hx, hx_avail

    def _hx_slice(self, hx, info, offset: int, length: int):
        start = (info["base"] + offset) % self.frames.cap
        return hx[:, start : start + length]

    # -- spectra helpers -----------------------------------------------------

    def _exact_states(self, info, hx, ramp):
        """Exact one-sided spectra of the oldest ready window's crop."""
        n, c0 = self.n, self.center
        x_crop = self.frames.slice(info, c0, n)
        hx_crop = self._hx_slice(hx, info, c0, n)
        stacked = torch.stack([x_crop, hx_crop, x_crop * ramp, hx_crop * ramp], dim=1)
        spec = torch.fft.rfft(stacked, n=self.pfft)  # [S, 4, bins]
        re, im = spec.real, spec.imag
        return tuple(
            part[:, i].contiguous() for i in range(4) for part in (re, im)
        )  # uxr uxi uhr uhi vxr vxi vhr vhi

    def _deltas(self, info, hx):
        """``dx, dh [S, cols, 2*hop]``: per column, the hop entering the
        window then the hop leaving it.  Column k's window starts
        ``center + k*hop`` past the frame base; the mirrored rings make
        each run of ``cols`` hops one slice."""
        hop, n, cols = self.hop, self.n, self.cols_cap
        first = self.center - hop  # start of column 0's leaving hop
        s = info["buf"].shape[0]

        def pair(get):
            new = get(first + n, cols * hop).reshape(s, cols, hop)
            old = get(first, cols * hop).reshape(s, cols, hop)
            return torch.cat([new, old], dim=-1)

        return (
            pair(lambda off, ln: self.frames.slice(info, off, ln)),
            pair(lambda off, ln: self._hx_slice(hx, info, off, ln)),
        )

    # -- the hop step --------------------------------------------------------

    def step(self, state: dict, info: dict):
        """One engine hop: returns ``(new_state, (freq, time, power,
        valid))`` with per-column arrays ``[S, cols_cap, bins]`` and the
        stricter validity mask (h-window plus hx provenance after a reset)."""
        fb = self.frames
        hop = self.hop
        t = self._tensors(info["buf"].device)
        rot_r, rot_i, upd = t["rot_r"], t["rot_i"], t["upd"]

        hx, hx_avail = self._hilbert_step(state, info, t["hilbert"])
        ready = info["ready"]
        count = state["count"]
        warm = hx_avail >= fb.cap - self.margin - self.center
        refresh = (
            (count % self.refresh_steps == 0 or not state["anchored"]) and ready > 0 and warm
        )
        dx, dh = self._deltas(info, hx)
        st = tuple(state[k] for k in STATE_KEYS)
        if refresh:
            # carry substitution: column 0's slide is U0 = rot (u + dU0),
            # V0 = rot (v - hop u + dV0), so with column 0's deltas zeroed
            # u' = conj(rot) U0_exact and v' = conj(rot) V0_exact + hop u'
            # land it exactly.  Subtracting dU0 from u' instead would leave
            # the difference between this dU0 and the hop's own (the
            # kernel's 3xTF32 products, or the CPU's float64 ones), ~1e-7
            # of |dU0|: after a loud hop has left the window, far above the
            # quiet window's spectrum
            ex = self._exact_states(info, hx, t["ramp"])

            def unrot(re, im):  # conj(rot) * z
                return re * rot_r + im * rot_i, im * rot_r - re * rot_i

            uxr, uxi = unrot(ex[0], ex[1])
            uhr, uhi = unrot(ex[2], ex[3])
            vxr, vxi = unrot(ex[4], ex[5])
            vhr, vhi = unrot(ex[6], ex[7])
            st = tuple(
                x.contiguous()
                for x in (
                    uxr, uxi, uhr, uhi,
                    vxr + hop * uxr, vxi + hop * uxi, vhr + hop * uhr, vhi + hop * uhi,
                )
            )
            dx[:, 0] = 0.0
            dh[:, 0] = 0.0

        args = (st, dx, dh, upd, rot_r, rot_i, t["normq"], t["freqb"])
        on_cpu = hx.device.type == "cpu"
        if on_cpu:
            # the CPU runs the plain hop in float64, its states stored in
            # f32 as the card's are: in f32 its sums drift from the exact
            # reassignment further than the kernel's (ROADMAP.md, section C)
            args = (tuple(x.double() for x in st), *(x.double() for x in args[1:]))
        new8, freq, time, power = reassigned_sliding_hop(
            ready, *args,
            n=self.n, zpf=self.zpf, coeffs=self.coeffs(),
            inv_2pi=self.sample_rate / (2.0 * np.pi),
            inv_hop=1.0 / hop,
            latency_hops=self.center / hop,
            tiles=t["tiles"],
        )
        if on_cpu:
            new8 = tuple(x.float() for x in new8)
            freq, time, power = freq.float(), time.float(), power.float()
        anchored = (state["anchored"] or refresh) and warm
        new_state = dict(zip(STATE_KEYS, new8))
        new_state.update(hx=hx, count=count + 1, anchored=anchored, hx_avail=hx_avail)

        # a column is valid when its whole h-window and the hx provenance
        # tail are post-reset, the hx stream is warm and the state anchored
        k = torch.arange(fb.cols_cap, dtype=torch.int32, device=hx.device)
        tail = torch.clamp_min((ready - 1 - k) * hop, 0)
        need = self.h + self.extra_fresh + tail
        valid = (k[None, :] < (ready if warm and anchored else 0)) & (
            info["fresh"][:, None] >= need[None, :]
        )
        return new_state, (freq, time, power, valid)
