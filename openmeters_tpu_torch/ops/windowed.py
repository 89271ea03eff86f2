"""Trailing-window running means over streaming blocks (port of
``ops/windowed.py``).

A ring of per-block sums plus, per window, a ring of suffix sums of the
last ``W mod B`` samples of each block: a trailing window ending on a block
boundary is ``q = W // B`` whole blocks plus one stored suffix.  The
whole-block part is a running sum with a Kahan-Babuska-Neumaier
compensated add, re-reduced exactly from the ring every ``refresh_steps``
pushes.  The ring head is a host int shared by all lanes, so the refresh is
a host branch.

The re-reduction sums the ring in float64 and stores the result as an f32
pair (``sums`` the leading part, ``comp`` the rest), so it is exact
relative to the window it reduces.  A plain f32 sum, as the JAX package
takes, is off by ~1e-7 of the largest block it spans; when loud audio
leaves a window that then holds quiet audio, that error stays in the sum
until the next re-reduction.  After a 70 dB drop an f32 re-reduction left
a trailing mean 0.62 of itself off here, and leaves the JAX package's 0.34
off (``tests/test_torch_longrun.py::test_windowed_means_exact_after_a_drop``).

The rings are updated IN PLACE (one row each per push): ``push_block``
mutates ``carry["totals"]`` and ``carry["suffix"]``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BlockWindowedMeans:
    block_frames: int
    window_lengths: tuple[int, ...]
    refresh_steps: int = 32  # exact re-reduction cadence (drift bound)

    def __post_init__(self):
        if self.refresh_steps < 1:
            raise ValueError(f"refresh_steps must be >= 1, got {self.refresh_steps}")

    @property
    def _qr(self):
        b = self.block_frames
        return tuple((max(w, 1) // b, max(w, 1) % b) for w in self.window_lengths)

    @property
    def ring_blocks(self) -> int:
        return max(q + 1 for q, _ in self._qr)

    def init(self, lane_shape: tuple[int, ...], device=None) -> dict:
        k = self.ring_blocks
        nw = len(self.window_lengths)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            "totals": zeros(k, *lane_shape),
            "suffix": zeros(k, nw, *lane_shape),  # slot-major
            "sums": zeros(nw, *lane_shape),
            "comp": zeros(nw, *lane_shape),
            "head": 0,
            "blocks": zeros(*lane_shape, dtype=torch.int32),
        }

    def _exact_sums(self, totals, head: int, blocks):
        """Masked re-reduction of the whole-block window sums, in float64,
        as ``(sums, comp)``: the f32 leading part and the f32 rest."""
        k = self.ring_blocks
        ages = (head - 1 - torch.arange(k, device=totals.device)) % k
        ages = ages.reshape((k,) + (1,) * blocks.ndim)
        out = []
        for q, _ in self._qr:
            full = (ages < q) & (ages < blocks[None])
            out.append(torch.sum(torch.where(full, totals.double(), 0.0), dim=0))
        exact = torch.stack(out)
        sums = exact.float()
        return sums, (exact - sums.double()).float()

    def push_block(self, carry: dict, values, reset_mask=None) -> dict:
        """Push one ``[B, lanes...]`` block.  Non-finite values count as 0;
        ``reset_mask [lanes...]`` restarts those lanes' windows."""
        b = self.block_frames
        k = self.ring_blocks
        assert values.shape[0] == b
        values = torch.where(torch.isfinite(values), values, 0.0).to(torch.float32)

        blocks = carry["blocks"]
        sums = carry["sums"]
        comp = carry["comp"]
        if reset_mask is not None:
            blocks = torch.where(reset_mask, 0, blocks)
            sums = torch.where(reset_mask[None], 0.0, sums)
            comp = torch.where(reset_mask[None], 0.0, comp)

        head = carry["head"]
        slot = head % k
        total = torch.sum(values, dim=0)
        totals = carry["totals"]
        suffix = carry["suffix"]
        totals[slot] = total
        for w_idx, (_, r) in enumerate(self._qr):
            if r > 0:
                suffix[slot, w_idx] = torch.sum(values[b - r :], dim=0)
            else:
                suffix[slot, w_idx] = 0.0

        def kbn(s, c, v):
            t = s + v
            c = c + torch.where(torch.abs(s) >= torch.abs(v), (s - t) + v, (v - t) + s)
            return t, c

        # subtract the block whose age reaches q after this push, then add
        # the entering one; blocks from before a lane's reset never leave
        blocks_after = torch.clamp_max(blocks + 1, 2**30)
        new_sums, new_comp = [], []
        for w_idx, (q, _) in enumerate(self._qr):
            s, c = sums[w_idx], comp[w_idx]
            if q > 0:
                leave = totals[(head - q) % k]
                s, c = kbn(s, c, -torch.where(blocks_after > q, leave, 0.0))
                s, c = kbn(s, c, total)
            new_sums.append(s)
            new_comp.append(c)

        head_next = head + 1
        if head_next % self.refresh_steps == 0:
            sums, comp = self._exact_sums(totals, head_next, blocks_after)
        else:
            sums = torch.stack(new_sums)
            comp = torch.stack(new_comp)

        return {
            "totals": totals,
            "suffix": suffix,
            "sums": sums,
            "comp": comp,
            "head": head_next,
            "blocks": blocks_after,
        }

    def means(self, carry: dict):
        """Trailing means ``[n_windows, lanes...]``; the divisor is
        ``clamp(samples_pushed, 1, W)``."""
        k = self.ring_blocks
        b = self.block_frames
        head = carry["head"]
        blocks = carry["blocks"]
        out = []
        for w_idx, (q, r) in enumerate(self._qr):
            total = carry["sums"][w_idx] + carry["comp"][w_idx]
            if r > 0:
                pick = carry["suffix"][(head - 1 - q) % k, w_idx]
                total = total + torch.where(blocks > q, pick, 0.0)
            count = torch.clamp(
                blocks.to(torch.float32) * b,
                1.0,
                float(max(self.window_lengths[w_idx], 1)),
            )
            out.append(total / count)
        return torch.stack(out)
