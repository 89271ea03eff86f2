"""Trailing-window running means over streaming blocks (port of
``ops/windowed.py``).

A ring of per-block sums plus, per window, a ring of suffix sums of the
last ``W mod B`` samples of each block: a trailing window ending on a block
boundary is ``q = W // B`` whole blocks plus one stored suffix.  The
whole-block part is a running sum with a Kahan-Babuska-Neumaier
compensated add, re-reduced exactly from the ring every ``refresh_steps``
pushes.  The ring head is a host int shared by all lanes, so the refresh is
a host branch; the ring rows a push reads and writes are taken from it on
the host (:meth:`BlockWindowedMeans.cadence`) and reach the device as an
index tensor, so one push runs the same operations at every head (what a
CUDA graph of it needs).

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

    @property
    def n_leaves(self) -> int:
        """Windows with a whole-block part (a block leaves them each push)."""
        return sum(q > 0 for q, _ in self._qr)

    @property
    def n_indices(self) -> int:
        """The length of :meth:`cadence`'s index list."""
        return 1 + self.n_leaves + sum(r > 0 for _, r in self._qr)

    def cadence(self, head: int) -> tuple[bool, list[int]]:
        """The host side of push ``head``: whether it re-reduces the window
        sums, and the ring rows it touches: the slot it writes, each
        whole-block window's leaving block, then each suffix window's pick
        after the push (a row of the suffix ring seen as ``[k * nw,
        lanes...]``)."""
        k, nw = self.ring_blocks, len(self.window_lengths)
        leave = [(head - q) % k for q, _ in self._qr if q > 0]
        pick = [((head - q) % k) * nw + w for w, (q, r) in enumerate(self._qr) if r > 0]
        return (head + 1) % self.refresh_steps == 0, [head % k, *leave, *pick]

    def _exact_sums(self, totals, slot, blocks):
        """Masked re-reduction of the whole-block window sums, in float64,
        as ``(sums, comp)``: the f32 leading part and the f32 rest.
        ``slot`` ``[1]``: the ring row of the newest block."""
        k = self.ring_blocks
        ages = (slot - torch.arange(k, device=totals.device)) % k
        ages = ages.reshape((k,) + (1,) * blocks.ndim)
        out = []
        for q, _ in self._qr:
            full = (ages < q) & (ages < blocks[None])
            out.append(torch.sum(torch.where(full, totals.double(), 0.0), dim=0))
        exact = torch.stack(out)
        sums = exact.float()
        return sums, (exact - sums.double()).float()

    def push_block(self, carry: dict, values, reset_mask=None, idx=None) -> dict:
        """Push one ``[B, lanes...]`` block.  Non-finite values count as 0;
        ``reset_mask [lanes...]`` restarts those lanes' windows.  ``idx``:
        :meth:`cadence`'s indices as an int64 tensor on the values' device
        (made here from ``carry["head"]`` when not given)."""
        b = self.block_frames
        assert values.shape[0] == b
        head = carry["head"]
        refresh, ints = self.cadence(head)
        if idx is None:
            idx = torch.tensor(ints, dtype=torch.int64, device=values.device)
        slot, leaves = idx[:1], idx[1 : 1 + self.n_leaves]
        values = torch.where(torch.isfinite(values), values, 0.0).to(torch.float32)

        blocks = carry["blocks"]
        sums = carry["sums"]
        comp = carry["comp"]
        if reset_mask is not None:
            blocks = torch.where(reset_mask, 0, blocks)
            sums = torch.where(reset_mask[None], 0.0, sums)
            comp = torch.where(reset_mask[None], 0.0, comp)

        total = torch.sum(values, dim=0)
        totals = carry["totals"]
        suffix = carry["suffix"]
        totals.index_copy_(0, slot, total[None])
        tails = [
            torch.sum(values[b - r :], dim=0) if r > 0 else torch.zeros_like(total)
            for _, r in self._qr
        ]
        suffix.index_copy_(0, slot, torch.stack(tails)[None])
        leaving = totals.index_select(0, leaves)  # [n_leaves, lanes...]

        def kbn(s, c, v):
            t = s + v
            c = c + torch.where(torch.abs(s) >= torch.abs(v), (s - t) + v, (v - t) + s)
            return t, c

        # subtract the block whose age reaches q after this push, then add
        # the entering one; blocks from before a lane's reset never leave
        blocks_after = torch.clamp_max(blocks + 1, 2**30)
        new_sums, new_comp = [], []
        j = 0
        for w_idx, (q, _) in enumerate(self._qr):
            s, c = sums[w_idx], comp[w_idx]
            if q > 0:
                s, c = kbn(s, c, -torch.where(blocks_after > q, leaving[j], 0.0))
                s, c = kbn(s, c, total)
                j += 1
            new_sums.append(s)
            new_comp.append(c)

        if refresh:
            sums, comp = self._exact_sums(totals, slot, blocks_after)
        else:
            sums = torch.stack(new_sums)
            comp = torch.stack(new_comp)

        return {
            "totals": totals,
            "suffix": suffix,
            "sums": sums,
            "comp": comp,
            "head": head + 1,
            "blocks": blocks_after,
        }

    def means(self, carry: dict, pick=None):
        """Trailing means ``[n_windows, lanes...]``; the divisor is
        ``clamp(samples_pushed, 1, W)``.  ``pick``: the suffix rows of the
        last push (the tail of :meth:`cadence`'s indices; made here from
        ``carry["head"]`` when not given)."""
        b = self.block_frames
        blocks = carry["blocks"]
        if pick is None:
            ints = self.cadence(carry["head"] - 1)[1][1 + self.n_leaves :]
            pick = torch.tensor(ints, dtype=torch.int64, device=blocks.device)
        suffix = carry["suffix"]
        picked = suffix.reshape(-1, *suffix.shape[2:]).index_select(0, pick)  # [windows with a suffix, lanes...]
        out = []
        j = 0
        for w_idx, (q, r) in enumerate(self._qr):
            total = carry["sums"][w_idx] + carry["comp"][w_idx]
            if r > 0:
                total = total + torch.where(blocks > q, picked[j], 0.0)
                j += 1
            count = torch.clamp(
                blocks.to(torch.float32) * b,
                1.0,
                float(max(self.window_lengths[w_idx], 1)),
            )
            out.append(total / count)
        return torch.stack(out)
