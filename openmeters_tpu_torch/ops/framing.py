"""Streaming hop/window bookkeeping over a mirrored ring (port of
``ops/framing.py``).

A double-written rotating ring ``[lanes, 2 * cap]`` with one write origin
shared by all lanes: every block lands at ``origin`` and ``origin + cap``,
so any window of length <= cap is one contiguous slice.  The shared
scalars (``origin``, ``avail``) and the per-hop ``ready`` count are host
ints, so every branch on them is a host branch with no device sync; the
per-lane post-reset counter ``fresh`` is a tensor.

The ring is written IN PLACE: ``advance`` mutates ``carry["buf"]``, so a
carry must not be reused after it has been advanced.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FrameBuffer:
    read_len: int  # samples per analysis window
    hop: int
    block: int  # engine ingest frames per step (B)

    @property
    def cols_cap(self) -> int:
        return (self.block - 1) // self.hop + 1

    @property
    def cap(self) -> int:
        """Logical ring capacity: one extra hop of history for sliding-DFT
        consumers, rounded up to whole blocks so writes never wrap."""
        need = self.read_len + self.block + self.hop
        return -(-need // self.block) * self.block

    @property
    def ring_len(self) -> int:
        return 2 * self.cap

    def init(self, lanes: int, device=None) -> dict:
        return {
            "buf": torch.zeros((lanes, self.ring_len), dtype=torch.float32, device=device),
            "origin": 0,  # next write slot in [0, cap)
            "avail": 0,  # global hop phase
            "fresh": torch.zeros((lanes,), dtype=torch.int32, device=device),
        }

    def advance(self, carry: dict, block: torch.Tensor, reset_mask=None):
        """Ingest ``[lanes, B]`` samples.  Returns ``(new_carry, info)``;
        info holds the ring, the window ``base`` index and ``ready`` count
        (host ints) and the per-lane ``valid [lanes, cols_cap]`` mask."""
        b, cap, hop = self.block, self.cap, self.hop
        if block.shape[-1] != b:
            raise ValueError(f"block of {block.shape[-1]} frames, want {b}")
        fresh = carry["fresh"]
        if reset_mask is not None:
            fresh = torch.where(reset_mask, 0, fresh)
        fresh = torch.clamp_max(fresh + b, 2**30)

        origin = carry["origin"]
        buf = carry["buf"]
        block = block.to(torch.float32)
        buf[:, origin : origin + b] = block
        buf[:, origin + cap : origin + cap + b] = block
        end = origin + b
        avail_p = min(carry["avail"] + b, cap)
        ready = (avail_p - self.read_len) // hop + 1 if avail_p >= self.read_len else 0
        ready = min(max(ready, 0), self.cols_cap)

        # a window is valid for a lane only when all of it is post-reset;
        # window k ends (ready - 1 - k) * hop samples before the newest one
        k = torch.arange(self.cols_cap, dtype=torch.int32, device=buf.device)
        tail = torch.clamp_min((ready - 1 - k) * hop, 0)
        valid = (k[None, :] < ready) & (fresh[:, None] >= self.read_len + tail[None, :])

        new_carry = {
            "buf": buf,
            "origin": (origin + b) % cap,
            "avail": avail_p - ready * hop,
            "fresh": fresh,
        }
        info = {
            "buf": buf,
            "base": (end - avail_p) % cap,
            "ready": ready,
            "valid": valid,
            "avail": avail_p,
            "fresh": fresh,
            "origin_next": (origin + b) % cap,
        }
        return new_carry, info

    def extract(self, info) -> torch.Tensor:
        """All ready windows, ``[lanes, cols_cap, read_len]``."""
        buf, base, ready = info["buf"], info["base"], info["ready"]
        frames = []
        for k in range(self.cols_cap):
            k_eff = min(k, max(ready - 1, 0))
            start = min(max(base + k_eff * self.hop, 0), self.ring_len - self.read_len)
            frames.append(buf[:, start : start + self.read_len])
        return torch.stack(frames, dim=1)

    def slice(self, info, offset: int, length: int) -> torch.Tensor:
        """Contiguous ``[lanes, length]`` view at ``base + offset``.

        ``offset`` may be negative (sliding-DFT consumers read the hop that
        just left the window): the mirrored ring makes any logical start
        correct modulo ``cap``.  Python ``%`` is a floor modulo, never the
        truncating ``fmod``, which would go negative here."""
        assert length <= self.cap, (length, self.cap)
        start = (info["base"] + offset) % self.cap
        return info["buf"][:, start : start + length]
