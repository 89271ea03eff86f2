"""Gated integrated loudness (BS.1770-5) and loudness range (EBU Tech 3342),
streaming and batched over streams (port of ``ops/gating.py``).

Gating runs on 100 ms chunks.  A hop crosses at most one chunk boundary;
the in-hop split is taken at the exact boundary offset.  A 30-slot ring of
closed chunk energies serves both block sizes (momentary = last 4 chunks,
short-term = last 30).  Closed blocks add (count, energy) to per-stream
histograms over [-70, +10) LUFS at 0.1 LU, from which the relative gates
and the LRA percentiles are read.

The chunk cadence (``chunk_pos``, ``ring_idx``) is shared by all streams and
kept as host ints, so the boundary test is a host branch: 18 of every 19
hops touch none of the ``[S, NBINS]`` state.  The boundary offset and the
ring slots a crossing reads are taken from them on the host
(:meth:`GatedLoudness.cadence`) and reach the device as an index tensor, so
every crossing runs the same operations.  On a crossing the ring slot and
the histograms are updated IN PLACE.
"""

from __future__ import annotations

import dataclasses
import math

import torch

OFFSET = -0.691
ABS_GATE_LUFS = -70.0
REL_GATE_LU = 10.0
LRA_REL_GATE_LU = 20.0
NBINS = 800  # [-70, +10) at 0.1 LU
BIN_LO = -70.0
BIN_WIDTH = 0.1
MOMENTARY_CHUNKS = 4  # 400 ms
SHORT_TERM_CHUNKS = 30  # 3 s


def _loudness(z):
    """Weighted mean square -> LUFS (no floor)."""
    return OFFSET + 10.0 * torch.log(torch.clamp_min(z, 1e-38)) / math.log(10.0)


@dataclasses.dataclass(frozen=True)
class GatedLoudness:
    sample_rate: float = 48_000.0
    block_frames: int = 256
    floor_db: float = -99.9

    @property
    def chunk_len(self) -> int:
        return max(int(round(0.1 * self.sample_rate)), 1)

    def init(self, n_streams: int, device=None) -> dict:
        s = n_streams

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            "chunk_pos": 0,
            "ring_idx": 0,
            "chunk_e": zeros(s),
            "ring": zeros(s, SHORT_TERM_CHUNKS),
            "fs": zeros(s, dtype=torch.int32),  # frames since reset
            "pending_reset": torch.ones((s,), dtype=torch.bool, device=device),
            "hist_m_n": zeros(s, NBINS),
            "hist_m_e": zeros(s, NBINS),
            "hist_s_n": zeros(s, NBINS),
            "hist_s_e": zeros(s, NBINS),
            "integrated": torch.full((s,), self.floor_db, dtype=torch.float32, device=device),
            "lra": zeros(s),
        }

    def stream_dims(self) -> dict:
        """Each carry leaf's stream dim, ``None`` for the host scalars that
        every shard holds alike (the JAX package's ``pspecs``)."""
        dims = dict.fromkeys(
            ("chunk_e", "ring", "fs", "pending_reset", "hist_m_n", "hist_m_e", "hist_s_n", "hist_s_e",
             "integrated", "lra"),
            0,
        )
        return {"chunk_pos": None, "ring_idx": None, **dims}

    def cadence(self, chunk_pos: int, ring_idx: int) -> tuple[bool, list[int]]:
        """The host side of a hop at ``chunk_pos``: whether it closes a chunk,
        and its indices: the frames of the hop that close the old chunk, the
        ring slot the closed chunk goes to, and the slots 1, 2 and 3 chunks
        back."""
        back = [(ring_idx - k) % SHORT_TERM_CHUNKS for k in range(4)]
        return chunk_pos + self.block_frames >= self.chunk_len, [self.chunk_len - chunk_pos, *back]

    def next_cadence(self, chunk_pos: int, ring_idx: int) -> tuple[int, int]:
        """``(chunk_pos, ring_idx)`` after a hop at ``chunk_pos``."""
        pos = chunk_pos + self.block_frames
        if pos < self.chunk_len:
            return pos, ring_idx
        return pos - self.chunk_len, (ring_idx + 1) % SHORT_TERM_CHUNKS

    def push_block(self, carry: dict, wk2, reset_mask=None, idx=None) -> dict:
        """One hop of ``wk2 [S, B]`` weighted K-squared samples.  ``idx``:
        :meth:`cadence`'s indices as an int64 tensor on ``wk2``'s device
        (made here from the carry's cadence when not given)."""
        cl = self.chunk_len
        b = wk2.shape[1]
        if b != self.block_frames:
            raise ValueError(f"wk2 of {b} frames a hop, want {self.block_frames}")
        pos = carry["chunk_pos"]
        ring_idx = carry["ring_idx"]
        crossing, ints = self.cadence(pos, ring_idx)
        if idx is None:
            idx = torch.tensor(ints, dtype=torch.int64, device=wk2.device)

        fs = carry["fs"]
        chunk_e = carry["chunk_e"]
        ring = carry["ring"]
        pending = carry["pending_reset"]
        integrated = carry["integrated"]
        lra = carry["lra"]
        if reset_mask is not None:
            fs = torch.where(reset_mask, 0, fs)
            chunk_e = torch.where(reset_mask, 0.0, chunk_e)
            ring = torch.where(reset_mask[:, None], 0.0, ring)
            pending = pending | reset_mask
            integrated = torch.where(reset_mask, self.floor_db, integrated)
            lra = torch.where(reset_mask, 0.0, lra)

        total = torch.sum(wk2, dim=1)
        hm_n, hm_e = carry["hist_m_n"], carry["hist_m_e"]
        hs_n, hs_e = carry["hist_s_n"], carry["hist_s_e"]

        if not crossing:
            chunk_e = chunk_e + total
        else:
            off = idx[0]  # frames of this hop that close the old chunk
            frames = torch.arange(b, device=wk2.device)
            before = torch.sum(torch.where(frames < off, wk2, 0.0), dim=1)
            closed = chunk_e + before
            new_chunk = total - before

            slot = idx[1:2]
            back = ring.index_select(1, idx[1:])  # [S, 4]: 0, 1, 2, 3 chunks back
            m_energy = closed + back[:, 1] + back[:, 2] + back[:, 3]
            s_energy = closed + torch.sum(ring, dim=1) - back[:, 0]
            fs_close = fs + off
            z_m = m_energy / float(MOMENTARY_CHUNKS * cl)
            z_s = s_energy / float(SHORT_TERM_CHUNKS * cl)
            l_m = _loudness(z_m)
            l_s = _loudness(z_s)
            ok_m = (fs_close >= MOMENTARY_CHUNKS * cl) & (l_m > ABS_GATE_LUFS)
            ok_s = (fs_close >= SHORT_TERM_CHUNKS * cl) & (l_s > ABS_GATE_LUFS)

            # apply stream resets to the histograms lazily, in place
            keep = (~pending).to(torch.float32)[:, None]
            for h in (hm_n, hm_e, hs_n, hs_e):
                h.mul_(keep)

            def scatter(hn, he, lv, z, ok):
                idx = torch.clamp(
                    torch.floor((lv - BIN_LO) / BIN_WIDTH).to(torch.int64), 0, NBINS - 1
                )[:, None]
                okf = ok.to(torch.float32)[:, None]
                hn.scatter_add_(1, idx, okf)
                he.scatter_add_(1, idx, okf * z[:, None])

            scatter(hm_n, hm_e, l_m, z_m, ok_m)
            scatter(hs_n, hs_e, l_s, z_s, ok_s)

            centers = (
                BIN_LO
                + (torch.arange(NBINS, dtype=torch.float32, device=wk2.device) + 0.5)
                * BIN_WIDTH
            )[None, :]

            # integrated: relative gate -10 LU below the abs-gated mean
            n_tot = torch.sum(hm_n, dim=1)
            e_tot = torch.sum(hm_e, dim=1)
            gamma_r = _loudness(e_tot / torch.clamp_min(n_tot, 1.0)) - REL_GATE_LU
            incl = (centers > gamma_r[:, None]).to(torch.float32)
            gi_n = torch.sum(hm_n * incl, dim=1)
            gi_e = torch.sum(hm_e * incl, dim=1)
            integrated = torch.where(
                gi_n > 0.0,
                torch.clamp_min(
                    _loudness(gi_e / torch.clamp_min(gi_n, 1.0)), self.floor_db
                ),
                self.floor_db,
            )

            # LRA: relative gate -20 LU, p95 - p10 of the gated short-term
            # counts, each percentile read back as its bin's mean loudness
            sn_tot = torch.sum(hs_n, dim=1)
            se_tot = torch.sum(hs_e, dim=1)
            gate_s = _loudness(se_tot / torch.clamp_min(sn_tot, 1.0)) - LRA_REL_GATE_LU
            cnt = hs_n * (centers > gate_s[:, None]).to(torch.float32)
            tot = torch.sum(cnt, dim=1, keepdim=True)
            cumc = torch.cumsum(cnt, dim=1)
            bin_l = torch.where(
                hs_n > 0.0, _loudness(hs_e / torch.clamp_min(hs_n, 1e-9)), centers
            )

            def percentile(q):
                # argmax takes no bool tensor; on ints it returns the first
                # maximum, as the reference does
                first = torch.argmax((cumc >= q * tot).to(torch.int32), dim=1)
                return torch.gather(bin_l, 1, first[:, None])[:, 0]

            lra = torch.where(
                tot[:, 0] > 0.0,
                torch.clamp_min(percentile(0.95) - percentile(0.10), 0.0),
                0.0,
            )

            ring.index_copy_(1, slot, closed[:, None])
            chunk_e = new_chunk
            pending = torch.zeros_like(pending)

        chunk_pos, ring_idx = self.next_cadence(pos, ring_idx)
        return {
            "chunk_pos": chunk_pos,
            "ring_idx": ring_idx,
            "chunk_e": chunk_e,
            "ring": ring,
            "fs": torch.clamp_max(fs + b, 1 << 30),
            "pending_reset": pending,
            "hist_m_n": hm_n,
            "hist_m_e": hm_e,
            "hist_s_n": hs_n,
            "hist_s_e": hs_e,
            "integrated": integrated,
            "lra": lra,
        }
