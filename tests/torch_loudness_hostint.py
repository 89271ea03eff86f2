"""The loudness step as the port took it before its ring indices became a
device tensor: every ring row and the chunk boundary's slice taken from the
carry's host ints.  The tests hold the indexed step
(``LoudnessAnalyzer.step``) to it."""

from __future__ import annotations

import math

import torch

from openmeters_tpu_torch.analyzers.loudness import LOUDNESS_OFFSET, LoudnessSnapshot
from openmeters_tpu_torch.ops.gating import (
    ABS_GATE_LUFS,
    BIN_LO,
    BIN_WIDTH,
    LRA_REL_GATE_LU,
    MOMENTARY_CHUNKS,
    NBINS,
    REL_GATE_LU,
    SHORT_TERM_CHUNKS,
    _loudness,
)
from openmeters_tpu_torch.ops.iir import flush_denormal_state, lifted_iir_scan
from openmeters_tpu_torch.utils.level import power_to_db


def _exact_sums(wm, totals, head: int, blocks):
    k = wm.ring_blocks
    ages = (head - 1 - torch.arange(k, device=totals.device)) % k
    ages = ages.reshape((k,) + (1,) * blocks.ndim)
    out = []
    for q, _ in wm._qr:
        full = (ages < q) & (ages < blocks[None])
        out.append(torch.sum(torch.where(full, totals.double(), 0.0), dim=0))
    exact = torch.stack(out)
    sums = exact.float()
    return sums, (exact - sums.double()).float()


def windowed_push(wm, carry: dict, values, reset_mask=None) -> dict:
    b, k = wm.block_frames, wm.ring_blocks
    values = torch.where(torch.isfinite(values), values, 0.0).to(torch.float32)
    blocks, sums, comp = carry["blocks"], carry["sums"], carry["comp"]
    if reset_mask is not None:
        blocks = torch.where(reset_mask, 0, blocks)
        sums = torch.where(reset_mask[None], 0.0, sums)
        comp = torch.where(reset_mask[None], 0.0, comp)
    head = carry["head"]
    slot = head % k
    total = torch.sum(values, dim=0)
    totals, suffix = carry["totals"], carry["suffix"]
    totals[slot] = total
    for w_idx, (_, r) in enumerate(wm._qr):
        suffix[slot, w_idx] = torch.sum(values[b - r :], dim=0) if r > 0 else 0.0

    def kbn(s, c, v):
        t = s + v
        c = c + torch.where(torch.abs(s) >= torch.abs(v), (s - t) + v, (v - t) + s)
        return t, c

    blocks_after = torch.clamp_max(blocks + 1, 2**30)
    new_sums, new_comp = [], []
    for w_idx, (q, _) in enumerate(wm._qr):
        s, c = sums[w_idx], comp[w_idx]
        if q > 0:
            leave = totals[(head - q) % k]
            s, c = kbn(s, c, -torch.where(blocks_after > q, leave, 0.0))
            s, c = kbn(s, c, total)
        new_sums.append(s)
        new_comp.append(c)
    head_next = head + 1
    if head_next % wm.refresh_steps == 0:
        sums, comp = _exact_sums(wm, totals, head_next, blocks_after)
    else:
        sums, comp = torch.stack(new_sums), torch.stack(new_comp)
    return {"totals": totals, "suffix": suffix, "sums": sums, "comp": comp, "head": head_next,
            "blocks": blocks_after}


def windowed_means(wm, carry: dict):
    k, b = wm.ring_blocks, wm.block_frames
    head, blocks = carry["head"], carry["blocks"]
    out = []
    for w_idx, (q, r) in enumerate(wm._qr):
        total = carry["sums"][w_idx] + carry["comp"][w_idx]
        if r > 0:
            pick = carry["suffix"][(head - 1 - q) % k, w_idx]
            total = total + torch.where(blocks > q, pick, 0.0)
        count = torch.clamp(blocks.to(torch.float32) * b, 1.0, float(max(wm.window_lengths[w_idx], 1)))
        out.append(total / count)
    return torch.stack(out)


def gate_push(gate, carry: dict, wk2, reset_mask=None) -> dict:
    cl, b = gate.chunk_len, wk2.shape[1]
    fs, chunk_e, ring = carry["fs"], carry["chunk_e"], carry["ring"]
    pending, integrated, lra = carry["pending_reset"], carry["integrated"], carry["lra"]
    if reset_mask is not None:
        fs = torch.where(reset_mask, 0, fs)
        chunk_e = torch.where(reset_mask, 0.0, chunk_e)
        ring = torch.where(reset_mask[:, None], 0.0, ring)
        pending = pending | reset_mask
        integrated = torch.where(reset_mask, gate.floor_db, integrated)
        lra = torch.where(reset_mask, 0.0, lra)
    total = torch.sum(wk2, dim=1)
    pos, ring_idx = carry["chunk_pos"], carry["ring_idx"]
    hm_n, hm_e, hs_n, hs_e = carry["hist_m_n"], carry["hist_m_e"], carry["hist_s_n"], carry["hist_s_e"]
    if pos + b < cl:
        chunk_e = chunk_e + total
        chunk_pos = pos + b
    else:
        chunk_pos = pos + b - cl
        off = cl - pos
        before = torch.sum(wk2[:, :off], dim=1)
        closed = chunk_e + before
        new_chunk = total - before

        def ring_at(k):
            return ring[:, (ring_idx - k) % SHORT_TERM_CHUNKS]

        m_energy = closed + ring_at(1) + ring_at(2) + ring_at(3)
        s_energy = closed + torch.sum(ring, dim=1) - ring[:, ring_idx % SHORT_TERM_CHUNKS]
        fs_close = fs + off
        z_m = m_energy / float(MOMENTARY_CHUNKS * cl)
        z_s = s_energy / float(SHORT_TERM_CHUNKS * cl)
        l_m, l_s = _loudness(z_m), _loudness(z_s)
        ok_m = (fs_close >= MOMENTARY_CHUNKS * cl) & (l_m > ABS_GATE_LUFS)
        ok_s = (fs_close >= SHORT_TERM_CHUNKS * cl) & (l_s > ABS_GATE_LUFS)
        keep = (~pending).to(torch.float32)[:, None]
        for h in (hm_n, hm_e, hs_n, hs_e):
            h.mul_(keep)

        def scatter(hn, he, lv, z, ok):
            idx = torch.clamp(torch.floor((lv - BIN_LO) / BIN_WIDTH).to(torch.int64), 0, NBINS - 1)[:, None]
            okf = ok.to(torch.float32)[:, None]
            hn.scatter_add_(1, idx, okf)
            he.scatter_add_(1, idx, okf * z[:, None])

        scatter(hm_n, hm_e, l_m, z_m, ok_m)
        scatter(hs_n, hs_e, l_s, z_s, ok_s)
        centers = (BIN_LO + (torch.arange(NBINS, dtype=torch.float32, device=wk2.device) + 0.5) * BIN_WIDTH)[None, :]
        n_tot, e_tot = torch.sum(hm_n, dim=1), torch.sum(hm_e, dim=1)
        gamma_r = _loudness(e_tot / torch.clamp_min(n_tot, 1.0)) - REL_GATE_LU
        incl = (centers > gamma_r[:, None]).to(torch.float32)
        gi_n, gi_e = torch.sum(hm_n * incl, dim=1), torch.sum(hm_e * incl, dim=1)
        integrated = torch.where(
            gi_n > 0.0, torch.clamp_min(_loudness(gi_e / torch.clamp_min(gi_n, 1.0)), gate.floor_db), gate.floor_db
        )
        sn_tot, se_tot = torch.sum(hs_n, dim=1), torch.sum(hs_e, dim=1)
        gate_s = _loudness(se_tot / torch.clamp_min(sn_tot, 1.0)) - LRA_REL_GATE_LU
        cnt = hs_n * (centers > gate_s[:, None]).to(torch.float32)
        tot = torch.sum(cnt, dim=1, keepdim=True)
        cumc = torch.cumsum(cnt, dim=1)
        bin_l = torch.where(hs_n > 0.0, _loudness(hs_e / torch.clamp_min(hs_n, 1e-9)), centers)

        def percentile(q):
            first = torch.argmax((cumc >= q * tot).to(torch.int32), dim=1)
            return torch.gather(bin_l, 1, first[:, None])[:, 0]

        lra = torch.where(tot[:, 0] > 0.0, torch.clamp_min(percentile(0.95) - percentile(0.10), 0.0), 0.0)
        ring[:, ring_idx % SHORT_TERM_CHUNKS] = closed
        ring_idx = (ring_idx + 1) % SHORT_TERM_CHUNKS
        chunk_e = new_chunk
        pending = torch.zeros_like(pending)
    return {"chunk_pos": chunk_pos, "ring_idx": ring_idx, "chunk_e": chunk_e, "ring": ring,
            "fs": torch.clamp_max(fs + b, 1 << 30), "pending_reset": pending, "hist_m_n": hm_n,
            "hist_m_e": hm_e, "hist_s_n": hs_n, "hist_s_e": hs_e, "integrated": integrated, "lra": lra}


def loudness_step(analyzer, carry: dict, block, channel_weights, reset_mask=None):
    """``(carry, LoudnessSnapshot)`` of one hop, as ``LoudnessAnalyzer.step``."""
    cfg = analyzer.config
    s, b, c = block.shape
    floor = cfg.floor_db
    lane_reset = None if reset_mask is None else reset_mask[:, None].expand(s, c)
    x = block.permute(1, 0, 2).to(torch.float32)
    kw_state = carry["kw"]
    if lane_reset is not None:
        kw_state = torch.where(lane_reset, 0.0, kw_state)
    filtered, kw_state = lifted_iir_scan(x, kw_state, analyzer._kw_coeffs, lift=b)
    kw_state = flush_denormal_state(kw_state)
    wm = analyzer._windows
    k2 = filtered * filtered
    wm_carry = windowed_push(wm, carry["wm"], k2, lane_reset)
    means = windowed_means(wm, wm_carry)
    tp_carry, peak = analyzer._truepeak.process_block(carry["tp"], x, lane_reset)
    lufs_in = torch.sum(means[:2] * channel_weights[None], dim=-1)
    lufs = torch.where(
        lufs_in > 0.0,
        torch.clamp_min(LOUDNESS_OFFSET + 10.0 * torch.log(torch.clamp_min(lufs_in, 1e-45)) / math.log(10.0), floor),
        floor,
    )
    new_carry = {"kw": kw_state, "wm": wm_carry, "tp": tp_carry}
    if cfg.gating:
        wk2 = torch.einsum("bsc,sc->sb", k2, channel_weights.to(torch.float32))
        gate_carry = gate_push(analyzer._gate, carry["gate"], wk2, reset_mask)
        new_carry["gate"] = gate_carry
        integrated, lra = gate_carry["integrated"], gate_carry["lra"]
    else:
        integrated = torch.full((s,), floor, dtype=torch.float32, device=block.device)
        lra = torch.zeros((s,), dtype=torch.float32, device=block.device)
    return new_carry, LoudnessSnapshot(
        short_term_lufs=lufs[0], momentary_lufs=lufs[1], rms_fast_db=power_to_db(means[2], floor),
        rms_slow_db=power_to_db(means[3], floor), true_peak_db=power_to_db(peak * peak, floor),
        integrated_lufs=integrated, lra_lu=lra,
    )
