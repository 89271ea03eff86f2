"""The update matrices of the two sliding hops as their kernels stage them.

B1a (``csrc/sliding_hop_deltas.cu``) and B2 (``csrc/reassigned_hop.cu``)
multiply sample deltas by a DFT update matrix ``upd [K, parts * bins]`` on
the tensor cores, one bin tile of ``ext`` bins (``halo`` of them on each
side shared with the neighbouring tiles) per block, in two halves of
``ext / 2`` bins.  TF32 ``wgmma`` reads both operands K-major, so each
block's slice of ``upd`` is stored transposed: for half ``h``, row ``part *
ext / 2 + j`` is bin ``tile * (ext - 2 * halo) - halo + h * ext / 2 + j``
of that part, zero outside ``[0, bins)``; K is padded with zeros to a
multiple of ``KC`` and cut into chunks of ``KC``, each chunk in the
kernels' shared-memory layout (``csrc/tf32_wgmma.cuh``): core matrices of 8
rows by 4 values, the ``KC / 4`` of a row group side by side, the row groups
in order.  So a block copies each chunk as one contiguous run.  The values
stay f32: the kernels split them into TF32 hi / lo parts as they stage
them.
"""

from __future__ import annotations

import torch

KC = 16  # K values per staged chunk (tf32_wgmma.cuh)


def update_tiles(upd: torch.Tensor, bins: int, parts: int, ext: int, halo: int) -> torch.Tensor:
    """``[tiles, 2 halves, chunks, parts * ext / 2 * KC]`` float32 on
    ``upd``'s device, from ``upd [K, parts * bins]`` (columns part-major)."""
    k = upd.shape[0]
    if tuple(upd.shape) != (k, parts * bins):
        raise ValueError(f"upd {tuple(upd.shape)}, want (K, {parts * bins})")
    tile = ext - 2 * halo
    ntiles = -(-bins // tile)
    kp = -(-k // KC) * KC
    dev = upd.device
    g = torch.arange(ntiles, device=dev)[:, None] * tile - halo + torch.arange(ext, device=dev)
    inside = (g >= 0) & (g < bins)  # [tiles, ext]
    idx = torch.arange(parts, device=dev)[None, :, None] * bins + g.clamp(0, bins - 1)[:, None, :]
    t = upd.float()[:, idx.reshape(-1)].reshape(k, ntiles, parts, ext) * inside[None, :, None, :]
    t = torch.nn.functional.pad(t.permute(1, 2, 3, 0), (0, kp - k))  # [tiles, parts, ext, kp]
    rows = parts * ext // 2  # a half's rows
    t = t.reshape(ntiles, parts, 2, ext // 2, kp).transpose(1, 2)  # [tiles, half, parts, ext/2, kp]
    t = t.reshape(ntiles, 2, rows // 8, 8, kp // KC, KC // 4, 4)
    # -> [tile, half, chunk, row group, core matrix along K, row in group, value]
    return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(ntiles, 2, kp // KC, rows * KC).contiguous()
