"""A hop's sample rows gathered from the transport's ring arena: CUDA
kernel wrapper and plain version.

Replaces no TPU kernel: the JAX package's assembler copies every row into a
host batch that is then sent to the device.  The port's descriptor pass
(``Transport.assemble_desc``) leaves the samples in the rings and writes
one descriptor a row, int64 ``{off0, n0, off1, n1}``: ``arena[off0 :
off0 + n0]``, then ``arena[off1 : off1 + n1]``, then zeros to the row's
end; ``n0 == -1`` marks a row copied into its staging row.  Gathering
gives the bytes the JAX package's assembler writes for the same pushes.

:func:`ring_gather` launches ``csrc/ring_gather.cu`` where ``out`` is a
CUDA tensor (the card reads arena, staging rows and descriptors from
mapped pinned host memory: :func:`host_register` for the arena) and runs
:func:`ring_gather_reference`, an index gather, where ``out`` is on the
CPU; on any other device it raises.  ``ring_gather.launches`` counts
kernel launches.  Both are exact copies.
"""

from __future__ import annotations

import ctypes

import torch


def _check_args(arena, staging, desc, out, row0: int):
    if out.dim() < 2 or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"out: want contiguous float32 [rows, ...], got {out.dtype} {tuple(out.shape)}")
    rows, row_len = out.shape[0], out[0].numel()
    if arena.dim() != 1 or arena.dtype != torch.float32:
        raise ValueError(f"arena: want a float32 vector, got {arena.dtype} {tuple(arena.shape)}")
    if desc.dim() != 2 or desc.shape[1] != 4 or desc.dtype != torch.int64 or not desc.is_contiguous():
        raise ValueError(f"desc: want contiguous int64 [S, 4], got {desc.dtype} {tuple(desc.shape)}")
    if staging.dtype != torch.float32 or not staging.is_contiguous() or staging.numel() != desc.shape[0] * row_len:
        raise ValueError(f"staging: want contiguous float32 [{desc.shape[0]}, {row_len}], got {tuple(staging.shape)}")
    if not 0 <= row0 <= desc.shape[0] - rows:
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the {desc.shape[0]} descriptors")
    return rows, row_len


def ring_gather_reference(arena, staging, desc, out, row0: int = 0):
    """Plain PyTorch version of :func:`ring_gather`."""
    rows, row_len = _check_args(arena, staging, desc, out, row0)
    off0, n0, off1, n1 = desc[row0 : row0 + rows, :, None].unbind(1)
    j = torch.arange(row_len)
    idx = torch.where(j < n0, off0 + j, off1 - n0 + j)
    empty = j >= n0 + n1
    vals = arena[idx.masked_fill_(empty, 0)].masked_fill_(empty, 0.0)
    staged = n0[:, 0] < 0
    if staged.any():
        vals[staged] = staging.reshape(-1, row_len)[row0 : row0 + rows][staged]
    out.view(rows, row_len).copy_(vals)
    return out


def ring_gather(arena, staging, desc, out, row0: int = 0, mapped=None):
    """Rows ``[row0, row0 + len(out))`` of a hop into ``out``.

    Args:
      arena: float32 vector over the transport's ring arena
        (``Transport.arena_tensor``).
      staging: the descriptor pass's staging batch ``[S, B, C]`` float32.
      desc: its descriptors ``[S, 4]`` int64.
      out: ``[rows, B, C]`` float32, every element written.
      row0: the first stream of ``out``.
      mapped: :func:`mapped_addresses` of ``(arena, staging, desc)`` on
        ``out``'s card, where a caller launches often from the same buffers;
        looked up at each call where not given (CUDA only).

    On a card, the launch runs on ``out``'s device's current stream, and
    ``arena``, ``staging`` and ``desc`` must be whole mapped pinned host
    buffers that stay unchanged until it has run.
    """
    dev = out.device
    if dev.type == "cpu":
        return ring_gather_reference(arena, staging, desc, out, row0)
    if dev.type != "cuda":
        raise ValueError(f"ring_gather runs into cpu or cuda tensors, not {dev}")
    rows, row_len = _check_args(arena, staging, desc, out, row0)
    if any(t.device.type != "cpu" for t in (arena, staging, desc)):
        raise ValueError("ring_gather on a card reads arena, staging and desc from host memory")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        d_arena, d_staging, d_desc = mapped or mapped_addresses(arena, staging, desc)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ring_gather_launch(d_arena, d_staging, d_desc, out.data_ptr(), row0, rows, row_len, stream)
    if rc != 0:
        raise RuntimeError(f"ring_gather kernel launch failed: cudaError {rc}")
    ring_gather.launches += 1
    return out


ring_gather.launches = 0


def mapped_addresses(*tensors) -> tuple[int, ...]:
    """The current card's addresses of mapped pinned host tensors (pinned
    by PyTorch, or in memory :func:`host_register` pinned)."""
    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    out = []
    for t in tensors:
        ptr = ctypes.c_void_p()
        rc = lib.ring_host_device_pointer(t.data_ptr(), ctypes.byref(ptr))
        if rc != 0:
            raise RuntimeError(f"no device address for host memory at {t.data_ptr():#x}: cudaError {rc}")
        out.append(ptr.value)
    return tuple(out)


def host_register(ptr: int, nbytes: int) -> None:
    """Pin ``nbytes`` of host memory at ``ptr`` (page-aligned) for every
    card, mapped into their address spaces."""
    from openmeters_tpu_torch.ops._build import load_library

    rc = load_library().ring_host_register(ptr, nbytes)
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: cudaError {rc}")


def host_unregister(ptr: int) -> None:
    """Undo :func:`host_register`."""
    from openmeters_tpu_torch.ops._build import load_library

    rc = load_library().ring_host_unregister(ptr)
    if rc != 0:
        raise RuntimeError(f"cudaHostUnregister failed: cudaError {rc}")
