"""Per-row window extraction: CUDA kernel wrapper and plain version.

Replaces ``openmeters_tpu/ops/pallas_rows.py::window_rows``:
``out[s, w] = x[s, start[s, w] : start[s, w] + length]`` with the starts
clipped to ``[0, N - length]``.  The oscilloscope reads its candidate
segments and its capture windows this way, straight off the mirrored
history rings.

:func:`window_rows` launches ``csrc/window_rows.cu`` for CUDA tensors and
runs :func:`window_rows_reference` (one ``torch.gather``) for CPU tensors;
on any other device it raises.  ``window_rows.launches`` counts kernel
launches.  Both are exact copies.
"""

from __future__ import annotations

import torch


def _check_args(x, starts, length: int):
    if x.dim() != 2:
        raise ValueError(f"x: want [S, N], got {tuple(x.shape)}")
    s, n = x.shape
    if not 0 < length <= n:
        raise ValueError(f"length {length} outside (0, {n}]")
    if starts.dim() not in (1, 2) or starts.shape[0] != s:
        raise ValueError(f"starts: want [{s}] or [{s}, W], got {tuple(starts.shape)}")


def window_rows_reference(x, starts, length: int):
    """Plain PyTorch version of :func:`window_rows`."""
    _check_args(x, starts, length)
    s, n = x.shape
    squeeze = starts.dim() == 1
    st = (starts[:, None] if squeeze else starts).long().clamp(0, n - length)
    w = st.shape[1]
    idx = st[..., None] + torch.arange(length, device=x.device)
    out = x.gather(1, idx.reshape(s, w * length)).reshape(s, w, length)
    return out[:, 0] if squeeze else out


def window_rows(x, starts, length: int):
    """Per-row contiguous windows.

    Args:
      x: ``[S, N]`` float32 source rows.
      starts: ``[S]`` or ``[S, W]`` integer window starts, clipped to
        ``[0, N - length]``.
      length: window length (``<= N``).

    Returns ``[S, length]`` (1-D starts) or ``[S, W, length]``.
    """
    dev = x.device
    if dev.type == "cpu":
        return window_rows_reference(x, starts, length)
    if dev.type != "cuda":
        raise ValueError(f"window_rows runs on cpu or cuda tensors, not {dev}")
    _check_args(x, starts, length)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x: want contiguous float32, got {x.dtype}")
    if starts.device != dev:
        raise ValueError(f"starts on {starts.device}, x on {dev}")
    s, n = x.shape
    squeeze = starts.dim() == 1
    st = (starts[:, None] if squeeze else starts).to(torch.int32).contiguous()
    w = st.shape[1]
    if s * w > 2**31 - 1:
        raise ValueError(f"unsupported: {s * w} windows")
    out = torch.empty((s, w, length), dtype=torch.float32, device=dev)

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_rows_launch(
            x.data_ptr(), st.data_ptr(), out.data_ptr(), s, n, w, length, stream
        )
    if rc != 0:
        raise RuntimeError(f"window_rows kernel launch failed: cudaError {rc}")
    window_rows.launches += 1
    return out[:, 0] if squeeze else out


window_rows.launches = 0
