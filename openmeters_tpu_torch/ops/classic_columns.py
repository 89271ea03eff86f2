"""The classic spectrogram's columns, each from its own frame: CUDA kernel
wrapper and plain version.

Per column: the frame's mean removed, the window applied, the rFFT, per-bin
power times the window's bin normalization, dB floored and packed to u16
codes over [-144, +12] dB.  :func:`classic_columns` reads the columns'
frames straight from the framing ring (``ops/framing.py``) and launches
``csrc/classic_columns.cu`` for CUDA tensors; for CPU tensors it runs
:func:`classic_columns_reference` on the frames ``FrameBuffer.extract``
gives.  On any other device it raises.  ``classic_columns.launches`` counts
kernel launches.  :func:`kernel_supports` says, from the config alone,
which sizes the kernel takes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openmeters_tpu_torch.ops.block_fft import plan_table
from openmeters_tpu_torch.ops.sliding_hop import STORE_SCALE, pack_classic_db
from openmeters_tpu_torch.utils.level import power_to_db

MAX_N = 32768  # N/2 complex f32 points (128 KB) fill one block's shared memory
FFT_STAGES = 3  # radix-2 stages a pass of the kernel's N/2-point transform (its MAXB)


def kernel_supports(n: int) -> bool:
    """Whether the CUDA kernel takes ``n``-point unpadded frames: powers of
    two from 64 to ``MAX_N``."""
    return 64 <= n <= MAX_N and n & (n - 1) == 0


def classic_columns_reference(frames, window, norm, *, floor_db: float, n: int | None = None):
    """Plain PyTorch version: ``frames [..., N]`` to codes ``[..., n/2 + 1]``
    uint16, in the frames' precision (``torch.fft.rfft``), zero-padded to
    ``n`` points where given."""
    x = (frames - frames.mean(dim=-1, keepdim=True)) * window
    spec = torch.fft.rfft(x, n=n or frames.shape[-1])
    power = (spec.real**2 + spec.imag**2) * norm
    return pack_classic_db(power_to_db(power, floor_db))


@functools.lru_cache(maxsize=None)
def _split_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``exp(-2 pi i k / n)``, ``k < n/2``, computed in float64 and stored
    as interleaved float32: the kernel's split step reads them."""
    ang = -2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)).to(device)


def classic_columns(frames, info: dict, window, norm, *, floor_db: float):
    """Codes ``[S, cols, n/2 + 1]`` uint16 of a hop's columns.

    Args:
      frames: the analyzer's :class:`~openmeters_tpu_torch.ops.framing.FrameBuffer`.
      info: its ``advance`` info (the ring, ``base`` and ``ready``).
      window, norm: ``[n]`` and ``[n/2 + 1]`` float32 on the ring's device.
    """
    buf = info["buf"]
    dev = buf.device
    n = frames.read_len
    if dev.type == "cpu":
        return classic_columns_reference(frames.extract(info), window, norm, floor_db=floor_db)
    if dev.type != "cuda":
        raise ValueError(f"classic_columns runs on cpu or cuda tensors, not {dev}")
    if not kernel_supports(n):
        raise ValueError(f"unsupported: {n}-point frames")
    s, ring_len = buf.shape
    bins = n // 2 + 1
    for name, x, shape in (("buf", buf, (s, frames.ring_len)), ("window", window, (n,)), ("norm", norm, (bins,))):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"classic_columns {name}: want contiguous float32 {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    dif_tw = plan_table(n.bit_length() - 2, FFT_STAGES, False, dev)
    cols = frames.cols_cap
    out = torch.empty((s, cols, bins), dtype=torch.uint16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.classic_columns_launch(
            buf.data_ptr(), window.data_ptr(), _split_twiddles(n, dev).data_ptr(), dif_tw.data_ptr(),
            norm.data_ptr(), out.data_ptr(), s, ring_len, int(info["base"]), frames.hop, int(info["ready"]),
            cols, n, float(floor_db), STORE_SCALE, stream,
        )
    if rc != 0:
        raise RuntimeError(f"classic_columns kernel launch failed: cudaError {rc}")
    classic_columns.launches += 1
    return out


classic_columns.launches = 0
