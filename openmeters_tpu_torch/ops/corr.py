"""The oscilloscope trigger's correlation search: CUDA kernel wrappers and
plain versions.

Replaces ``openmeters_tpu/ops/pallas_corr.py``.  Per stream ``s`` and
offset ``o < out_len``::

    dots[s, o] = sum_k work[s, (o + shift[s] + k) mod nfft] * tmpl[s, k]
    sx[s, o]   = sum_{k < klen[s]} work[s, o + k]
    sxx[s, o]  = sum_{k < klen[s]} work[s, o + k] ** 2
    wmean[s]   = sum_{i < wlen[s]} work[s, i] / max(wlen[s], 1)

with ``work`` and ``tmpl`` zero-padded (or cut) to ``nfft``.
:func:`corr_dots_sums_ring` reads ``work[s, j] = ring[s, starts[s] + j]``,
``j < wcap``, straight from the mirrored history ring (starts clipped to
``[0, lanes - wcap]``); :func:`corr_dots_sums` takes the work rows;
:func:`corr_dots` returns the dots alone.

All three launch the one kernel in ``csrc/corr_search.cu`` for CUDA tensors
and run their ``*_reference`` plain version for CPU tensors; on any other
device they raise.  The plain versions are the JAX package's own non-kernel
formulation (``analyzers/oscilloscope.py`` ``_stable_capture``): an rFFT of
each operand, the conjugate product times the integer-exact anchor phase,
an irFFT; the sums from one cumsum.  Everything is float32: bf16- or
TF32-class error in the dots (~3e-3 of the peak) jitters the trigger's
argmax.  Each wrapper's ``launches`` counts its kernel launches.  The
kernel takes any power-of-two ``nfft`` from 16 and runs its transforms on
``csrc/fft_block.cuh`` (tables: :mod:`ops.block_fft`): up to 16384 points
its buffer is in shared memory, above that in a global scratch row per
block, with the prefix sums and the half-length inverse's input in shared
memory where they fit (at 32768 points, 192 kHz, both do).
"""

from __future__ import annotations

import math

import torch

from openmeters_tpu_torch.ops.block_fft import plan_table
from openmeters_tpu_torch.ops.rows import window_rows_reference

# bytes of dynamic shared memory one block may opt into on Hopper, beside the
# kernel's 256 static bytes
MAX_SMEM = 232448 - 256
FFT_STAGES = 4  # radix-2 stages a pass of the kernel's transforms


def shift_phase(shift, nfft: int):
    """``e^{+2 pi i k shift / nfft}`` over the one-sided bins ``k``, the
    angle reduced mod ``nfft`` in exact integers before the f32 trig (the
    JAX package's ``_shift_phase``).  Returns ``(cos, sin)`` ``[S, bins]``."""
    k = torch.arange(nfft // 2 + 1, device=shift.device, dtype=torch.int64)
    m = torch.remainder(k[None, :] * shift.long()[:, None], nfft)
    ang = (2.0 * math.pi / nfft) * m.to(torch.float32)
    return torch.cos(ang), torch.sin(ang)


def corr_dots_reference(work, tmpl, shift, nfft: int, out_len: int):
    """Plain version of :func:`corr_dots`."""
    wf = torch.fft.rfft(work.float(), n=nfft)
    tf = torch.fft.rfft(tmpl.float(), n=nfft)
    c_re = wf.real * tf.real + wf.imag * tf.imag
    c_im = wf.imag * tf.real - wf.real * tf.imag
    ph_re, ph_im = shift_phase(shift, nfft)
    d = torch.complex(c_re * ph_re - c_im * ph_im, c_re * ph_im + c_im * ph_re)
    return torch.fft.irfft(d, n=nfft)[:, :out_len]


def corr_dots_sums_reference(work, tmpl, klen, wlen, shift, nfft: int, out_len: int):
    """Plain version of :func:`corr_dots_sums`."""
    s, lw = work.shape
    dots = corr_dots_reference(work, tmpl, shift, nfft, out_len)
    work = work.float()
    cs = torch.cumsum(torch.cat([work, work * work], dim=0), dim=-1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=-1)  # [2S, lw + 1]
    hi = window_rows_reference(cs, klen.repeat(2), out_len)
    lo = cs[:, :out_len]
    sums = hi - lo
    wl = wlen.long()
    inside = (wl >= 0) & (wl <= lw)
    total = cs[:s].gather(1, wl.clamp(0, lw)[:, None])[:, 0]
    total = torch.where(inside, total, torch.zeros_like(total))
    wmean = total / torch.clamp_min(wlen.to(torch.float32), 1.0)
    return dots, sums[:s], sums[s:], wmean


def corr_dots_sums_ring_reference(ring, starts, tmpl, klen, wlen, shift, nfft: int,
                                  out_len: int, wcap: int):
    """Plain version of :func:`corr_dots_sums_ring`."""
    st = starts.long().clamp(0, ring.shape[1] - wcap)
    work = window_rows_reference(ring, st, wcap)
    return corr_dots_sums_reference(work, tmpl, klen, wlen, shift, nfft, out_len)


def _launch(src, starts, tmpl, klen, wlen, shift, nfft, out_len, wcap, sums: bool):
    """Check the arguments and launch ``corr_search_kernel``; returns
    ``(dots, sx, sxx, wmean)`` (the last three ``None`` without sums)."""
    dev = src.device
    s, src_len = src.shape
    if tmpl.dim() != 2 or tmpl.shape[0] != s:
        raise ValueError(f"tmpl: want [{s}, L], got {tuple(tmpl.shape)}")
    if nfft < 16 or nfft & (nfft - 1):
        raise ValueError(f"unsupported: nfft {nfft} is not a power of two from 16")
    if not (1 <= out_len <= nfft and 1 <= wcap <= src_len) or (sums and out_len > wcap + 1):
        raise ValueError(f"unsupported: out_len {out_len}, window {wcap} of {src_len}")
    for name, t in (("source", src), ("tmpl", tmpl)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous float32 tensor on {dev}")
    ints = []
    for name, t in (("starts", starts), ("klen", klen), ("wlen", wlen), ("shift", shift)):
        if t is None:
            ints.append(None)
            continue
        if t.device != dev or t.shape != (s,):
            raise ValueError(f"{name}: want [{s}] on {dev}, got {tuple(t.shape)} on {t.device}")
        ints.append(t.to(torch.int32).contiguous())
    st, kl, wl, sh = ints

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    # the kernel's buffer (float2): the transform, or the window's prefix sums;
    # in a scratch row per block where it outgrows shared memory, and with it
    # the half-length inverse's input where that does too
    words = max(nfft, wcap + 1) if sums else nfft
    scratch, grid = None, 0
    if 8 * words > MAX_SMEM:
        grid = min(s, torch.cuda.get_device_properties(dev).multi_processor_count)
        row = words + (nfft // 2 if 4 * nfft > MAX_SMEM else 0)
        scratch = torch.empty((grid, 2 * row), dtype=torch.float32, device=dev)
    log2n = nfft.bit_length() - 1
    dif_tw = plan_table(log2n, FFT_STAGES, False, dev)
    dit_tw = plan_table(log2n - 1, FFT_STAGES, True, dev)
    dots = torch.empty((s, out_len), dtype=torch.float32, device=dev)
    sx = sxx = wmean = None
    if sums:
        sx = torch.empty_like(dots)
        sxx = torch.empty_like(dots)
        wmean = torch.empty((s,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.corr_search_launch(
            src.data_ptr(), ptr(st), tmpl.data_ptr(), ptr(kl), ptr(wl), sh.data_ptr(),
            dif_tw.data_ptr(), dit_tw.data_ptr(),
            dots.data_ptr(), ptr(sx), ptr(sxx), ptr(wmean), ptr(scratch), grid,
            s, src_len, wcap, tmpl.shape[1], nfft, out_len, int(sums), stream,
        )
    if rc != 0:
        raise RuntimeError(f"corr_search kernel launch failed: cudaError {rc}")
    return dots, sx, sxx, wmean


def _route(name: str, x) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")
    return True


def corr_dots_sums_ring(ring, starts, tmpl, klen, wlen, shift, nfft: int,
                        out_len: int, wcap: int):
    """Trigger search, exact sliding window sums and region mean, the work
    window gathered from the mirrored history ring ``[S, lanes]``.
    Returns ``(dots, sx, sxx, wmean)``: ``[S, out_len]`` three times and
    ``[S]``."""
    if not _route("corr_dots_sums_ring", ring):
        return corr_dots_sums_ring_reference(
            ring, starts, tmpl, klen, wlen, shift, nfft, out_len, wcap
        )
    out = _launch(ring, starts, tmpl, klen, wlen, shift, nfft, out_len, wcap, sums=True)
    corr_dots_sums_ring.launches += 1
    return out


def corr_dots_sums(work, tmpl, klen, wlen, shift, nfft: int, out_len: int):
    """As :func:`corr_dots_sums_ring` on given ``[S, L]`` work rows."""
    if not _route("corr_dots_sums", work):
        return corr_dots_sums_reference(work, tmpl, klen, wlen, shift, nfft, out_len)
    out = _launch(work, None, tmpl, klen, wlen, shift, nfft, out_len, work.shape[1], sums=True)
    corr_dots_sums.launches += 1
    return out


def corr_dots(work, tmpl, shift, nfft: int, out_len: int):
    """The dots alone, ``[S, out_len]``."""
    if not _route("corr_dots", work):
        return corr_dots_reference(work, tmpl, shift, nfft, out_len)
    dots = _launch(work, None, tmpl, None, None, shift, nfft, out_len, work.shape[1], sums=False)[0]
    corr_dots.launches += 1
    return dots


corr_dots_sums_ring.launches = 0
corr_dots_sums.launches = 0
corr_dots.launches = 0
