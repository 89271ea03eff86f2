"""Bars for holding one implementation's reassigned spectrogram columns
against another's: a kernel against its plain version, the card against the
CPU, or the port against the JAX package.

At valid bins within 60 dB of their column's peak power:
|d freq| <= 0.5 Hz, |d power| / power <= 5e-3 and |d time| <= 0.01 hop (the
JAX package's bars for its reassigned kernels,
tests/test_pallas_reassigned.py:68-75); at each column's peak bin
|d time| <= 1e-4 hop (BASELINE.md).

``drift=True`` is for two sides that slide states of their own: runs of
many hops, or one hop against the JAX package's kernel, whose delta
products are bf16x3 splits rather than f32 FMAs.  Their states part by
~1e-7 of the row's largest bin, and the ramp-weighted spectrum V (up to n/2
times U) carries that into the time correction over the bin's own |B|, so
the time error grows as the bin's amplitude ratio to the peak.  The port
against the JAX package on the CPU reaches 8.2e-3 hop within 50 dB and
1.5e-2 hop within 60 dB; the time bar there is 0.015 hop within 50 dB and
0.03 hop from 50 to 60 dB.
"""

from __future__ import annotations

import torch

RESOLVED_POWER = 1e-6  # 60 dB below the column's peak power
DRIFT_SPLIT_POWER = 1e-5  # 50 dB
FREQ_HZ = 0.5
POWER_REL = 5e-3
TIME_HOPS = 0.01
TIME_AT_PEAK = 1e-4
DRIFT_TIME_HOPS = (0.015, 0.03)  # within 50 dB, from 50 to 60 dB


def reassigned_errors(ours, ref, valid, *, drift: bool):
    """Largest errors of ``ours`` against ``ref``, each ``(freq_hz,
    time_offset, power)`` tensors ``[..., bins]``, at the held bins: valid
    (``valid`` ``[...]`` bool) and within 60 dB of their column's peak.

    Returns ``(errors, held)``; ``errors["time_over_bar"]`` is the largest
    time error as a share of its bar."""
    of, ot, op = (x.double() for x in ours)
    rf, rt, rp = (x.double().to(of.device) for x in ref)
    valid = valid.to(of.device)
    peak = rp.amax(-1, keepdim=True)
    held = valid[..., None] & (rp >= RESOLVED_POWER * peak)
    dt = (ot - rt).abs()
    if drift:
        bar = torch.full_like(dt, DRIFT_TIME_HOPS[1])
        bar = bar.masked_fill(rp >= DRIFT_SPLIT_POWER * peak, DRIFT_TIME_HOPS[0])
    else:
        bar = torch.full_like(dt, TIME_HOPS)

    def held_max(x):
        return float(torch.where(held, x, torch.zeros_like(x)).max()) if bool(held.any()) else 0.0

    at_peak = dt.gather(-1, rp.argmax(-1, keepdim=True))[..., 0]
    errors = {
        "freq_hz": held_max((of - rf).abs()),
        "time_hops": held_max(dt),
        "time_over_bar": held_max(dt / bar),
        "power_rel": held_max((op - rp).abs() / rp.clamp_min(1e-30)),
        "time_at_peak": float(torch.where(valid, at_peak, torch.zeros_like(at_peak)).max()),
        "power_abs_all": float((op - rp).abs().max()),
    }
    return errors, held


def check_reassigned(errors: dict, where: str = "") -> None:
    """Raise ``AssertionError`` if ``errors`` (from
    :func:`reassigned_errors`) break a bar."""
    for ok, what in (
        (errors["freq_hz"] <= FREQ_HZ, f"freq differs by {errors['freq_hz']} Hz"),
        (errors["power_rel"] <= POWER_REL, f"power differs by {errors['power_rel']} relative"),
        (errors["time_over_bar"] <= 1.0, f"time differs by {errors['time_over_bar']} x its bar"),
        (errors["time_at_peak"] <= TIME_AT_PEAK,
         f"time at the peak differs by {errors['time_at_peak']} hop"),
    ):
        if not ok:
            raise AssertionError(f"{where}: {what}")
