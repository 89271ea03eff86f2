"""IEC A-weighting and the BS.1770 K-weighting design (port of
``utils/weighting.py``), host numpy."""

from __future__ import annotations

import numpy as np

def a_weight_db(freq_hz) -> np.ndarray:
    """IEC 61672-1 A-weighting in dB with a +2.0 dB normalization offset at
    1 kHz; non-positive frequencies map to -inf.  float32 out."""
    f = np.asarray(freq_hz, np.float64)
    c1 = 20.598997**2
    c2 = 107.65265**2
    c3 = 737.86223**2
    c4 = 12194.217**2
    f2 = np.square(f)
    with np.errstate(divide="ignore", invalid="ignore"):
        ra = (c4 * f2 * f2) / ((f2 + c1) * np.sqrt((f2 + c2) * (f2 + c3)) * (f2 + c4))
        out = 20.0 * np.log10(ra) + 2.0
    out = np.where(f > 0.0, out, -np.inf)
    return out.astype(np.float32)


# stage-1 high-shelf and stage-2 RLB high-pass design constants, re-derived
# per sample rate via the bilinear transform
_SHELF_F0 = 1681.974450955533
_SHELF_GAIN_DB = 3.999843853973347
_SHELF_Q = 0.7071752369554196
_SHELF_VB_EXP = 0.4996667741545416
_HP_F0 = 38.13547087602444
_HP_Q = 0.5003270373238773


def k_weighting_sos(sample_rate: float) -> np.ndarray:
    """K-weighting as two second-order sections ``[2, 6]`` float64; rows are
    ``[b0, b1, b2, 1, a1, a2]`` (high-shelf, then RLB high-pass)."""
    fs = float(sample_rate)

    k = np.tan(np.pi * _SHELF_F0 / fs)
    vh = 10.0 ** (_SHELF_GAIN_DB / 20.0)
    vb = vh**_SHELF_VB_EXP
    a0 = 1.0 + k / _SHELF_Q + k * k
    shelf = np.array(
        [
            (vh + vb * k / _SHELF_Q + k * k) / a0,
            2.0 * (k * k - vh) / a0,
            (vh - vb * k / _SHELF_Q + k * k) / a0,
            1.0,
            2.0 * (k * k - 1.0) / a0,
            (1.0 - k / _SHELF_Q + k * k) / a0,
        ]
    )

    k = np.tan(np.pi * _HP_F0 / fs)
    a0 = 1.0 + k / _HP_Q + k * k
    hp = np.array(
        [
            1.0,
            -2.0,
            1.0,
            1.0,
            2.0 * (k * k - 1.0) / a0,
            (1.0 - k / _HP_Q + k * k) / a0,
        ]
    )
    return np.stack([shelf, hp])
