"""BS.1770 K-weighting design (port of ``utils/weighting.py``), host numpy."""

from __future__ import annotations

import numpy as np

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
