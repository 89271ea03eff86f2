"""The classic spectrogram, plainly: each column the DC-removed,
Hann-windowed frame of the mid signal ``(L + R) / 2``, its rFFT in float64,
per-bin power with the window's coherent-gain normalization, dB floored at
-140 and packed to u16 codes over [-144, +12] dB.

Which frames a hop emits follows the analyzer's schedule: one shared ring
phase from the stream's first hop, so in a steady hop of 256 frames at hop
64 the four columns end 192, 128, 64 and 0 frames before the hop's last
sample.  A column is valid once its whole frame lies after the stream's
start.

The reassigned spectrogram has no reference here yet; a configuration
that runs it cannot be checked by this module.
"""

from __future__ import annotations

import math

import numpy as np

from . import stored

BLOCK = 256
DB_FLOOR = -140.0
STORE_LO, STORE_HI = -144.0, 12.0
RESOLVED_DB = 60.0  # bins compared: within this of their column's peak
WHOLE_GAP = 65535  # the gap a column counts when its valid flag is wrong

LEAVES = {
    "codes": "['spectrogram'].codes",
    "valid": "['spectrogram'].valid",
}


def supported(cfg: dict) -> bool:
    return (not cfg.get("use_reassignment", True) and cfg.get("zero_padding_factor", 1) == 1
            and cfg.get("window", "hann") == "hann")


def schedule(hops, n: int, hop: int, block: int = BLOCK):
    """For each of ``hops``: ``(starts [cols], ready)``, the first sample of
    each column's frame counted from the stream's start (a column past
    ``ready`` repeats the last ready one) and the columns the hop emits."""
    cols = (block - 1) // hop + 1
    cap = -(-(n + block + hop) // block) * block
    want = {int(h) for h in hops}
    out, avail = {}, 0
    for h in range(max(want) + 1):
        avail_p = min(avail + block, cap)
        ready = (avail_p - n) // hop + 1 if avail_p >= n else 0
        ready = min(max(ready, 0), cols)
        if h in want:
            end = (h + 1) * block
            starts = [end - avail_p + min(k, max(ready - 1, 0)) * hop for k in range(cols)]
            out[h] = (np.array(starts), ready)
        avail = avail_p - ready * hop
    return [out[int(h)] for h in hops]


def series(mid, hops, cfg: dict, precision: str = "f64") -> dict:
    """``codes [H, cols, bins]`` and ``valid [H, cols]`` of ``hops`` for the
    mono stream ``mid``."""
    n, hop = int(cfg.get("fft_size", 2048)), int(cfg.get("hop_size", 64))
    i = np.arange(n)
    w = stored(0.5 - 0.5 * np.cos(2.0 * math.pi * i / n), precision)
    norm = np.full(n // 2 + 1, 4.0 / np.sum(w) ** 2)
    norm[0] = norm[-1] = 1.0 / np.sum(w) ** 2
    if precision != "f64":
        k = np.arange(n // 2 + 1)
        phase = 2.0 * math.pi * np.outer(i, k) / n
        dft_r, dft_i = stored(np.cos(phase), precision), stored(-np.sin(phase), precision)
    codes, valid = [], []
    padded = np.concatenate([np.zeros(n), np.asarray(mid, np.float64)])  # frames before the start read zeros
    for h, (starts, ready) in zip(hops, schedule(hops, n, hop)):
        frames = np.stack([padded[s + n : s + 2 * n] for s in starts])
        frames = stored(frames - frames.mean(axis=-1, keepdims=True), precision)
        xw = frames * w
        if precision == "f64":
            spec = np.fft.rfft(xw, axis=-1)
            power = spec.real**2 + spec.imag**2
        else:
            xw = stored(xw, precision)
            power = (xw @ dft_r) ** 2 + (xw @ dft_i) ** 2
        power = power * norm
        with np.errstate(divide="ignore"):
            db = np.where(power > 0.0, np.maximum(10.0 * np.log10(np.where(power > 0, power, 1.0)), DB_FLOOR),
                          DB_FLOOR)
        code = np.clip(np.round((db - STORE_LO) * (65535.0 / (STORE_HI - STORE_LO))), 0, 65535)
        codes.append(code)
        valid.append(np.array([k < ready and s >= 0 for k, s in enumerate(starts)]))
    return {"codes": np.stack(codes), "valid": np.stack(valid)}


def expected(x, hops, cfg: dict, precision: str = "f64") -> dict:
    """:func:`series` of the mid signal of the stereo stream ``x``."""
    if not supported(cfg):
        raise NotImplementedError(f"no reference for the spectrogram {cfg}")
    x = np.asarray(x, np.float64)
    return series(0.5 * (x[:, 0] + x[:, 1]), hops, cfg, precision)


def gaps(got: dict, want: dict) -> dict:
    """``spectrogram_code_gap``: the largest code gap at valid bins within
    60 dB of their column's peak (reference codes); a column whose valid
    flag differs counts ``WHOLE_GAP``.  Codes may cover only the last of
    the hops that the valid flags cover (a meter fetch leaves them on the
    card)."""
    worst = 0.0
    gv = np.asarray(got["valid"]).astype(bool)
    wv = np.asarray(want["valid"]).astype(bool)
    if gv.shape != wv.shape or (gv != wv).any():
        worst = float(WHOLE_GAP)
    if "codes" in got:
        ref = np.asarray(want["codes"], np.float64)
        d = np.abs(np.asarray(got["codes"], np.float64) - ref)
        peak = ref.max(axis=-1, keepdims=True)
        near = wv[len(wv) - len(ref):, :, None] & (ref >= peak - round(RESOLVED_DB * 65535 / (STORE_HI - STORE_LO)))
        if near.any():
            worst = max(worst, float(d[near].max()))
    return {"spectrogram_code_gap": worst}
