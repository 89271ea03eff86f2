"""BS.1770 loudness, plainly: K-weighting as two biquads over the whole
stream, trailing windows as differences of a cumulative sum, 4x true peak
as a polyphase FIR, and gated integrated loudness with EBU Tech 3342's
loudness range over 100 ms chunks, all in float64.

The semantics are the analyzer's: windows of ``int(rate * seconds)``
samples divided by the samples pushed so far (at most the window); the
momentary and short-term LUFS floored at -99.9; chunk boundaries every
4800 frames from the stream's first hop; the gates read from histograms
over [-70, +10) LUFS at 0.1 LU, each bin holding its blocks' count and
energy, the relative gate compared with bin centres, and the loudness
range's percentiles read back as their bins' mean loudness.

Binning and gating make integrated loudness and the loudness range jump
where one block's loudness sits on a bin edge or on the absolute gate, or
the relative gate on a bin centre: a rounding-level difference then moves
that block, or a whole bin, across, and the range by up to a bin or more.
Such a knife edge is any within TIE_LU; each reading is also computed with
one knife edge at a time taken the other way (``*_ties``, the nominal
reading first), and its gap is the distance to the nearest of them.
TIE_LU is twice the largest momentary-loudness gap of sound runs (PERF.md,
section 2).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter, sosfilt

from . import stored

RATE = 48_000.0
BLOCK = 256
FLOOR = -99.9
OFFSET = -0.691
WINDOWS = {"short_term": 144_000, "momentary": 19_200, "rms_fast": 14_400, "rms_slow": 48_000}
CHUNK = 4800
ABS_GATE = -70.0
REL_GATE = 10.0
LRA_REL_GATE = 20.0
NBINS, BIN_LO, BIN_WIDTH = 800, -70.0, 0.1
TIE_LU = 1e-3
CENTERS = BIN_LO + (np.arange(NBINS) + 0.5) * BIN_WIDTH

LEAVES = {
    "short_term_lufs": "['loudness'].short_term_lufs",
    "momentary_lufs": "['loudness'].momentary_lufs",
    "rms_fast_db": "['loudness'].rms_fast_db",
    "rms_slow_db": "['loudness'].rms_slow_db",
    "true_peak_db": "['loudness'].true_peak_db",
    "integrated_lufs": "['loudness'].integrated_lufs",
    "lra_lu": "['loudness'].lra_lu",
}
# compared number -> the fields it takes the largest gap over
NUMBERS = {
    "momentary_gap_lu": ("momentary_lufs",),
    "short_term_gap_lu": ("short_term_lufs",),
    "rms_gap_db": ("rms_fast_db", "rms_slow_db"),
    "true_peak_gap_db": ("true_peak_db",),
    "integrated_gap_lu": ("integrated_lufs",),
    "lra_gap_lu": ("lra_lu",),
}


def k_weighting_sos(rate: float = RATE) -> np.ndarray:
    """ITU-R BS.1770 K-weighting: the high shelf then the RLB high-pass,
    ``[2, 6]`` rows ``[b0, b1, b2, 1, a1, a2]``, designed at ``rate`` by the
    bilinear transform (libebur128's constants)."""
    f0, gain_db, q, vb_exp = 1681.974450955533, 3.999843853973347, 0.7071752369554196, 0.4996667741545416
    k = math.tan(math.pi * f0 / rate)
    vh = 10.0 ** (gain_db / 20.0)
    vb = vh**vb_exp
    a0 = 1.0 + k / q + k * k
    shelf = [(vh + vb * k / q + k * k) / a0, 2.0 * (k * k - vh) / a0, (vh - vb * k / q + k * k) / a0,
             1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]
    f0, q = 38.13547087602444, 0.5003270373238773
    k = math.tan(math.pi * f0 / rate)
    a0 = 1.0 + k / q + k * k
    hp = [1.0, -2.0, 1.0, 1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]
    return np.array([shelf, hp])


def true_peak_phases() -> np.ndarray:
    """``[3, 12]``: the three fractional phases of 4x oversampling, from
    the 49-tap Hann-windowed sinc with zero ends (libebur128's design):
    phase ``p`` tap ``i`` is ``h[4 i + p + 1]``."""
    taps = 48

    def h(j):
        x = (j - taps * 0.5) * math.pi / 4
        return 0.5 * (1.0 - math.cos(2.0 * math.pi * j / taps)) * math.sin(x) / x

    return np.array([[h(4 * i + p + 1) for i in range(12)] for p in range(3)])


def _db(power, floor=FLOOR):
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(np.where(power > 0.0, power, 1.0))
    return np.where(power > 0.0, np.maximum(db, floor), floor)


def _lufs(z):
    return OFFSET + 10.0 * np.log10(np.maximum(z, 1e-38))


def series(x, hops, precision: str = "f64") -> dict:
    """The loudness snapshot at the end of each of ``hops`` (0-based, from
    the stream's first hop) of the stereo stream ``x [frames, 2]``."""
    hops = np.asarray(hops, np.int64)
    n = int(hops.max() + 1) * BLOCK
    x = stored(np.asarray(x)[:n], precision)
    sos = stored(k_weighting_sos(), precision)
    k = stored(sosfilt(sos, x, axis=0), precision)
    k2 = k * k
    ends = (hops + 1) * BLOCK
    cs = np.concatenate([np.zeros((1, 2)), np.cumsum(k2, axis=0)])
    means = {}
    for name, w in WINDOWS.items():
        lo = np.maximum(ends - w, 0)
        means[name] = (cs[ends] - cs[lo]) / np.minimum(ends, w)[:, None]  # [H, 2]
    out = {
        "short_term_lufs": _loudness_of(means["short_term"].sum(-1)),
        "momentary_lufs": _loudness_of(means["momentary"].sum(-1)),
        "rms_fast_db": _db(means["rms_fast"]),
        "rms_slow_db": _db(means["rms_slow"]),
    }
    phases = stored(true_peak_phases(), precision)
    peak = np.abs(x)
    for p in range(3):
        peak = np.maximum(peak, np.abs(lfilter(phases[p], [1.0], x, axis=0)))
    hop_peak = peak.reshape(-1, BLOCK, 2).max(axis=1)[hops]
    out["true_peak_db"] = _db(hop_peak * hop_peak)
    integrated, lra = _gated(k2.sum(-1), hops)
    out["integrated_lufs"], out["lra_lu"] = integrated[:, 0], lra[:, 0]
    out["integrated_lufs_ties"], out["lra_lu_ties"] = integrated, lra
    return out


def supported(cfg: dict) -> bool:
    """The analyzer at its default settings."""
    return not cfg


def expected(x, hops, cfg: dict, precision: str = "f64") -> dict:
    """:func:`series` of the stereo stream ``x``; ``cfg`` (the analyzer's
    settings) must leave the defaults."""
    if not supported(cfg):
        raise NotImplementedError(f"the loudness reference takes the default settings, not {cfg}")
    return series(x, hops, precision)


def _loudness_of(z):
    return np.where(z > 0.0, np.maximum(_lufs(z), FLOOR), FLOOR)


def _bin(lv: float) -> int:
    return min(max(int(math.floor((lv - BIN_LO) / BIN_WIDTH)), 0), NBINS - 1)


def _knife_edge(lv: float, z: float):
    """``(from bin, to bin, z)``: the block of loudness ``lv`` and energy
    ``z`` taken to the other side of a bin edge or of the absolute gate
    within TIE_LU (``None``: out of the histogram); ``None`` where none is
    that near."""
    if abs(lv - ABS_GATE) < TIE_LU:
        return (_bin(lv), None, z) if lv > ABS_GATE else (None, 0, z)
    if lv <= ABS_GATE:
        return None
    b = _bin(lv)
    if lv - (BIN_LO + b * BIN_WIDTH) < TIE_LU and b > 0:
        return (b, b - 1, z)
    if BIN_LO + (b + 1) * BIN_WIDTH - lv < TIE_LU and b < NBINS - 1:
        return (b, b + 1, z)
    return None


def _moved(hn, he, edge):
    hn, he = hn.copy(), he.copy()
    src, dst, z = edge
    if src is not None:
        hn[src] -= 1.0
        he[src] -= z
    if dst is not None:
        hn[dst] += 1.0
        he[dst] += z
    return hn, he


def _gate_sides(hn, he, rel_gate: float) -> list:
    """Which bins the relative gate ``rel_gate`` LU below the histogram's
    mean lets in: the nominal side, and the side with the bin centre
    nearest the gate taken the other way where it lies within TIE_LU."""
    gate = _lufs(he.sum() / max(hn.sum(), 1.0)) - rel_gate
    incl = CENTERS > gate
    sides = [incl]
    near = int(np.argmin(np.abs(CENTERS - gate)))
    if abs(CENTERS[near] - gate) < TIE_LU:
        flipped = incl.copy()
        flipped[near] = not flipped[near]
        sides.append(flipped)
    return sides


def _integrated(hn, he) -> list:
    out = []
    for incl in _gate_sides(hn, he, REL_GATE):
        n, e = hn[incl].sum(), he[incl].sum()
        out.append(max(_lufs(e / max(n, 1.0)), FLOOR) if n > 0 else FLOOR)
    return out


def _lra(hn, he) -> list:
    out = []
    for incl in _gate_sides(hn, he, LRA_REL_GATE):
        cnt = hn * incl
        tot = cnt.sum()
        if tot <= 0:
            out.append(0.0)
            continue
        cumc = np.cumsum(cnt)
        with np.errstate(divide="ignore", invalid="ignore"):
            bin_l = np.where(hn > 0, _lufs(he / np.maximum(hn, 1e-9)), CENTERS)
        p10 = bin_l[np.argmax(cumc >= 0.10 * tot)]
        p95 = bin_l[np.argmax(cumc >= 0.95 * tot)]
        out.append(max(p95 - p10, 0.0))
    return out


def _readings(read, hn, he, edges) -> list:
    """``read`` of the histogram, then with each knife edge taken the
    other way in turn."""
    out = read(hn, he)
    for edge in edges:
        out += read(*_moved(hn, he, edge))
    return out


def _gated(wk2, hops):
    """Integrated loudness and loudness range after each of ``hops``:
    ``[H, K]`` each, the nominal reading first, then the knife edges'
    readings, NaN past their number."""
    chunks = len(wk2) // CHUNK
    chunk_e = wk2[: chunks * CHUNK].reshape(chunks, CHUNK).sum(axis=1)
    cs = np.concatenate([[0.0], np.cumsum(chunk_e)])
    hists = {span: (np.zeros(NBINS), np.zeros(NBINS), []) for span in (4, 30)}
    integrated, lra = [[FLOOR]], [[0.0]]  # after k closed chunks
    for c in range(chunks):
        for span, (hn, he, edges) in hists.items():
            if c + 1 >= span:
                z = (cs[c + 1] - cs[c + 1 - span]) / (span * CHUNK)
                lv = _lufs(z)
                if lv > ABS_GATE:
                    b = _bin(lv)
                    hn[b] += 1.0
                    he[b] += z
                edge = _knife_edge(lv, z)
                if edge is not None:
                    edges.append(edge)
        integrated.append(_readings(_integrated, *hists[4]))
        lra.append(_readings(_lra, *hists[30]))
    closed = ((np.asarray(hops) + 1) * BLOCK) // CHUNK

    def padded(rows):
        k = max(len(rows[i]) for i in closed)
        return np.array([rows[i] + [np.nan] * (k - len(rows[i])) for i in closed])

    return padded(integrated), padded(lra)


def gaps(got: dict, want: dict) -> dict:
    """The largest absolute gap of each compared number, over every hop,
    stream and channel that both hold; for a gated number whose ``*_ties``
    ``want`` holds, the gap to the nearest of its readings."""
    out = {}
    for number, fields in NUMBERS.items():
        worst = 0.0
        for f in fields:
            if f in got:
                g = np.asarray(got[f], np.float64)
                if f"{f}_ties" in want:
                    ties = np.asarray(want[f"{f}_ties"], np.float64)
                    d = np.where(np.isnan(ties), np.inf, np.abs(g[..., None] - ties)).min(axis=-1)
                else:
                    d = np.abs(g - np.asarray(want[f], np.float64))
                worst = max(worst, _largest(d))
        out[number] = worst
    return out


def _largest(d) -> float:
    """The largest of ``d``; infinite where any is NaN (a NaN fails)."""
    if not d.size:
        return 0.0
    return math.inf if np.isnan(d).any() else float(np.max(d))
