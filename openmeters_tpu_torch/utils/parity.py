"""Bars for holding one implementation against another: a kernel against
its plain version, the card against the CPU, or the port against the JAX
package.  First the reassigned spectrogram's, then the oscilloscope's,
then the spectrum's, the stereometer's and the waveform's, then a whole
engine hop's, a server's fetched meters, the CLI's ``analyze`` output and
the images that ``render`` draws.

Reassigned spectrogram columns.

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
against the JAX package on the CPU reached 8.2e-3 hop within 50 dB and
1.5e-2 hop within 60 dB while the port's CPU hop ran in f32; the time bar
there is 0.015 hop within 50 dB and 0.03 hop from 50 to 60 dB.  The card
against that f32 CPU hop crossed it (1.29 of the bar, a served tone over 57
hops); the CPU hop now runs in float64 (1.9e-3 and 4.3e-3 against the JAX
package, 0.76 of the bar card against CPU on the same run).

The drift has a tail that no f32 hop holds.  Free-running over 640 hops
(20 re-anchor periods) of 256 streams of tones, tones with noise and tones
with level steps (chip_smoke.py phase 24a, NVIDIA H100 80GB HBM3, 700 W),
against the CPU's float64 hop: the card (B2) reads at most 3.08 of the bar
within 50 dB and 4.40 at 50-60 dB, 310 of 1.98e8 held bins over 1.0, the
99.9th percentile 0.069; the f32 plain hop on the card reads 8.58 and
11.79, 1,230 bins over 1.0, the 99.9th percentile 0.134.  On the CPU
(tests/test_torch_longrun.py, six of those streams) the f32 plain hop
reads 1.27, 21 bins over.  The bins over lie 45 to 59 dB down, mostly 15
to 31 hops after a re-anchor, on streams whose level steps; where B sits
near a zero the reassigned time falls outside the window (hundreds of
hops) and moves by tenths of a hop.  So a free-running run is held as
B2's one-hop corrections are (``check_near_reference``): within the bar, or
within ``REFERENCE_MULTIPLE`` (1.5) times the f32 plain version's own
distance from the float64 run, in each band and for the frequency, power
and time at the peak (card 0.433 Hz, 9.25e-4, 3.59e-4 hop; the f32 plain
hop 0.463 Hz, 2.67e-3, 3.43e-4 hop).  ``DRIFT_TIME_HOPS`` is unchanged.
Before the re-anchor took the hop's own delta products out of its carry
substitution (``ops/sliding_reassigned.py``), the card's frequency read
0.570 Hz, 1.28 times the f32 plain hop's.

Oscilloscope.  The correlation search (``ops/corr.py``): dots within 5e-6
of the row set's largest |dots|, sx, sxx and wmean within 1e-5 of
max(|ref|, 1) (the JAX package's bars for its kernel,
tests/test_pallas_corr.py:41,146).  The analyzer, hop by hop: ``locked``,
``trace_valid``, ``has_period`` and ``missed`` equal; ``period`` and
``span`` within 1e-4 relative; the capture position ``start + frac``
within 0.01 sample, and ``start`` within one sample; ``reference`` and the
probe spectrum within 1e-4 of their row's largest magnitude; ``samples``
equal, shifted by one sample where ``start`` moved by one.

The position is the parabolic refinement of the correlation peak, ``0.5
(y0 - y2) / (y0 - 2 y1 + y2)``: at 110 Hz and 48 kHz the peak's curvature
is ~2e-4 of its height, so a difference of a few 1e-7 in the f32 scores
moves it by thousandths of a sample.  Right paths part by up to 2.17e-3
sample (the port against the JAX package on the CPU, the largest
``position_gap`` that tests/test_torch_oscilloscope.py records) and 1.34e-3
(the card against the CPU).  Wrong score paths part by more: f32 dots
rounded to bf16, or the anchor shift off by one, move it by 0.68 to 1.7
samples; dropping the template-mean term by 0.016 at the least.  The bar
is 0.01 sample at 48 kHz.  It scales as the square of the sample rate: the
curvature per sample squared falls so, and the card against the CPU at
192 kHz parts by 0.0205 sample, 15 times the 48 kHz gap.  Where the
position sits within the bar of a whole sample, the refinement's borrow
(``frac < 0`` moves ``start`` back one) can fall on either side, so
``start`` may differ by one where the positions agree; ``samples`` then
agree shifted by that sample.
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


def reassigned_errors(ours, ref, valid, *, drift: bool, window_hops: float | None = None):
    """Largest errors of ``ours`` against ``ref``, each ``(freq_hz,
    time_offset, power)`` tensors ``[..., bins]``, at the held bins: valid
    (``valid`` ``[...]`` bool) and within 60 dB of their column's peak.

    With ``window_hops`` (the window's length in hops) the time is held
    only where ``ref``'s time offset lies within the window, in ``[-window_hops,
    0]``; ``errors["outside"]`` counts the held bins whose time is not, and
    ``errors["time_outside_hops"]`` is their largest time error.

    Returns ``(errors, held)``; ``errors["time_over_bar"]`` is the largest
    time error as a share of its bar."""
    of, ot, op = (x.double() for x in ours)
    rf, rt, rp = (x.double().to(of.device) for x in ref)
    valid = valid.to(of.device)
    peak = rp.amax(-1, keepdim=True)
    held = valid[..., None] & (rp >= RESOLVED_POWER * peak)
    dt = (ot - rt).abs()
    outside = torch.zeros_like(held)
    if window_hops is not None:
        outside = held & ((rt < -window_hops) | (rt > 0.0))
    if drift:
        bar = torch.full_like(dt, DRIFT_TIME_HOPS[1])
        bar = bar.masked_fill(rp >= DRIFT_SPLIT_POWER * peak, DRIFT_TIME_HOPS[0])
    else:
        bar = torch.full_like(dt, TIME_HOPS)

    def held_max(x):
        return float(torch.where(held, x, torch.zeros_like(x)).max()) if bool(held.any()) else 0.0

    at_peak = dt.gather(-1, rp.argmax(-1, keepdim=True))[..., 0]
    inside = torch.where(outside, 0.0, dt)
    errors = {
        "freq_hz": held_max((of - rf).abs()),
        "time_hops": held_max(inside),
        "time_over_bar": held_max(inside / bar),
        "power_rel": held_max((op - rp).abs() / rp.clamp_min(1e-30)),
        "time_at_peak": float(torch.where(valid, at_peak, torch.zeros_like(at_peak)).max()),
        "power_abs_all": float((op - rp).abs().max()),
    }
    if window_hops is not None:
        errors["outside"] = int(outside.sum())
        errors["time_outside_hops"] = held_max(torch.where(outside, dt, 0.0))
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


class DriftTally:
    """The reassigned time error of one free-running run against another,
    tallied over many hops at the held bins (valid, within 60 dB of their
    column's peak power) as a multiple of its drift bar
    (``DRIFT_TIME_HOPS``), by band (within 50 dB; 50-60 dB): the largest
    error in hops, the number of held bins, a histogram of the ratio
    (``HIST_BINS`` bins over ``[0, HIST_TOP)``, the last one open) for its
    percentiles, and each bin over 1.0 as ``(stream, hop, column, bin, dB
    below the column's peak, hops since the last re-anchor, the reference's
    time offset in hops, ratio)``."""

    HIST_BINS = 40_000
    HIST_TOP = 4.0

    def __init__(self):
        self.max_hops = [0.0, 0.0]
        self.held = [0, 0]
        self.hist = torch.zeros((2, self.HIST_BINS), dtype=torch.float64)
        self.over: list[tuple] = []

    def add(self, hop: int, since_anchor: int, ours_time, ref_time, ref_power, valid) -> None:
        """One hop's columns: ``ours_time``, ``ref_time``, ``ref_power``
        ``[S, cols, bins]`` and ``valid [S, cols]`` (any device)."""
        ot, rt, rp = (x.double() for x in (ours_time, ref_time, ref_power))
        rt, rp, valid = rt.to(ot.device), rp.to(ot.device), valid.to(ot.device)
        peak = rp.amax(-1, keepdim=True)
        held = valid[..., None] & (rp >= RESOLVED_POWER * peak)
        near = rp >= DRIFT_SPLIT_POWER * peak
        dt = torch.where(held, (ot - rt).abs(), 0.0)
        ratio = dt / torch.where(near, DRIFT_TIME_HOPS[0], DRIFT_TIME_HOPS[1])
        for band, mask in enumerate((near, ~near)):
            self.max_hops[band] = max(self.max_hops[band], float(torch.where(mask, dt, 0.0).max()))
            self.held[band] += int((held & mask).sum())
            r = ratio[held & mask].clamp_max(self.HIST_TOP * (1 - 1e-9))
            self.hist[band] += torch.histc(r, self.HIST_BINS, 0.0, self.HIST_TOP).double().cpu()
        for s, k, b in torch.nonzero(held & (ratio > 1.0)).tolist():
            db = 10.0 * torch.log10(peak[s, k, 0] / rp[s, k, b].clamp_min(1e-300))
            self.over.append((s, hop, k, b, float(db), since_anchor, float(rt[s, k, b]), float(ratio[s, k, b])))

    def percentile(self, q: float, band: int | None = None) -> float:
        """The ratio below which ``q`` of the held bins (of ``band``, or
        of both) lie: the upper edge of its histogram bin."""
        hist = self.hist.sum(0) if band is None else self.hist[band]
        cum = torch.cumsum(hist, 0)
        i = int(torch.searchsorted(cum, q * float(cum[-1])))
        return (i + 1) * self.HIST_TOP / self.HIST_BINS

    def summary(self) -> dict:
        worst = sorted(self.over, key=lambda w: -w[-1])
        over = [sum(1 for w in self.over if (w[4] <= 50.0) == (band == 0)) for band in (0, 1)]
        return {
            "max_ratio": max(self.max_hops[0] / DRIFT_TIME_HOPS[0], self.max_hops[1] / DRIFT_TIME_HOPS[1]),
            "max_hops": list(self.max_hops),
            "max_ratio_bands": [self.max_hops[b] / DRIFT_TIME_HOPS[b] for b in (0, 1)],
            "p999_ratio": self.percentile(0.999),
            "p999_ratio_bands": [self.percentile(0.999, b) for b in (0, 1)],
            "held": list(self.held),
            "over": len(self.over),
            "over_bands": over,
            "worst": worst[:12],
        }


# A side held to the exact value, where the reference path itself (the f32
# plain version, or the port's CPU path) is further from it than a bar: held
# to this multiple of the reference path's own distance (chip_smoke.py phase
# 6's rule for B2's corrections).
REFERENCE_MULTIPLE = 1.5


def check_near_reference(ours: dict, ref: dict, bars: dict, where: str = "") -> dict:
    """Hold each error ``ours[k]`` (against an exact value) to
    ``max(bars[k], REFERENCE_MULTIPLE * ref[k])``, ``ref`` the reference
    path's errors against the same exact value.  Raises
    ``AssertionError``; returns the limits."""
    limits = {k: max(bar, REFERENCE_MULTIPLE * ref[k]) for k, bar in bars.items()}
    for k, limit in limits.items():
        if not ours[k] <= limit:
            raise AssertionError(f"{where}: {k} is {ours[k]} (limit {limit}: the bar {bars[k]}, or "
                                 f"{REFERENCE_MULTIPLE} x the reference path's {ref[k]})")
    return limits


# -- oscilloscope -------------------------------------------------------------

DOTS_REL = 5e-6
SUMS_REL = 1e-5
PERIOD_REL = 1e-4
POSITION_ABS = 1e-2  # samples at 48 kHz (see the module docstring)
POSITION_RATE = 48_000.0


def position_bar(sample_rate: float = POSITION_RATE) -> float:
    """The bar on ``start + frac`` in samples: ``POSITION_ABS`` at 48 kHz,
    scaling as the square of the rate (the peak's curvature per sample
    squared falls so)."""
    return POSITION_ABS * (sample_rate / POSITION_RATE) ** 2
ROW_REL = 1e-4


def corr_errors(ours, ref) -> dict:
    """Errors of ``(dots, sx, sxx, wmean)`` (or ``dots`` alone) against
    ``ref``, each as a share of its bar's scale: dots over max |dots|, the
    sums over max(|ref|, 1)."""
    if isinstance(ours, torch.Tensor):
        ours, ref = (ours,), (ref,)
    out = {}
    for name, a, b in zip(("dots", "sx", "sxx", "wmean"), ours, ref):
        a, b = a.double(), b.double().to(a.device)
        d = float((a - b).abs().max())
        if name == "dots":
            out[name] = d / max(float(b.abs().max()), 1e-30)
        else:
            out[name] = d / max(float(b.abs().max()), 1.0)
        out[name + "_abs"] = d
    return out


def check_corr(errors: dict, where: str = "") -> None:
    """Raise ``AssertionError`` if ``errors`` (from :func:`corr_errors`)
    break a bar."""
    for name, err in errors.items():
        if name.endswith("_abs"):
            continue
        bar = DOTS_REL if name == "dots" else SUMS_REL
        if not err <= bar:
            raise AssertionError(f"{where}: {name} differs by {err} of its scale (bar {bar})")


def _samples_agree(a, b, step):
    """Per trace: capture windows ``a`` and ``b`` (``[..., L]``) equal, or,
    where ``a`` starts ``step`` = +-1 samples after ``b``, equal shifted by
    that sample (or equal as they are: a window clipped at the ring's end
    does not move).  Larger steps count as agreeing: they fail on
    ``start``."""
    same = (a == b).all(-1)
    later = (a[..., :-1] == b[..., 1:]).all(-1)  # a[j] = b[j + 1]
    earlier = (a[..., 1:] == b[..., :-1]).all(-1)
    shifted = torch.where(step == 1, later, torch.where(step == -1, earlier, True))
    return same | ((step != 0) & shifted)


def oscilloscope_errors(ours, ref, ours_state=None, ref_state=None) -> dict:
    """Compare two ``OscilloscopeSnapshot``-like tuples (fields as tensors
    or arrays) and, optionally, two trigger states (dicts with
    ``has_period``, ``missed``, ``reference`` and, where present,
    ``pspec_re``/``pspec_im``).

    Returns the errors: ``mismatch`` lists the fields that differ where
    they must not (``start`` by more than one sample; ``samples`` other
    than by the one-sample shift of their ``start``); ``period``, ``span``
    (relative), ``position`` (``start + frac``, in samples), ``reference``
    and ``pspec`` (share of the row maximum); ``start_moved`` counts the
    captures whose ``start`` differs by one."""

    def t(x):
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)

    mismatch = []
    o = {f: t(getattr(ours, f)).cpu() for f in ours._fields}
    r = {f: t(getattr(ref, f)).cpu() for f in ref._fields}
    for f in ("locked", "trace_valid"):
        if not torch.equal(o[f], r[f]):
            mismatch.append(f)
    step = o["start"].long() - r["start"].long()
    moved = step.abs()
    if bool((moved > 1).any()):
        mismatch.append("start")
    if o["samples"].shape != r["samples"].shape or not bool(_samples_agree(o["samples"], r["samples"], step).all()):
        mismatch.append("samples")

    def rel(f):
        a, b = o[f].double(), r[f].double()
        return float(((a - b).abs() / torch.clamp_min(b.abs(), 1e-30)).max())

    def position(x):
        return x["start"].double() + x["frac"].double()

    errors = {
        "period": rel("period"),
        "span": rel("span"),
        "position": float((position(o) - position(r)).abs().max()),
        "start_moved": int((moved > 0).sum()),
        "reference": 0.0,
        "pspec": 0.0,
    }
    if ours_state is not None:
        s1 = {k: t(v).cpu().double() for k, v in ours_state.items()}
        s2 = {k: t(v).cpu().double() for k, v in ref_state.items()}
        for f in ("has_period", "missed"):
            if not torch.equal(s1[f], s2[f]):
                mismatch.append(f)
        scale = torch.clamp_min(s2["reference"].abs().amax(dim=-1, keepdim=True), 1e-30)
        errors["reference"] = float(((s1["reference"] - s2["reference"]).abs() / scale).max())
        if "pspec_re" in s2:
            mag = torch.hypot(s2["pspec_re"], s2["pspec_im"])
            scale = torch.clamp_min(mag.amax(dim=-1, keepdim=True), 1e-30)
            d = torch.maximum((s1["pspec_re"] - s2["pspec_re"]).abs(), (s1["pspec_im"] - s2["pspec_im"]).abs())
            errors["pspec"] = float((d / scale).max())
    errors["mismatch"] = mismatch
    return errors


def check_oscilloscope(errors: dict, where: str = "", sample_rate: float = POSITION_RATE) -> None:
    """Raise ``AssertionError`` if ``errors`` (from
    :func:`oscilloscope_errors`) break a bar; ``sample_rate`` sets the
    position's (:func:`position_bar`)."""
    for ok, what in (
        (not errors["mismatch"], f"{errors['mismatch']} differ"),
        (errors["period"] <= PERIOD_REL, f"period differs by {errors['period']} relative"),
        (errors["span"] <= PERIOD_REL, f"span differs by {errors['span']} relative"),
        (errors["position"] <= position_bar(sample_rate), f"start + frac differs by {errors['position']}"),
        (errors["reference"] <= ROW_REL, f"reference differs by {errors['reference']} of its row"),
        (errors["pspec"] <= ROW_REL, f"probe spectrum differs by {errors['pspec']} of its row"),
    ):
        if not ok:
            raise AssertionError(f"{where}: {what} (errors {errors})")


# -- spectrum -------------------------------------------------------------------
#
# The averaging state (power) is held at every bin to 1e-5 of its trace's
# peak amplitude, sqrt(power): the -100 dB spectral bar of BASELINE.md.  The
# dB outputs (raw and A-weighted) are held to 0.01 dB at bins within 50 dB
# of their trace's peak.  Readings, port against the JAX package on the CPU
# over 24-100 hops of every path (direct, sliding B1a and B1b, hop > block,
# dual trace, each averaging mode, a reset; ``test_analyzer_matches_jax``
# records them): amplitude up to 7.7e-7 of the peak, dB up to 2.3e-3
# within 50 dB (the held 4096/512 path).  The dB bar is 4.4 times that; the
# amplitude bar itself allows 0.027 dB at 50 dB below the peak, so the dB
# bar is the tighter there.
#
# One decision is discrete: exponential and peak-hold averaging zero a bin
# whose power falls below the state floor (the dB floor less the largest
# A-weighting gain).  A bin that lands within rounding of that floor can be
# zeroed on one side and kept on the other (seen once in 100 hops of the
# dual 16384/128 case, recorded as ``floor_flips``).  Both
# sides' dB outputs read the floor there, so such a bin -- zero on one side,
# within 0.1 % of the state floor on the other -- is counted
# (``floor_flips``) and not held to the amplitude bar.

SPECTRUM_AMPLITUDE = 1e-5
SPECTRUM_DB = 0.01
SPECTRUM_DB_RANGE = 50.0
FLOOR_FLIP_REL = 1e-3


def spectrum_errors(ours_power, ref_power, ours_snap, ref_snap, state_floor: float = 0.0) -> dict:
    """Errors of a spectrum's averaging state ``[S, traces, bins]`` (power)
    and snapshot (``raw_db``, ``weighted_db``, ``updated``) against
    ``ref``'s (powers may be None: snapshots only): ``amplitude`` as a
    share of each trace's peak amplitude,
    ``db`` the largest dB difference at bins within 50 dB of their trace's
    peak, ``floor_flips`` the bins zeroed at the ``state_floor`` on one
    side only; ``mismatch`` lists ``updated`` if it differs."""

    def t(x):
        return (x if isinstance(x, torch.Tensor) else torch.tensor(x)).cpu().double()

    amplitude, flips = 0.0, torch.zeros((), dtype=torch.bool)
    if ours_power is not None:
        po, pr = t(ours_power).clamp_min(0.0), t(ref_power).clamp_min(0.0)
        ao, ar = po.sqrt(), pr.sqrt()
        peak = ar.amax(-1, keepdim=True).clamp_min(1e-30)
        near = state_floor * (1.0 + FLOOR_FLIP_REL)
        flips = ((po == 0) & (pr > 0) & (pr < near)) | ((pr == 0) & (po > 0) & (po < near))
        amplitude = float(torch.where(flips, 0.0, (ao - ar).abs() / peak).max())
    db = 0.0
    for f in ("raw_db", "weighted_db"):
        o, r = t(getattr(ours_snap, f)), t(getattr(ref_snap, f))
        held = r >= r.amax(-1, keepdim=True) - SPECTRUM_DB_RANGE
        db = max(db, float(torch.where(held, (o - r).abs(), 0.0).max()))
    same = torch.equal(t(ours_snap.updated), t(ref_snap.updated))
    return {
        "amplitude": amplitude,
        "db": db,
        "floor_flips": int(flips.sum()),
        "mismatch": [] if same else ["updated"],
    }


def check_spectrum(errors: dict, where: str = "") -> None:
    """Raise ``AssertionError`` if ``errors`` (from
    :func:`spectrum_errors`) break a bar."""
    for ok, what in (
        (not errors["mismatch"], f"{errors['mismatch']} differ"),
        (errors["amplitude"] <= SPECTRUM_AMPLITUDE,
         f"amplitude differs by {errors['amplitude']} of the trace's peak"),
        (errors["db"] <= SPECTRUM_DB, f"dB differs by {errors['db']} within 50 dB of the peak"),
    ):
        if not ok:
            raise AssertionError(f"{where}: {what}")


# -- stereometer and waveform -----------------------------------------------------
#
# Equal, NaN where the other is NaN: the stereometer's points (full band)
# and points_valid, the waveform's min/max (columns and preview) and
# col_valid.  Within a bar, absolute, for audio at full scale 1:
# correlations 1e-4 (reading 7.3e-6: the EMA's block sums and the LR4
# bands' rounding), band points 1e-4 (1.1e-5: the crossover in f32, whose
# low band's poles sit near z = 1), colour 1e-5 (9.3e-7), RMS 0.01 dB
# (3.7e-4 dB), progress 1e-6 (6e-8: one rounding).  The readings are the
# port against the JAX package on the CPU over 40-80 hops with a reset and
# non-finite samples, as ``tests/test_torch_stereo_waveform.py`` records them.

STEREO_WAVE_BARS = {
    "correlations": 1e-4,
    "band_points": 1e-4,
    "col_color": 1e-5,
    "preview_color": 1e-5,
    "col_rms_db": 0.01,
    "preview_rms_db": 0.01,
    "progress": 1e-6,
}


def snapshot_errors(ours, ref) -> dict:
    """Compare two stereometer or waveform snapshots field by field.
    Returns ``{field: largest |difference| where both are finite}`` and
    ``mismatch``: the fields held equal that differ, and any field whose
    non-finite entries differ.  The stereometer's band points (slots 1-3)
    are ``band_points``."""

    def t(x):
        return (x if isinstance(x, torch.Tensor) else torch.tensor(x)).cpu()

    out, mismatch = {}, []
    for f in ref._fields:
        o, r = t(getattr(ours, f)), t(getattr(ref, f))
        if o.shape != r.shape or o.dtype != r.dtype:
            mismatch.append(f)
            continue
        parts = {f: (o, r)}
        if f == "points":
            parts = {"points": (o[:, :1], r[:, :1]), "band_points": (o[:, 1:], r[:, 1:])}
        for name, (a, b) in parts.items():
            if name not in STEREO_WAVE_BARS:
                same = a == b
                if a.is_floating_point():
                    same |= a.isnan() & b.isnan()
                if not bool(same.all()):
                    mismatch.append(name)
                continue
            a, b = a.double(), b.double()
            if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
                mismatch.append(name)
            both = torch.isfinite(a) & torch.isfinite(b)
            out[name] = float(torch.where(both, (a - b).abs(), 0.0).max()) if a.numel() else 0.0
    out["mismatch"] = mismatch
    return out


def check_snapshot(errors: dict, where: str = "") -> None:
    """Raise ``AssertionError`` if ``errors`` (from
    :func:`snapshot_errors`) break a bar."""
    if errors["mismatch"]:
        raise AssertionError(f"{where}: {errors['mismatch']} differ")
    for name, err in errors.items():
        if name != "mismatch" and not err <= STEREO_WAVE_BARS[name]:
            raise AssertionError(f"{where}: {name} differs by {err} (bar {STEREO_WAVE_BARS[name]})")


# -- every analyzer of an engine hop ---------------------------------------------

LOUDNESS_LU = 0.01
TRUE_PEAK_DB = 1e-3
CLASSIC_CODES = 2  # within 60 dB of the column's peak


def check_snapshots(ours: dict, ref: dict, where: str = "") -> dict:
    """Hold one engine hop's snapshots ``{name: snapshot}`` to ``ref``'s,
    each by its analyzer's bars: loudness within 0.01 LU (true peak 1e-3
    dB); classic spectrogram codes within 2 at valid bins within 60 dB of
    their column's peak; the reassigned spectrogram by
    :func:`check_reassigned` with ``drift`` (each side slid its own
    states); the oscilloscope, the spectrum's snapshot, the stereometer and
    the waveform by their checks above.  Raises ``AssertionError``; returns
    the errors by analyzer."""

    def t(x):
        return (x if isinstance(x, torch.Tensor) else torch.tensor(x)).cpu()

    if set(ours) != set(ref):
        raise AssertionError(f"{where}: analyzers {sorted(ours)} != {sorted(ref)}")
    out = {}
    for name, r in ref.items():
        o = ours[name]
        here = f"{where} {name}"
        if name == "loudness":
            err = {}
            for f in r._fields:
                a, b = t(getattr(o, f)).double(), t(getattr(r, f)).double()
                err[f] = float((a - b).abs().max())
                bar = TRUE_PEAK_DB if f == "true_peak_db" else LOUDNESS_LU
                if a.shape != b.shape or not err[f] <= bar:
                    raise AssertionError(f"{here}: {f} differs by {err[f]}")
        elif name == "spectrogram" and type(r).__name__ == "ClassicColumns":
            valid = t(r.valid)
            if not torch.equal(t(o.valid), valid):
                raise AssertionError(f"{here}: valid differs")
            a, b = t(o.codes).to(torch.int64), t(r.codes).to(torch.int64)
            held = valid[..., None] & (b >= b.amax(-1, keepdim=True) - round(60.0 * 65535 / 156))
            err = {"codes": int(((a - b).abs() * held).max())}
            if err["codes"] > CLASSIC_CODES:
                raise AssertionError(f"{here}: codes differ by {err['codes']}")
        elif name == "spectrogram":
            valid = t(r.valid)
            if not torch.equal(t(o.valid), valid):
                raise AssertionError(f"{here}: valid differs")
            err, _ = reassigned_errors(
                tuple(t(getattr(o, f)) for f in ("freq_hz", "time_offset", "power")),
                tuple(t(getattr(r, f)) for f in ("freq_hz", "time_offset", "power")),
                valid, drift=True,
            )
            check_reassigned(err, here)
        elif name == "oscilloscope":
            err = oscilloscope_errors(o, r)
            check_oscilloscope(err, here)
        elif name == "spectrum":
            err = spectrum_errors(None, None, o, r)
            check_spectrum(err, here)
        else:
            err = snapshot_errors(o, r)
            check_snapshot(err, here)
        out[name] = err
    return out


# -- a server's fetched meters ----------------------------------------------------

# the snapshot fields that are bool before the fetch packs them into f32
_BOOL_FIELDS = {"valid", "point_valid", "locked", "trace_valid", "updated", "points_valid", "col_valid"}


def _snapshot_classes() -> dict:
    from openmeters_tpu_torch.analyzers.loudness import LoudnessSnapshot
    from openmeters_tpu_torch.analyzers.oscilloscope import OscilloscopeSnapshot
    from openmeters_tpu_torch.analyzers.spectrogram import ClassicColumns, ReassignedColumns
    from openmeters_tpu_torch.analyzers.spectrum import SpectrumSnapshot
    from openmeters_tpu_torch.analyzers.stereometer import StereometerSnapshot
    from openmeters_tpu_torch.analyzers.waveform import WaveformSnapshot

    return {
        "loudness": (LoudnessSnapshot,), "spectrogram": (ClassicColumns, ReassignedColumns),
        "spectrum": (SpectrumSnapshot,), "oscilloscope": (OscilloscopeSnapshot,),
        "stereometer": (StereometerSnapshot,), "waveform": (WaveformSnapshot,),
    }


def meters_to_snapshots(meters: dict) -> dict:
    """A server's ``last_meters()`` (``{"['loudness'].momentary_lufs":
    array}``) as ``{analyzer: snapshot}``, the bool fields bool again.  An
    analyzer whose every field was fetched comes back as its snapshot class;
    one with some fields only (``fetch="meters"``) as a named tuple of
    those."""
    import collections

    groups: dict = {}
    for key, value in meters.items():
        name, field = key[2:].split("']", 1)
        value = value if isinstance(value, torch.Tensor) else torch.tensor(value)
        field = field.lstrip(".")
        groups.setdefault(name, {})[field] = value.bool() if field in _BOOL_FIELDS else value
    classes = _snapshot_classes()
    out = {}
    for name, fields in groups.items():
        cls = next((c for c in classes.get(name, ()) if set(c._fields) == set(fields)), None)
        if cls is None:
            cls = collections.namedtuple(f"{name}_meters", list(fields))
        out[name] = cls(**fields)
    return out


def check_meters(ours: dict, ref: dict, where: str = "") -> dict:
    """Hold one server's fetched meters (``last_meters()``) to another's:
    the same keys; each analyzer fetched whole by its bars in
    :func:`check_snapshots`; the fields of one fetched in part (the meters
    of ``fetch="meters"``) by :func:`check_snapshot`'s (a bar where the
    field has one, else equal).  Raises ``AssertionError``; returns the
    errors by analyzer."""
    if set(ours) != set(ref):
        raise AssertionError(f"{where}: meter keys differ: {sorted(set(ours) ^ set(ref))}")
    so, sr = meters_to_snapshots(ours), meters_to_snapshots(ref)
    classes = {c for group in _snapshot_classes().values() for c in group}
    whole = {name for name, snap in sr.items() if type(snap) in classes}
    out = check_snapshots({n: so[n] for n in whole}, {n: sr[n] for n in whole}, where)
    for name in set(sr) - whole:
        err = snapshot_errors(so[name], sr[name])
        check_snapshot(err, f"{where} {name}")
        out[name] = err
    return out


# -- the CLI's ``analyze`` output -------------------------------------------------

# field of ``analyze``'s JSON -> (bar, relative): each analyzer's own bar
ANALYZE_BARS = {
    ("loudness", "short_term_lufs"): (LOUDNESS_LU, False),
    ("loudness", "momentary_lufs"): (LOUDNESS_LU, False),
    ("loudness", "true_peak_db"): (TRUE_PEAK_DB, False),
    ("spectrum", "peak_bin_db"): (SPECTRUM_DB, False),
    ("spectrogram", "peak_db"): (SPECTRUM_DB, False),
    ("oscilloscope", "period_samples"): (PERIOD_REL, True),
    ("stereometer", "correlation"): (STEREO_WAVE_BARS["correlations"], False),
}


def check_analyze(ours: dict, ref: dict, where: str = "") -> dict:
    """Hold one ``analyze`` JSON object to another: the same sections and
    fields, ``hops`` and the oscilloscope's ``locked`` equal, every other
    field within its bar in :data:`ANALYZE_BARS`.  Raises
    ``AssertionError``; returns ``{"section.field": difference}``."""
    if set(ours) != set(ref) or any(set(ours[k]) != set(ref[k]) for k in ref if k != "hops"):
        raise AssertionError(f"{where}: fields differ: {ours} against {ref}")
    if ours["hops"] != ref["hops"]:
        raise AssertionError(f"{where}: hops {ours['hops']} != {ref['hops']}")
    if "oscilloscope" in ref and ours["oscilloscope"]["locked"] != ref["oscilloscope"]["locked"]:
        raise AssertionError(f"{where}: oscilloscope locked differs")
    out = {}
    for (section, field), (bar, relative) in ANALYZE_BARS.items():
        if section not in ref:
            continue
        a, b = ours[section][field], ref[section][field]
        err = abs(a - b) / (max(abs(b), 1e-12) if relative else 1.0)
        out[f"{section}.{field}"] = err
        if not err <= bar:
            raise AssertionError(f"{where}: {section}.{field} {a} against {b} (bar {bar}{' relative' if relative else ''})")
    return out


# -- rendered images ---------------------------------------------------------------

# Two renders of one recording from meters computed on two paths (the card
# against the CPU, the port against the JAX package) part where a meter's
# difference moves a drawn feature across a pixel.  A pixel is off where a
# channel differs by more than PIXEL_LEVELS of 255; a pane is held to at
# most PIXEL_SHARE of its pixels off and a mean difference of MEAN_LEVELS.
# Readings (960 x 540 panes, tones over a noise floor 40 dB down): the card
# against the CPU, ``render`` of 3 s under the literal EngineConfig() at 48
# kHz and of EngineConfig.at_rate(44100) (chip_smoke.py phase 22a, NVIDIA
# H100 80GB HBM3, 700 W): 2.18e-4 and 7.1e-5 of the reassigned
# spectrogram's pixels off, mean 0.034 and 0.0096 levels (splats of bins
# far below their column's peak, whose reassignment no bar holds, land a
# row apart); every other pane none off, at most 4 levels, mean <= 0.015.
# The port against the JAX package on the CPU, the same config over 1 s at
# 48 kHz: 1.6e-4 off, mean 0.018; the other panes none off.  The bars sit
# 9x and 7x above the largest readings.  A pane drawn from a signal with
# no noise floor shows the transforms' rounding (-100 to -140 dB) in the
# reassigned splats, which parts two f32 paths: tests/test_render.py's
# pure 440 Hz tone (8 kHz, 256/64, 120 x 80), the port against the JAX
# package, 3.6e-2 of the reassigned pane's pixels off, mean 1.02 levels;
# the classic pane none off.  With the points below SPLAT_FLOOR_DB of
# their column's peak left out of both (``point_valid`` cleared), none
# off; at -110 dB 5.2e-4, at -120 dB 1.2e-2
# (tests/test_torch_render.py::test_render_series_pure_tone_within_pixel_bar_of_jax
# records each pane's reading).
PIXEL_LEVELS = 8
PIXEL_SHARE = 2e-3
MEAN_LEVELS = 0.25
SPLAT_FLOOR_DB = -100.0


def image_errors(ours, ref) -> dict:
    """``{"off_share", "mean_levels", "max_levels"}`` of one u8 image
    ``[h, w, c]`` against another of the same shape (``ValueError`` if the
    shapes differ)."""
    import numpy as np

    a, b = np.asarray(ours), np.asarray(ref)
    if a.shape != b.shape:
        raise ValueError(f"image shapes differ: {a.shape} against {b.shape}")
    d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
    return {
        "off_share": float((d > PIXEL_LEVELS).mean()),
        "mean_levels": float(d.mean()),
        "max_levels": int(d.max()),
    }


def check_image(errors: dict, where: str = "") -> None:
    """Raise ``AssertionError`` if ``errors`` (from :func:`image_errors`)
    break the pixel bar."""
    if not errors["off_share"] <= PIXEL_SHARE:
        raise AssertionError(f"{where}: {errors['off_share']} of the pixels off by more than "
                             f"{PIXEL_LEVELS} levels (bar {PIXEL_SHARE})")
    if not errors["mean_levels"] <= MEAN_LEVELS:
        raise AssertionError(f"{where}: mean difference {errors['mean_levels']} levels (bar {MEAN_LEVELS})")
