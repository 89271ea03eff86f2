"""Headless view-state math: the numeric half of the reference's view models
(port of ``views.py``; plain numpy, as there).

The reference splits each visual into processor (DSP) -> state (view model)
-> render (wgpu).  The GUI/GPU halves are out of scope for the rebuild
(BASELINE), but their *parameters and math* shape the headless API so
downstream renderers can be built on top (SURVEY §2.12-2.13).  This module
provides those numerics:

- peak-hold ballistics (loudness/state.rs:36-60: 2 s hold, 60 dB/s decay)
- snapshot persistence blending (oscilloscope/state.rs:13,52-77)
- min/max line decimation (render/common.rs:306-383)
- 5-stop gradient palettes with positions + spreads
  (shaders/spectrogram.wgsl:77-98, persistence/palette.rs:37-84)
- stereometer "Scaled" radial compression (stereometer/render.rs:21-62)
- spectrogram history column retention ring (spectrogram/state.rs:53-175)

Everything is plain numpy (host-side, render-prep rate, not hop rate).
"""

from __future__ import annotations

import dataclasses

import numpy as np

PEAK_HOLD_SECONDS = 2.0  # loudness/state.rs:21
PEAK_DECAY_DB_PER_SEC = 60.0  # loudness/state.rs:22
MAX_PERSISTENCE = 0.98  # oscilloscope/state.rs:13


@dataclasses.dataclass
class PeakHold:
    """Vectorized peak-hold with hold window + linear dB decay.

    Matches reference ``PeakHold::update`` (loudness/state.rs:41-60): a new
    maximum re-arms the hold; after ``hold`` seconds the value decays at
    ``decay_db_per_sec`` but never below the live value.
    """

    db: np.ndarray
    decay_from: np.ndarray  # absolute seconds
    hold: float = PEAK_HOLD_SECONDS
    decay_db_per_sec: float = PEAK_DECAY_DB_PER_SEC

    @staticmethod
    def new(shape, floor_db: float, now: float = 0.0, **kw) -> "PeakHold":
        return PeakHold(
            db=np.full(shape, floor_db, np.float32),
            decay_from=np.full(shape, now, np.float64),
            **kw,
        )

    def update(self, value: np.ndarray, now: float) -> np.ndarray:
        value = np.asarray(value, np.float32)
        rising = value > self.db
        self.decay_from = np.where(rising, now + self.hold, self.decay_from)
        self.db = np.where(rising, value, self.db)
        decaying = ~rising & (now > self.decay_from)
        dt = np.maximum(now - self.decay_from, 0.0)
        decayed = np.maximum(self.db - self.decay_db_per_sec * dt, value)
        self.db = np.where(decaying, decayed.astype(np.float32), self.db)
        self.decay_from = np.where(decaying, now, self.decay_from)
        return self.db


def persistence_blend(previous, current, persistence: float):
    """Oscilloscope trace afterglow: EMA of consecutive snapshots with factor
    clamped to <= 0.98 (oscilloscope/state.rs:13,52-77)."""
    p = min(max(float(persistence), 0.0), MAX_PERSISTENCE)
    if previous is None or previous.shape != np.shape(current):
        return np.asarray(current, np.float32)
    return (previous * p + np.asarray(current, np.float32) * (1.0 - p)).astype(
        np.float32
    )


def decimate_minmax_line(points: np.ndarray, max_points: int) -> np.ndarray:
    """Min/max bucket decimation of an x-ordered finite polyline.

    Functional port of ``decimate_finite_ordered_line_in_place``
    (render/common.rs:306-383): splits the x-range into ``max_points/2``
    buckets (at most one per unit x), keeps each bucket's min/max in x-order,
    collapses narrow buckets to vertical segments, dedupes repeats.
    """
    pts = np.asarray(points, np.float32)
    if max_points < 2:
        return pts[:max_points]
    if len(pts) <= 1:
        return pts
    x0, x_last = float(pts[0, 0]), float(pts[-1, 0])
    width = x_last - x0
    bucketed = np.isfinite(width) and width > 0.0
    buckets = min(max_points // 2, max(int(np.ceil(width)), 1)) if bucketed else 1
    out: list[tuple[float, float]] = []

    def push(pt):
        if not out or out[-1] != pt:
            out.append(pt)

    read, groups = 0, 0
    n = len(pts)
    bucket_width = width / buckets if bucketed else 0.0
    scale = buckets / width if bucketed else 0.0
    while read < n:
        start = read
        if bucketed:
            b = int(np.clip((pts[start, 0] - x0) * scale, 0, buckets - 1))
        else:
            b = 0
        groups += 1
        end_x = x0 + bucket_width * (b + 1) if (bucketed and groups < buckets) else np.inf
        mn = mx = start
        read = start + 1
        while read < n and pts[read, 0] <= end_x:
            if pts[read, 1] < pts[mn, 1]:
                mn = read
            if pts[read, 1] > pts[mx, 1]:
                mx = read
            read += 1
        if pts[read - 1, 0] - pts[start, 0] <= 1.0:
            x = (float(pts[start, 0]) + float(pts[read - 1, 0])) * 0.5
            push((x, float(pts[mn, 1])))
            push((x, float(pts[mx, 1])))
        else:
            for i in (min(mn, mx), max(mn, mx)):
                push((float(pts[i, 0]), float(pts[i, 1])))
    return np.asarray(out, np.float32)


def sanitize_stop_spreads(spreads, count: int) -> np.ndarray:
    """Per-stop spread exponents, defaulting to 1.0 (persistence/palette.rs)."""
    out = np.ones(count, np.float32)
    if spreads is not None:
        s = np.asarray(spreads, np.float32)
        m = min(len(s), count)
        valid = np.isfinite(s[:m]) & (s[:m] > 0.0)
        out[:m] = np.where(valid, s[:m], 1.0)
    return out


@dataclasses.dataclass(frozen=True)
class GradientPalette:
    """N-stop gradient with interior positions and per-stop spreads.

    ``evaluate(t)`` matches the spectrogram resolve shader
    (spectrogram.wgsl:77-98): find the segment, normalize, and blend with
    exponent ``left_spread / right_spread`` when spreads differ from 1.
    """

    colors: np.ndarray  # [N, 4] rgba in [0,1]
    positions: np.ndarray  # [N] increasing, first 0, last 1
    spreads: np.ndarray  # [N]

    @staticmethod
    def make(colors, positions=None, spreads=None) -> "GradientPalette":
        colors = np.asarray(colors, np.float32)
        n = len(colors)
        if positions is None:
            positions = np.linspace(0.0, 1.0, n)
        return GradientPalette(
            colors=colors,
            positions=np.asarray(positions, np.float32),
            spreads=sanitize_stop_spreads(spreads, n),
        )

    def evaluate(self, t) -> np.ndarray:
        t = np.clip(np.asarray(t, np.float32), 0.0, 1.0)
        seg = np.clip(
            np.searchsorted(self.positions, t, side="left") - 1,
            0,
            len(self.colors) - 2,
        )
        lo = self.positions[seg]
        hi = self.positions[seg + 1]
        lin = np.clip((t - lo) / np.maximum(hi - lo, 1e-6), 0.0, 1.0)
        sl = self.spreads[seg]
        sr = self.spreads[seg + 1]
        plain = (np.abs(sl - 1.0) < 1e-4) & (np.abs(sr - 1.0) < 1e-4)
        blend = np.where(plain, lin, np.clip(lin ** (sl / np.maximum(sr, 1e-6)), 0, 1))
        return (
            self.colors[seg] * (1.0 - blend[..., None])
            + self.colors[seg + 1] * blend[..., None]
        ).astype(np.float32)


# The built-in spectrogram heat ramp (palettes.rs:10-16).
HEAT_RAMP = GradientPalette.make(
    [
        [0.0, 0.0, 0.0, 0.0],
        [0x38 / 255, 0.0, 0xAD / 255, 1.0],
        [1.0, 0.0, 0.0, 1.0],
        [1.0, 1.0, 0x21 / 255, 1.0],
        [1.0, 1.0, 1.0, 1.0],
    ]
)


def stereometer_scaled_compression(x, y):
    """The "Scaled" stereometer display mapping: radial compression
    ``p * 0.886 * r^-0.7`` matched in sdf.wgsl:46-54
    (stereometer/render.rs:21-62)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    r = np.sqrt(x * x + y * y)
    gain = np.where(r > 1e-9, 0.886 * np.power(np.maximum(r, 1e-9), -0.7), 0.0)
    scale = np.minimum(gain, 1.0 / np.maximum(r, 1e-9))  # clamp inside unit box
    return x * scale, y * scale


WAVEFORM_SCROLL_TIMEOUT = 0.1  # waveform/state.rs:19 (SCROLL_CLOCK_TIMEOUT)


@dataclasses.dataclass
class WaveformScrollClock:
    """Wall-clock scroll interpolation (waveform/state.rs:92-105): between
    snapshots the partial-column progress advances by elapsed wall time x
    scroll rate so the waveform glides instead of stepping per hop; when the
    clock is stale (no frame or no snapshot within 100 ms) it snaps back to
    the processor's preview progress.  Clamped to [0, 1] like the
    reference."""

    last_time: float = 0.0
    offset: float = 0.0
    snapshot_at: float = 0.0

    def mark_snapshot(self, now: float) -> None:
        self.snapshot_at = now

    def progress(
        self, now: float, preview_progress: float, columns_per_sec: float
    ) -> float:
        elapsed = max(now - self.last_time, 0.0)
        fresh = (
            elapsed <= WAVEFORM_SCROLL_TIMEOUT
            and (now - self.snapshot_at) <= WAVEFORM_SCROLL_TIMEOUT
        )
        if fresh:
            off = self.offset + elapsed * max(columns_per_sec, 0.0)
        else:
            off = float(preview_progress)
        off = min(max(off, 0.0), 1.0)
        self.last_time, self.offset = now, off
        return off


CORR_TRAIL_LEN = 32  # stereometer/render.rs:38


class CorrelationTrail:
    """The reference's ``FixedTrail`` (stereometer/render.rs:63-76): a
    fixed-capacity recency trail of correlation values, newest first.
    ``segment_opacities`` is the draw-side fade curve
    ``(1 - (age+1)/len)^2.4`` applied to the segment between values
    ``age`` and ``age+1`` (stereometer/render.rs:42-44,411-416)."""

    def __init__(self, cap: int = CORR_TRAIL_LEN):
        self.cap = int(cap)
        self.values = np.zeros(0, np.float32)

    def push_front(self, value: float) -> None:
        self.values = np.concatenate(
            [np.float32([value]), self.values[: self.cap - 1]]
        )

    def reset(self) -> None:
        self.values = np.zeros(0, np.float32)

    def segment_opacities(self) -> np.ndarray:
        n = len(self.values)
        if n < 2:
            return np.zeros(0, np.float32)
        age = np.arange(n - 1, dtype=np.float32)
        return ((1.0 - (age + 1.0) / n) ** 2.4).astype(np.float32)


def correlation_trail_alpha(
    trail: CorrelationTrail, height: int, edge: float = 6.0
):
    """Per-pixel-row alpha column for the correlation side meter
    (stereometer/render.rs:398-431): each trail segment [v_age, v_age+1]
    covers the pixel rows between its endpoints (+2 px pad) at its fade
    opacity, rows keep the MAX opacity across segments; returns
    ``(alpha [height], marker_y or None)``.  ``val_y`` maps +1 to the top
    inset and -1 to the bottom inset (CORR_EDGE=6, render.rs:40)."""
    alpha = np.zeros(int(height), np.float32)
    v = trail.values
    if len(v) == 0:
        return alpha, None

    def val_y(val: float) -> float:
        return edge + (1.0 - float(val)) * 0.5 * (height - 2.0 * edge)

    ops = trail.segment_opacities()
    for age, op in enumerate(ops):
        y0, y1 = val_y(v[age]), val_y(v[age + 1])
        top = max(int(min(y0, y1)), 0)
        bottom = min(int(max(y0, y1) + 2.0), int(height) - 1)
        if bottom >= top:
            alpha[top : bottom + 1] = np.maximum(alpha[top : bottom + 1], op)
    return alpha, val_y(v[0])


def reassigned_accumulate(
    freq_hz: np.ndarray,
    time_offset: np.ndarray,
    power: np.ndarray,
    point_valid: np.ndarray,
    *,
    time_bins: int,
    freq_lo_hz: float,
    freq_hi_hz: float,
    freq_bins: int,
    scale=None,
    time_origin: float = 0.0,
    power_scale: float = 1.0,
) -> np.ndarray:
    """Accumulate reassigned (t, f, power) splats into a dense image.

    The headless analogue of the GPU splat pass (spectrogram/render.rs:93-158,
    spectrogram.wgsl:216-225): points are additively deposited into a
    ``[time_bins, freq_bins]`` power image with nearest-bin splatting on the
    chosen frequency scale; power conservation holds (sum of image =
    ``power_scale`` * sum of deposited powers).  Feed the result through
    ``power -> dB -> GradientPalette.evaluate`` for the rendered picture.

    ``time_offset`` is in hops relative to each point's column;
    ``time_origin`` shifts columns into image coordinates.
    """
    from openmeters_tpu_torch.utils.frequency import FrequencyScale

    scale = scale or FrequencyScale.LOGARITHMIC
    f = np.asarray(freq_hz, np.float32).ravel()
    t = np.asarray(time_offset, np.float32).ravel() + time_origin
    p = np.asarray(power, np.float32).ravel() * power_scale
    m = np.asarray(point_valid, bool).ravel()

    img = np.zeros((time_bins, freq_bins), np.float32)
    if not m.any():
        return img
    f, t, p = f[m], t[m], p[m]
    fx = scale.pos_of(freq_lo_hz, freq_hi_hz, f)
    fi = np.clip((fx * freq_bins).astype(np.int64), 0, freq_bins - 1)
    ti = np.clip(np.round(t).astype(np.int64), 0, time_bins - 1)
    np.add.at(img, (ti, fi), p)
    return img


def resample_trace(window: np.ndarray, span: float, frac: float = 0.0,
                   max_points: int = 4096) -> np.ndarray:
    """Oscilloscope ``downsample_trace`` (oscilloscope/processor.rs:788-803):
    linearly resample a captured window to ``clamp(round(span)+1, 2,
    max_points)`` points starting at fractional offset ``frac``.

    The device snapshot ships the raw capture window; this render-side helper
    produces exactly the reference's resampled trace.
    """
    data = np.asarray(window, np.float32)
    if data.ndim > 1:
        return np.stack([resample_trace(d, span, frac, max_points) for d in data])
    if len(data) < 2:
        return np.zeros(0, np.float32)
    target = int(np.clip(round(span) + 1, 2, max_points))
    last = len(data) - 1.0
    frac = float(np.clip(frac, 0.0, last))
    span = min(float(span), last - frac)
    if not (np.isfinite(span) and span > 0):
        return np.zeros(0, np.float32)
    pos = frac + np.arange(target) * (span / (target - 1))
    i0 = np.clip(pos.astype(np.int64), 0, len(data) - 1)
    i1 = np.clip(i0 + 1, 0, len(data) - 1)
    t = (pos - i0).astype(np.float32)
    out = data[i0] * (1 - t) + data[i1] * t
    return np.where((pos >= 0) & (pos <= last), out, 0.0).astype(np.float32)


class WaveformHistory:
    """Host-side waveform column ring (waveform/state.rs + processor's
    ``max_columns`` retention, processor.rs:11,189-197,291-296): keeps the
    newest ``max_columns`` (min, max, color, rms) column records per stream
    for scroll rendering; resizing keeps the newest suffix."""

    MAX_COLUMN_CAPACITY = 8192  # reference processor.rs:11

    def __init__(self, max_columns: int = MAX_COLUMN_CAPACITY):
        self.max_columns = min(max(max_columns, 1), self.MAX_COLUMN_CAPACITY)
        self.columns: list[dict] = []

    def push_snapshot(self, snapshot, stream: int = 0) -> int:
        """Append the valid columns of one WaveformSnapshot; returns count."""
        valid = np.asarray(snapshot.col_valid)[stream]
        count = 0
        for k in np.nonzero(valid)[0]:
            self.columns.append(
                {
                    "min": np.asarray(snapshot.col_min)[stream, k],
                    "max": np.asarray(snapshot.col_max)[stream, k],
                    "color": np.asarray(snapshot.col_color)[stream, k],
                    "rms_db": np.asarray(snapshot.col_rms_db)[stream, k],
                }
            )
            count += 1
        if len(self.columns) > self.max_columns:
            del self.columns[: len(self.columns) - self.max_columns]
        return count

    def push_columns(self, cols: list[dict]) -> None:
        """Append pre-extracted column records (the drained-fetch path)."""
        self.columns.extend(cols)
        if len(self.columns) > self.max_columns:
            del self.columns[: len(self.columns) - self.max_columns]

    def resize(self, max_columns: int) -> None:
        self.max_columns = min(max(max_columns, 1), self.MAX_COLUMN_CAPACITY)
        if len(self.columns) > self.max_columns:
            del self.columns[: len(self.columns) - self.max_columns]


def waveform_columns_from_meters(meters: dict, stream: int) -> list[dict]:
    """Extract one stream's valid waveform column records from a drained
    ``MeterServer.last_meters()`` dict (``fetch='full'`` mode)."""

    def find(part):
        return next(
            (k for k in meters if "waveform" in k and part in k), None
        )

    keys = {p: find(p) for p in ("col_valid", "col_min", "col_max",
                                 "col_color", "col_rms_db")}
    # fetch='meters' packs the valid mask but drops the bulk column leaves —
    # there is nothing to extract until the server runs in 'full' mode
    if keys["col_valid"] is None or keys["col_min"] is None or keys["col_max"] is None:
        return []
    valid = np.asarray(meters[keys["col_valid"]])[stream].astype(bool)
    out = []
    for k in np.nonzero(valid)[0]:
        rec = {"min": np.asarray(meters[keys["col_min"]])[stream, k],
               "max": np.asarray(meters[keys["col_max"]])[stream, k]}
        if keys["col_color"]:
            rec["color"] = np.asarray(meters[keys["col_color"]])[stream, k]
        if keys["col_rms_db"]:
            rec["rms_db"] = np.asarray(meters[keys["col_rms_db"]])[stream, k]
        out.append(rec)
    return out


class SpectrogramHistory:
    """Host-side column ring mirror (spectrogram/state.rs:53-175): retains the
    most recent ``columns`` packed-u16 classic columns for renderers, resizing
    by keeping the newest suffix."""

    def __init__(self, bins: int, columns: int):
        self.bins = bins
        self.columns = columns
        self.data = np.zeros((columns, bins), np.uint16)
        self.filled = 0

    def push(self, cols: np.ndarray) -> None:
        cols = np.atleast_2d(cols)
        k = len(cols)
        if k >= self.columns:
            self.data[:] = cols[-self.columns :]
            self.filled = self.columns
            return
        self.data = np.roll(self.data, -k, axis=0)
        self.data[-k:] = cols
        self.filled = min(self.filled + k, self.columns)

    def resize(self, columns: int) -> None:
        if columns == self.columns:
            return
        new = np.zeros((columns, self.bins), np.uint16)
        keep = min(self.filled, columns)
        if keep:
            new[-keep:] = self.data[len(self.data) - keep :]
        self.data = new
        self.columns = columns
        self.filled = keep

    def view(self) -> np.ndarray:
        """Newest-last [filled, bins] view."""
        return self.data[len(self.data) - self.filled :]


# --- spectrum display mapping (spectrum/state.rs) ---------------------------

SPECTRUM_MIN_FREQUENCY = 20.0  # spectrum/state.rs:21
SPECTRUM_MAX_DB = 0.0  # spectrum/state.rs:22
_EPS = 1e-6


def fmt_freq(f: float) -> str:
    """Reference util/audio/format.rs:4-11."""
    if f >= 10_000.0:
        return f"{f / 1000.0:.1f}kHz"
    if f >= 1_000.0:
        return f"{f / 1000.0:.2f}kHz"
    if f >= 100.0:
        return f"{f:.1f}Hz"
    return f"{f:.2f}Hz"


def spectrum_value_at(bins: np.ndarray, db: np.ndarray, f: float) -> np.ndarray:
    """Linear interpolation of (possibly batched ``[..., NB]``) trace dB at
    frequency ``f`` (spectrum/state.rs:310-319)."""
    bins = np.asarray(bins, np.float32)
    db = np.asarray(db, np.float32)
    i = int(np.searchsorted(bins, f, side="left"))
    if i == 0:
        return db[..., 0]
    if i >= len(bins):
        return db[..., -1]
    t = (f - bins[i - 1]) / max(bins[i] - bins[i - 1], _EPS)
    return db[..., i - 1] * (1.0 - t) + db[..., i] * t


def spectrum_x_cache(
    bins: np.ndarray, scale, min_f: float = SPECTRUM_MIN_FREQUENCY,
    max_f: float | None = None,
):
    """Display x positions for [min_f] + interior bins + [max_f]
    (``ensure_x_cache``, spectrum/state.rs:146-159).

    Returns ``(freqs [P], x [P], interior_index [P])`` where interior_index
    is the source bin index (endpoints use interpolation via
    :func:`spectrum_value_at`, marked -1).
    """
    bins = np.asarray(bins, np.float32)
    if max_f is None:
        max_f = float(max(bins[-1], min_f * 1.02))
    inside = (bins > min_f) & (bins < max_f)
    freqs = np.concatenate([[min_f], bins[inside], [max_f]]).astype(np.float32)
    idx = np.concatenate(
        [[-1], np.nonzero(inside)[0].astype(np.int64), [-1]]
    )
    x = np.clip(scale.pos_of(min_f, max_f, freqs), 0.0, 1.0)
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    return freqs, x, idx


def spectrum_points(
    db: np.ndarray, bins: np.ndarray, scale, floor_db: float,
    min_f: float = SPECTRUM_MIN_FREQUENCY, max_f: float | None = None,
    reverse: bool = False,
):
    """Normalized trace points (``build_single_points_into``,
    spectrum/state.rs:433-464), batched: ``db [..., NB]`` ->
    ``(points [..., P, 2], valid [..., P])``.  Non-finite magnitudes are
    masked out rather than dropped (fixed shapes)."""
    bins = np.asarray(bins, np.float32)
    db = np.asarray(db, np.float32)
    if max_f is None:
        max_f = float(max(bins[-1], min_f * 1.02))
    freqs, x, idx = spectrum_x_cache(bins, scale, min_f, max_f)
    lead = db.shape[:-1]
    mags = np.empty((*lead, len(freqs)), np.float32)
    mags[..., 0] = spectrum_value_at(bins, db, min_f)
    mags[..., -1] = spectrum_value_at(bins, db, max_f)
    if len(freqs) > 2:
        mags[..., 1:-1] = db[..., idx[1:-1]]
    dr = max(SPECTRUM_MAX_DB - floor_db, _EPS)
    y = (mags - floor_db) / dr
    valid = np.isfinite(y)
    y = np.clip(np.where(valid, y, 0.0), 0.0, 1.0)
    xs = 1.0 - x if reverse else x
    pts = np.stack([np.broadcast_to(xs, y.shape), y], axis=-1).astype(np.float32)
    if reverse:
        pts = pts[..., ::-1, :]
        valid = valid[..., ::-1]
    return pts, valid


def spectrum_rebin_display(
    db: np.ndarray, bins: np.ndarray, scale, n_out: int,
    min_f: float = SPECTRUM_MIN_FREQUENCY, max_f: float | None = None,
    mode: str = "max",
):
    """ERB/log/linear display rebinning (BASELINE config 3): resample
    ``db [..., NB]`` onto ``n_out`` uniform display cells of ``scale``.

    ``mode="sample"`` is a pure batched gather — linear interpolation at
    each cell center exactly like the reference's per-pixel ``value_at``
    sampling; indices/weights depend only on (bins, scale, n_out) and the
    expression works on any array with numpy indexing.

    ``mode="max"`` (default) additionally max-pools every cell over the FFT
    bins whose display position falls inside it, so narrow peaks survive
    coarse cells the way the reference's line rasterization keeps them
    visible; cells narrower than a bin (zoom-in) fall back to the
    interpolated sample.  Host-side numpy (uses ``maximum.reduceat``).
    """
    bins = np.asarray(bins, np.float32)
    if max_f is None:
        max_f = float(max(bins[-1], min_f * 1.02))
    t = (np.arange(n_out, dtype=np.float32) + 0.5) / n_out
    f = np.asarray(scale.freq_at(min_f, max_f, t), np.float32)
    i1 = np.clip(np.searchsorted(bins, f, side="left"), 1, len(bins) - 1)
    i0 = i1 - 1
    w = (f - bins[i0]) / np.maximum(bins[i1] - bins[i0], _EPS)
    w = np.clip(w, 0.0, 1.0).astype(np.float32)
    point = db[..., i0] * (1.0 - w) + db[..., i1] * w
    if mode == "sample":
        return point

    db = np.asarray(db, np.float32)
    xb = np.clip(np.asarray(scale.pos_of(min_f, max_f, bins), np.float32), 0.0, 1.0)
    lo = np.searchsorted(xb, np.arange(n_out, dtype=np.float32) / n_out, "left")
    hi = np.append(lo[1:], len(bins))
    nonempty = hi > lo
    agg = np.maximum.reduceat(db, np.minimum(lo, len(bins) - 1), axis=-1)
    return np.where(nonempty, agg, point)


def spectrum_grid_ticks(
    min_f: float, max_f: float, scale,
) -> list[tuple[float, float, bool, str | None]]:
    """Decade grid ticks (spectrum/state.rs:160-176): every 1..9 x 10^e in
    range; major at x1; labels at x1/x2/x5.  Returns
    ``(freq_hz, x_position, is_major, label)`` tuples."""
    out = []
    lo_e = int(np.floor(np.log10(max(min_f, 1.0))))
    hi_e = int(np.ceil(np.log10(max_f)))
    for e in range(lo_e, hi_e + 1):
        base = 10.0 ** e
        for m in range(1, 10):
            f = base * m
            if not (min_f <= f <= max_f):
                continue
            label = fmt_freq(f) if m in (1, 2, 5) else None
            x = float(np.clip(scale.pos_of(min_f, max_f, f), 0.0, 1.0))
            out.append((f, x, m == 1, label))
    return out


def spectrum_interpolated_peak(bins, db, bin_idx: int):
    """Parabolic peak refinement (spectrum/state.rs:328-356): returns
    ``(freq_hz, level_db)`` or ``None``."""
    bins = np.asarray(bins, np.float32)
    db = np.asarray(db, np.float32)
    if bin_idx <= 0 or bin_idx + 1 >= len(bins) or len(bins) != len(db):
        return None
    bin_hz = float(bins[1] - bins[0])
    center_f, center = float(bins[bin_idx]), float(db[bin_idx])
    if not (bin_hz > 0 and np.isfinite(bin_hz)) or not np.isfinite(center_f) \
            or not np.isfinite(center):
        return None
    left, right = float(db[bin_idx - 1]), float(db[bin_idx + 1])
    offset = 0.0
    if np.isfinite(left) and np.isfinite(right):
        denom = left - 2.0 * center + right
        if denom < -_EPS:
            offset = float(np.clip(0.5 * (left - right) / denom, -0.5, 0.5))
    level = center if offset == 0.0 else max(
        center - 0.25 * (left - right) * offset, center
    )
    return max(center_f + offset * bin_hz, 0.0), level


@dataclasses.dataclass
class SpectrumPeakLabel:
    """Decaying peak label (spectrum/state.rs:180-243): finds the highest
    interior bin, refines it parabolically, and fades the label with the
    reference's exact ballistics (pos lerp 0.20, opacity 0.65x+0.35 on
    update, x0.88 decay when absent, dropped below 0.01)."""

    floor_db: float = -99.9
    content: tuple[str, str] | None = None
    label_pos: tuple[float, float] = (0.0, 0.0)
    marker_pos: tuple[float, float] = (0.0, 0.0)
    opacity: float = 0.0

    def update(
        self, bins, db, scale,
        min_f: float = SPECTRUM_MIN_FREQUENCY, max_f: float | None = None,
        reverse: bool = False, unit: str = "dBFS",
    ):
        bins = np.asarray(bins, np.float32)
        db = np.asarray(db, np.float32)
        if max_f is None:
            max_f = float(max(bins[-1], min_f * 1.02))
        incoming = None
        interior = np.arange(1, max(len(bins) - 1, 1))
        ok = (bins[interior] >= min_f) & (bins[interior] <= max_f) & np.isfinite(
            db[interior]
        )
        if ok.any():
            cand = interior[ok]
            bin_idx = int(cand[np.argmax(db[cand])])
            pk = spectrum_interpolated_peak(bins, db, bin_idx)
            if pk is not None:
                f, m = pk
                t = float(scale.pos_of(min_f, max_f, f))
                if np.isfinite(t) and np.isfinite(m):
                    x = float(np.clip(1.0 - t if reverse else t, 0.0, 1.0))
                    y = float(np.clip(
                        (m - self.floor_db)
                        / max(SPECTRUM_MAX_DB - self.floor_db, _EPS),
                        0.0, 1.0,
                    ))
                    if y >= 0.08:
                        from openmeters_tpu_torch.utils.musical import NoteInfo

                        ni = NoteInfo.from_frequency(f)
                        line2 = f"{fmt_freq(f)}   {m:.1f} {unit}"
                        text = (
                            (ni.fmt_note_cents(), line2)
                            if ni is not None
                            else (fmt_freq(f), line2)
                        )
                        incoming = (text, (x, y))
        if incoming is not None:
            text, pos = incoming
            if self.opacity <= 0.0 or self.content is None:
                self.content, self.label_pos, self.marker_pos = text, pos, pos
                self.opacity = 1.0
            else:
                self.content = text
                self.label_pos = tuple(
                    p + (q - p) * 0.20 for p, q in zip(self.label_pos, pos)
                )
                self.marker_pos = pos
                self.opacity = min(0.65 * self.opacity + 0.35, 1.0)
        else:
            self.opacity *= 0.88
            if self.opacity < 0.01:
                self.content = None
                self.opacity = 0.0
        return self


# -- spectrogram interaction / readout (numeric halves) ------------------------
# reference spectrogram/state.rs:337-737: zoom/pan UV mapping, crosshair
# frequency/note/time tooltip, piano-roll key layout.  The drawing stays
# renderer-side; everything measurable lives here so a downstream renderer
# (or headless consumer) reproduces the reference's readouts exactly.

SPECTROGRAM_DISPLAY_MIN_HZ = 1.0  # state.rs:46
PIANO_MIDI_LO = 21  # A0 (state.rs:39)
PIANO_MIDI_HI = 119  # C8 (state.rs:40)


def spectrogram_display_axis(sample_rate: float):
    """(min_hz, nyquist) display frequency axis (state.rs:48-51)."""
    nyq = max(sample_rate / 2.0, 1.0)
    return (min(SPECTROGRAM_DISPLAY_MIN_HZ, nyq * 0.5), nyq)


def spectrogram_uv_y_range(zoom: float, pan: float):
    """Visible vertical UV window under zoom/pan (state.rs:348-353)."""
    h = 0.5 / max(zoom, 1.0)
    lo = min(max(pan - h, 0.0), 1.0 - 2.0 * h)
    return (lo, min(lo + 2.0 * h, 1.0))


def spectrogram_zoom_at(zoom: float, pan: float, y_norm: float, factor: float):
    """Cursor-anchored zoom: the frequency under the cursor stays put
    (state.rs:355-365).  Returns (zoom, pan)."""
    old_h = 0.5 / max(zoom, 1.0)
    old_min = min(max(pan - old_h, 0.0), 1.0)
    cursor_uv = old_min + y_norm * 2.0 * old_h
    new_zoom = max(zoom * factor, 1.0)
    new_h = 0.5 / new_zoom
    new_pan = min(max(cursor_uv - new_h * (2.0 * y_norm - 1.0), new_h), 1.0 - new_h)
    return (new_zoom, new_pan)


def spectrogram_freq_axis_norm(x_norm: float, y_norm: float, rotation: int):
    """Screen point -> frequency-axis position 0..1, matching the shader's
    rotate_uv (state.rs:306-319).  Inputs are bounds-normalized 0..1."""
    r = rotation % 4
    if r == 1:
        norm = x_norm
    elif r == 2:
        norm = y_norm
    elif r == 3:
        norm = 1.0 - x_norm
    else:
        norm = 1.0 - y_norm
    return min(max(norm, 0.0), 1.0)


def spectrogram_frequency_at(
    freq_norm: float, uv_range, sample_rate: float, scale
) -> float | None:
    """Crosshair frequency readout (state.rs:286-296)."""
    tex_uv = uv_range[0] + freq_norm * (uv_range[1] - uv_range[0])
    lo, nyq = spectrogram_display_axis(sample_rate)
    f = float(scale.freq_at(lo, nyq, tex_uv))
    return f if np.isfinite(f) and f > 0.0 else None


def spectrogram_time_ago(
    age_px: float, col_count: int, hop_size: int, sample_rate: float
) -> float | None:
    """Crosshair time readout: 1 column = 1 logical pixel on the time axis
    (state.rs:321-334)."""
    if age_px < 0.0 or age_px >= float(col_count):
        return None
    secs = age_px * (hop_size / sample_rate)
    return secs if np.isfinite(secs) else None


def crosshair_readout(
    x_norm: float,
    y_norm: float,
    *,
    uv_range,
    sample_rate: float,
    scale,
    rotation: int = 0,
    col_count: int = 0,
    hop_size: int = 1,
    age_px: float | None = None,
) -> dict:
    """Full tooltip payload: frequency, musical note (with cents), and time
    ago (state.rs:417-472).  ``age_px`` defaults to the time-axis pixel
    distance implied by the rotation over a unit-sized widget."""
    from openmeters_tpu_torch.utils.musical import NoteInfo

    fn = spectrogram_freq_axis_norm(x_norm, y_norm, rotation)
    freq = spectrogram_frequency_at(fn, uv_range, sample_rate, scale)
    note = None
    if freq is not None:
        info = NoteInfo.from_frequency(freq)
        note = info.fmt_note_cents() if info is not None else None
    time_ago = None
    if age_px is not None:
        time_ago = spectrogram_time_ago(age_px, col_count, hop_size, sample_rate)
    return {"freq_hz": freq, "note": note, "time_ago_s": time_ago}


def piano_roll_keys(uv_range, sample_rate: float, scale) -> list[dict]:
    """Piano-roll overlay key layout (state.rs:474-604): for each visible
    MIDI key, its normalized frequency-axis extent [a, b].  Key boundaries
    sit at the midpoint of the intervening black key, or at the semitone
    midpoint where no black key exists (E-F, B-C)."""
    from openmeters_tpu_torch.utils.musical import MusicalNote

    lo, nyq = spectrogram_display_axis(sample_rate)
    freq_bot = float(scale.freq_at(lo, nyq, uv_range[0]))
    freq_top = float(scale.freq_at(lo, nyq, uv_range[1]))

    n_bot = MusicalNote.from_frequency(max(freq_bot, 16.0))
    n_top = MusicalNote.from_frequency(freq_top)
    midi_lo = PIANO_MIDI_LO if n_bot is None else max(n_bot.midi_number - 1, PIANO_MIDI_LO)
    midi_hi = PIANO_MIDI_HI if n_top is None else min(n_top.midi_number + 1, PIANO_MIDI_HI)

    semi = 2.0 ** (0.5 / 12.0)
    inv_s = 1.0 / semi
    whole = semi * semi
    inv_w = 1.0 / whole

    span = uv_range[1] - uv_range[0]

    def freq_to_t(f: float) -> float:
        uv = float(scale.pos_of(lo, nyq, f))
        return min(max((uv - uv_range[0]) / span if span > 0 else 0.0, 0.0), 1.0)

    keys = []
    for midi in range(midi_lo, midi_hi + 1):
        note = MusicalNote(midi_number=midi)
        f = note.to_frequency()
        if note.is_black:
            ml, mh = inv_s, semi
        elif midi % 12 in (0, 5):  # C, F: black key above only
            ml, mh = inv_s, whole
        elif midi % 12 in (4, 11):  # E, B: black key below only
            ml, mh = inv_w, semi
        else:
            ml, mh = inv_w, whole
        a, b = freq_to_t(f * mh), freq_to_t(f * ml)
        if a > b:
            a, b = b, a
        if b <= 0.0 or a >= 1.0:
            continue
        keys.append(
            {"midi": midi, "freq_hz": f, "black": note.is_black, "extent": (a, b)}
        )
    return keys
