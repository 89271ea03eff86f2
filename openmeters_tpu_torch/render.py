"""Headless software renderer: the reference's GPU pipelines as a numpy
rasterizer (SURVEY §2.13; port of ``render.py``).

The reference draws with two wgpu pipelines: an instanced-quad SDF pipeline
(``render/common.rs:99-628`` + ``shaders/sdf.wgsl``) whose five primitive
kinds cover every visual's geometry, and a spectrogram pipeline
(``spectrogram/render.rs`` + ``shaders/spectrogram.wgsl``) that samples u16
dB codes per fragment (classic) or additively accumulates reassigned point
splats then resolves power→dB→palette.  This module re-implements those
*semantics* on the CPU — same coverage math, same color/palette/dB mapping,
same per-visual geometry constants — producing premultiplied-RGBA frames and
PNG files with zero GPU or windowing dependencies.  Device compute stays in
the analyzers; rendering is a host-side view concern, so the rasterizer is
vectorized numpy on the host, as the JAX package's is.  :func:`render_series`
takes snapshots of tensors on any device and moves what it reads to the
host in one copy, so the rasterizers see numpy only.

PNG I/O is a minimal stdlib implementation (zlib + struct, 8-bit RGB/RGBA,
filter 0) so the renderer works in this hermetic environment.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from openmeters_tpu_torch.utils.frequency import FrequencyScale
from openmeters_tpu_torch.views import (
    GradientPalette,
    HEAT_RAMP,
    decimate_minmax_line,
    reassigned_accumulate,
    resample_trace,
    stereometer_scaled_compression,
)

# Analysis floor / classic storage domain (spectrogram.wgsl:10-19).
DB_STORE_LO = -144.0
DB_STORE_HI = 12.0
DB_ANALYSIS_FLOOR = -140.0
DB_FLOOR_EPS = 0.01

# Oscilloscope geometry (oscilloscope/render.rs:31-36).
OSC_VERTICAL_PADDING = 8.0
OSC_CHANNEL_GAP = 12.0
OSC_AMPLITUDE_SCALE = 0.9
OSC_FILL_ALPHA = 0.15

# Loudness bar layout (loudness/render.rs:11-24,42-46).
LOUDNESS_DB_RANGE = (-60.0, 4.0)
LOUDNESS_GUIDE_LEVELS = (0.0, -6.0, -12.0, -18.0, -24.0, -36.0)
LOUDNESS_LEFT_PADDING = 28.0
LOUDNESS_RIGHT_PADDING = 64.0
LOUDNESS_GAP_FRACTION = 0.1
LOUDNESS_BAR_WIDTH_SCALE = 0.6

# segments of a polyline measured over one padded box (Canvas.polyline)
SEGMENTS_PER_BOX = 16


# -- PNG (minimal, stdlib-only) ------------------------------------------------


def encode_png(img: np.ndarray) -> bytes:
    """8-bit RGB/RGBA PNG, filter 0 on every scanline."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise TypeError("encode_png expects uint8")
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected [h, w, 3|4], got {arr.shape}")
    h, w, c = arr.shape
    color_type = 2 if c == 3 else 6
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1
    ).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def decode_png(data: bytes) -> np.ndarray:
    """Decoder for the encoder's own output (filter 0, 8-bit RGB/RGBA)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w = 8, b"", 0
    h = channels = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or color_type not in (2, 6):
                raise ValueError("unsupported PNG flavor")
            channels = 3 if color_type == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * channels
    )
    if np.any(raw[:, 0] != 0):
        raise ValueError("unsupported PNG filter")
    return raw[:, 1:].reshape(h, w, channels).copy()


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -- canvas: the SDF pipeline's primitive kinds, rasterized --------------------


def _premul(color) -> np.ndarray:
    """iced expects premultiplied alpha (sdf.wgsl:72, spectrogram.wgsl:212)."""
    c = np.asarray(color, np.float32)
    return np.concatenate([c[:3] * c[3], c[3:4]])


@dataclasses.dataclass
class Canvas:
    """Premultiplied-RGBA float framebuffer with source-over compositing.

    Methods mirror the SDF pipeline's primitive kinds
    (``render/common.rs:99-628``, ``sdf.wgsl:25-67``): gradient quad (case
    0), baseline fill (case 1), AA line (case 2), radial/plain dot (case
    4/default).  Coverage math matches the fragment shader:
    ``clamp((radius - dist) / aa + 0.5, 0, 1)`` with ``aa`` = 1 px
    (``sdf.wgsl:78-84`` — ``fwidth`` of screen-space coords is 1).
    """

    width: int
    height: int
    background: tuple = (0.0, 0.0, 0.0, 1.0)

    def __post_init__(self):
        self.buf = np.zeros((self.height, self.width, 4), np.float32)
        self.buf[:] = _premul(self.background)

    # source-over with premultiplied colors: dst = src + dst * (1 - a_src)
    def _over(self, y0, y1, x0, x1, cov, src):
        y0 = max(int(y0), 0)
        x0 = max(int(x0), 0)
        y1 = min(int(y1), self.height)
        x1 = min(int(x1), self.width)
        if y1 <= y0 or x1 <= x0:
            return
        dst = self.buf[y0:y1, x0:x1]
        srgb = cov[..., None] * src
        dst *= 1.0 - srgb[..., 3:4]
        dst += srgb

    def gradient_quad(self, x0, y0, x1, y1, top, bottom=None):
        """Axis-aligned quad, color lerped top→bottom (sdf.wgsl case 0)."""
        bottom = top if bottom is None else bottom
        xi0, xi1 = int(np.floor(min(x0, x1))), int(np.ceil(max(x0, x1)))
        yi0, yi1 = int(np.floor(min(y0, y1))), int(np.ceil(max(y0, y1)))
        yi0c, yi1c = max(yi0, 0), min(yi1, self.height)
        if yi1c <= yi0c:
            return
        ys = np.arange(yi0c, yi1c, dtype=np.float32) + 0.5
        t = np.clip(
            (ys - min(y0, y1)) / max(abs(y1 - y0), 1e-6), 0.0, 1.0
        )[:, None]
        src = (1.0 - t[..., None]) * _premul(top) + t[..., None] * _premul(
            bottom
        )
        cov = np.ones((yi1c - yi0c, max(min(xi1, self.width) - max(xi0, 0), 0)),
                      np.float32)
        self._over(yi0c, yi1c, xi0, xi1, cov, src)

    def baseline_fill(self, xs, ys, baseline, color0, color1=None):
        """Fill between a polyline's y values and a horizontal baseline,
        color lerped along x (sdf.wgsl case 1).  ``xs``/``ys`` in pixels."""
        color1 = color0 if color1 is None else color1
        xs = np.asarray(xs, np.float32)
        ys = np.asarray(ys, np.float32)
        if len(xs) < 2:
            return
        px = np.arange(self.width, dtype=np.float32) + 0.5
        inside = (px >= xs.min()) & (px <= xs.max())
        yline = np.interp(px, xs, ys).astype(np.float32)
        t = np.clip(
            (px - xs.min()) / max(xs.max() - xs.min(), 1e-6), 0.0, 1.0
        )
        c0, c1 = _premul(color0), _premul(color1)
        src = (1.0 - t[:, None]) * c0 + t[:, None] * c1  # [W, 4]
        gy = np.arange(self.height, dtype=np.float32)[:, None] + 0.5
        lo = np.minimum(yline, baseline)[None, :]
        hi = np.maximum(yline, baseline)[None, :]
        cov = np.clip(np.minimum(gy + 0.5, hi) - np.maximum(gy - 0.5, lo), 0.0, 1.0)
        cov *= inside[None, :]
        self._over(0, self.height, 0, self.width, cov, src[None, :, :])

    def polyline(self, points, color, width=1.0, color_end=None):
        """AA line strip (sdf.wgsl case 2): per-pixel distance to each
        segment, coverage ``clamp((r - d)/aa + 0.5, 0, 1)``, max-combined
        across segments (matching overlapping instanced quads).

        A segment covers nothing past ``pad`` pixels of its own box, so each
        run of :data:`SEGMENTS_PER_BOX` segments is measured over its own
        padded box, not the whole line's: the same arithmetic per pixel and
        segment (the same bytes as the JAX package's), in time that grows
        with the line's length rather than with its box times its length."""
        pts = np.asarray(points, np.float32)
        pts = pts[np.all(np.isfinite(pts), axis=-1)]
        if len(pts) < 2:
            return
        r = max(width * 0.5, 0.5)
        pad = int(np.ceil(r + 1.5))
        x0 = int(np.floor(pts[:, 0].min())) - pad
        x1 = int(np.ceil(pts[:, 0].max())) + pad
        y0 = int(np.floor(pts[:, 1].min())) - pad
        y1 = int(np.ceil(pts[:, 1].max())) + pad
        x0, x1 = max(x0, 0), min(x1, self.width)
        y0, y1 = max(y0, 0), min(y1, self.height)
        if x1 <= x0 or y1 <= y0:
            return
        gx = np.arange(x0, x1, dtype=np.float32) + 0.5
        a = pts[:-1]
        b = pts[1:]
        d = b - a  # [N, 2]
        len2 = np.maximum((d * d).sum(-1), 1e-12)  # [N]
        lo = np.floor(np.minimum(a, b)).astype(np.int64) - pad  # [N, 2] first pixel a segment reaches
        hi = np.ceil(np.maximum(a, b)).astype(np.int64) + pad  # [N, 2] past its last
        cov = np.zeros((y1 - y0, x1 - x0), np.float32)
        for s in range(0, len(a), SEGMENTS_PER_BOX):
            e = s + SEGMENTS_PER_BOX
            bx0, bx1 = max(int(lo[s:e, 0].min()), x0), min(int(hi[s:e, 0].max()), x1)
            by0, by1 = max(int(lo[s:e, 1].min()), y0), min(int(hi[s:e, 1].max()), y1)
            if bx1 <= bx0 or by1 <= by0:
                continue
            px = (np.arange(bx0, bx1, dtype=np.float32) + 0.5)[None, :, None]
            py = (np.arange(by0, by1, dtype=np.float32) + 0.5)[:, None, None]
            sa, sd = a[s:e], d[s:e]
            t = np.clip(
                ((px - sa[:, 0]) * sd[:, 0] + (py - sa[:, 1]) * sd[:, 1]) / len2[s:e],
                0.0,
                1.0,
            )  # [h, w, n]
            dx = px - (sa[:, 0] + t * sd[:, 0])
            dy = py - (sa[:, 1] + t * sd[:, 1])
            dist = np.sqrt(dx * dx + dy * dy)
            box = cov[by0 - y0 : by1 - y0, bx0 - x0 : bx1 - x0]
            np.maximum(box, np.clip((r - dist) + 0.5, 0.0, 1.0).max(axis=-1), out=box)
        if color_end is None:
            src = _premul(color)
        else:
            tx = np.clip(
                (gx - pts[0, 0]) / max(pts[-1, 0] - pts[0, 0], 1e-6), 0, 1
            )[None, :, None]
            src = (1.0 - tx) * _premul(color) + tx * _premul(color_end)
        self._over(y0, y1, x0, x1, cov, src)

    def dots(self, centers, radius, color):
        """Batched AA dots (sdf.wgsl default case; radial dots are the
        same primitive fed pre-compressed positions)."""
        cs = np.asarray(centers, np.float32).reshape(-1, 2)
        cs = cs[np.all(np.isfinite(cs), axis=-1)]
        if len(cs) == 0:
            return
        src = _premul(color)
        pad = int(np.ceil(radius + 1.5))
        for cx, cy in cs:
            x0, x1 = int(cx) - pad, int(cx) + pad + 1
            y0, y1 = int(cy) - pad, int(cy) + pad + 1
            x0, x1 = max(x0, 0), min(x1, self.width)
            y0, y1 = max(y0, 0), min(y1, self.height)
            if x1 <= x0 or y1 <= y0:
                continue
            gx = np.arange(x0, x1, dtype=np.float32) + 0.5
            gy = np.arange(y0, y1, dtype=np.float32) + 0.5
            dist = np.sqrt(
                (gx[None, :] - cx) ** 2 + (gy[:, None] - cy) ** 2
            )
            cov = np.clip((radius - dist) + 0.5, 0.0, 1.0)
            self._over(y0, y1, x0, x1, cov, src)

    def to_srgb_u8(self) -> np.ndarray:
        """Un-premultiply and quantize to RGB over the opaque background."""
        rgb = self.buf[..., :3]
        return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


# -- spectrogram ---------------------------------------------------------------


def shade_db(db, floor_db: float, palette: GradientPalette) -> np.ndarray:
    """power-dB → palette, premultiplied (spectrogram.wgsl:205-213)."""
    db = np.asarray(db, np.float32)
    rng = max(-floor_db, 0.001)
    level = np.clip((db - floor_db) / rng, 0.0, 1.0)
    color = palette.evaluate(level)
    out = color.copy()
    out[..., :3] *= out[..., 3:4]
    return out


def render_spectrogram_classic(
    db_cols: np.ndarray,
    *,
    sample_rate: float,
    fft_size: int,
    width: int,
    height: int,
    palette: GradientPalette = HEAT_RAMP,
    floor_db: float = DB_ANALYSIS_FLOOR,
    scale: FrequencyScale = FrequencyScale.LOGARITHMIC,
    uv_y_range: tuple = (0.0, 1.0),
    tilt_db: float = 0.0,
    freq_lo_hz: float = 0.0,
    freq_hi_hz: float | None = None,
) -> np.ndarray:
    """Classic spectrogram frame from dB columns ``[cols, bins]`` (newest
    last): per-pixel frequency mapping + bilinear bin interpolation + dB
    tilt + palette, exactly ``classic_sample``/``fs_classic``
    (spectrogram.wgsl:178-202,236-251).  Returns premultiplied RGBA
    ``[height, width, 4]`` f32.
    """
    cols = np.asarray(db_cols, np.float32)
    n_cols, bins = cols.shape
    if freq_hi_hz is None:
        freq_hi_hz = sample_rate / 2.0
    bin_hz = sample_rate / fft_size

    # pixel row -> frequency (norm_to_freq through the zoom window)
    zoomed = 1.0 - (np.arange(height, dtype=np.float32) + 0.5) / height
    u0, u1 = uv_y_range
    freq_norm = u0 + zoomed * (u1 - u0)
    freq_hz = scale.freq_at(freq_lo_hz, freq_hi_hz, freq_norm)
    bin_f = np.asarray(freq_hz, np.float32) / bin_hz
    max_bin = bins - 1
    in_range = bin_f <= max_bin
    b0 = np.clip(np.floor(bin_f).astype(np.int64), 0, max_bin)
    b1 = np.minimum(b0 + 1, max_bin)
    frac = (bin_f - b0).astype(np.float32)

    # pixel col -> column age (newest at the right edge)
    age = np.floor(
        (width - (np.arange(width, dtype=np.float32) + 0.5))
        / max(width / max(n_cols, 1), 1e-6)
    ).astype(np.int64)
    col_ok = (age >= 0) & (age < n_cols)
    ci = np.clip(n_cols - 1 - age, 0, n_cols - 1)

    mag = (
        cols[ci[None, :], b0[:, None]] * (1.0 - frac[:, None])
        + cols[ci[None, :], b1[:, None]] * frac[:, None]
    )
    if tilt_db != 0.0:
        # fs_classic: don't lift floor bins (spectrogram.wgsl:241-247)
        lift = tilt_db * np.log2(np.maximum(freq_hz, 1e-9) / 1000.0)
        mag = np.where(
            (freq_hz > 0)[:, None] & (mag > DB_ANALYSIS_FLOOR + DB_FLOOR_EPS),
            mag + np.asarray(lift, np.float32)[:, None],
            mag,
        )
    rgba = shade_db(mag, floor_db, palette)
    rgba *= (col_ok[None, :] & in_range[:, None])[..., None]
    return rgba.astype(np.float32)


def render_spectrogram_reassigned(
    freq_hz,
    time_offset,
    power,
    point_valid,
    *,
    width: int,
    height: int,
    palette: GradientPalette = HEAT_RAMP,
    floor_db: float = DB_ANALYSIS_FLOOR,
    scale: FrequencyScale = FrequencyScale.LOGARITHMIC,
    freq_lo_hz: float = 20.0,
    freq_hi_hz: float = 20_000.0,
    power_scale: float = 1.0,  # fs_resolve's u.reassigned_power_scale
    tilt_db: float = 0.0,
) -> np.ndarray:
    """Reassigned frame: splat-accumulate points into a power image, then
    resolve power→dB→palette (``fs_accum``/``fs_resolve``,
    spectrogram.wgsl:216-237).  The dB tilt weights power at accumulation
    time like ``fs_accum``; the transpose puts time on x, frequency on y
    (newest right, high frequencies up)."""
    f = np.asarray(freq_hz, np.float32).ravel()
    p = np.asarray(power, np.float32).ravel()
    if tilt_db != 0.0:
        # fs_accum: power *= 2^(tilt * log2(f/1k) * DB_TO_LOG2) — the
        # dB/octave tilt as a linear power factor (spectrogram.wgsl:216-225)
        factor = np.exp2(
            tilt_db * np.log2(np.maximum(f, 1e-9) / 1000.0) * 0.3321928095
        )
        p = np.where(f > 0.0, p * factor, p)
    img = reassigned_accumulate(
        f,
        time_offset,
        p,
        point_valid,
        time_bins=width,
        freq_lo_hz=freq_lo_hz,
        freq_hi_hz=freq_hi_hz,
        freq_bins=height,
        scale=scale,
        power_scale=power_scale,
    )
    power_img = img.T[::-1]  # [height, width], high frequencies up
    db = np.where(
        power_img > 0.0,
        np.maximum(
            10.0 * np.log10(np.maximum(power_img, 1e-20)), DB_ANALYSIS_FLOOR
        ),
        -np.inf,
    )
    rgba = shade_db(db, floor_db, palette)
    rgba *= (power_img > 0.0)[..., None]
    return rgba.astype(np.float32)


# -- per-visual frames ---------------------------------------------------------


def render_spectrum_frame(
    canvas: Canvas,
    points: np.ndarray,
    valid: np.ndarray,
    *,
    color=(0.3, 0.9, 1.0, 1.0),
    fill_alpha: float = OSC_FILL_ALPHA,
    width: float = 1.5,
    ticks: list | None = None,
    tick_color=(1.0, 1.0, 1.0, 0.10),
    peak_marker: tuple | None = None,
    peak_opacity: float = 0.0,
) -> None:
    """Spectrum line + baseline fill from :func:`views.spectrum_points`
    output (spectrum/render.rs: line + fill pipeline; min/max decimation to
    pixel columns via ``decimate_finite_ordered_line_in_place``,
    render/common.rs:306-383).  ``ticks`` takes
    :func:`views.spectrum_grid_ticks` output (vertical decade grid lines,
    majors brighter); ``peak_marker`` takes a normalized (x, y) from
    :class:`views.SpectrumPeakLabel` with its decayed ``opacity``."""
    if ticks:
        for _f, x, major, _label in ticks:
            tx = x * (canvas.width - 1)
            c = list(tick_color)
            c[3] = tick_color[3] * (2.0 if major else 1.0)
            canvas.polyline([(tx, 0.0), (tx, canvas.height - 1.0)], c, width=1.0)
    pts = np.asarray(points, np.float32)[np.asarray(valid, bool)]
    if len(pts) < 2:
        return
    px = np.stack(
        [pts[:, 0] * (canvas.width - 1), (1.0 - pts[:, 1]) * (canvas.height - 1)],
        axis=-1,
    )
    px = decimate_minmax_line(px, max_points=2 * canvas.width)
    fill = (*np.asarray(color[:3]), color[3] * fill_alpha)
    canvas.baseline_fill(px[:, 0], px[:, 1], canvas.height - 1.0, fill)
    canvas.polyline(px, color, width=width)
    if peak_marker is not None and peak_opacity > 0.01:
        mx = float(peak_marker[0]) * (canvas.width - 1)
        my = (1.0 - float(peak_marker[1])) * (canvas.height - 1)
        canvas.dots([(mx, my)], 2.5, (1.0, 1.0, 1.0, min(peak_opacity, 1.0)))


def render_oscilloscope_frame(
    canvas: Canvas,
    snapshot,
    stream: int = 0,
    *,
    colors=((0.3, 0.9, 1.0, 1.0), (1.0, 0.6, 0.2, 1.0)),
    stacked: bool = True,
    stroke_width: float = 1.0,
) -> None:
    """Oscilloscope traces (oscilloscope/render.rs:30-94): per-channel
    vertical layout (padding 8, gap 12, amplitude 0.9), traces resampled
    from the raw capture via :func:`views.resample_trace`, min/max
    decimated to the pixel width, drawn as AA polylines with a translucent
    fill to the center line."""
    samples = np.asarray(snapshot.samples)[stream]
    tvalid = np.asarray(snapshot.trace_valid)[stream]
    spans = np.asarray(snapshot.span)[stream]
    fracs = np.asarray(snapshot.frac)[stream]
    active = [t for t in range(samples.shape[0]) if tvalid[t]]
    lanes = 1 if stacked else max(len(active), 1)
    lane_h = (
        canvas.height - 2 * OSC_VERTICAL_PADDING - (lanes - 1) * OSC_CHANNEL_GAP
    ) / lanes
    for i, t in enumerate(active):
        trace = resample_trace(samples[t], float(spans[t]), float(fracs[t]))
        if len(trace) < 2:
            continue
        lane = 0 if stacked else i
        center = OSC_VERTICAL_PADDING + lane * (lane_h + OSC_CHANNEL_GAP) + lane_h / 2
        amp = lane_h / 2 * OSC_AMPLITUDE_SCALE
        xs = np.linspace(0, canvas.width - 1, len(trace), dtype=np.float32)
        ys = center - np.clip(trace, -1.5, 1.5) * amp
        pts = decimate_minmax_line(
            np.stack([xs, ys], -1), max_points=2 * canvas.width
        )
        color = colors[t % len(colors)]
        fill = (*np.asarray(color[:3]), color[3] * OSC_FILL_ALPHA)
        canvas.baseline_fill(pts[:, 0], pts[:, 1], center, fill)
        canvas.polyline(pts, color, width=stroke_width)


def render_stereometer_frame(
    canvas: Canvas,
    cloud_xy: np.ndarray,
    cloud_valid: np.ndarray,
    *,
    color=(0.3, 0.9, 1.0, 0.35),
    dot_radius: float = 1.2,
    compress: bool = True,
) -> None:
    """Lissajous dot cloud (stereometer/render.rs:21-62): optional "Scaled"
    radial compression (matched in sdf.wgsl:46-54), mapped into the largest
    centered square, drawn as radial dots; guide diagonals underneath."""
    size = min(canvas.width, canvas.height) * 0.5
    cx, cy = canvas.width / 2.0, canvas.height / 2.0
    guide = (1.0, 1.0, 1.0, 0.12)
    canvas.polyline([(cx - size, cy + size), (cx + size, cy - size)], guide)
    canvas.polyline([(cx - size, cy - size), (cx + size, cy + size)], guide)
    xy = np.asarray(cloud_xy, np.float32).reshape(-1, 2)
    m = np.asarray(cloud_valid, bool).ravel()
    if not m.any():
        return
    x, y = xy[m, 0], xy[m, 1]
    if compress:
        x, y = stereometer_scaled_compression(x, y)
    centers = np.stack([cx + x * size, cy - y * size], axis=-1)
    canvas.dots(centers, dot_radius, color)


def render_correlation_meter(
    canvas: Canvas,
    trail,
    *,
    x0: float,
    x1: float,
    positive=(0.35, 0.95, 0.55, 0.9),
    negative=(0.95, 0.4, 0.35, 0.9),
    edge: float = 6.0,
) -> None:
    """Correlation side meter (stereometer/render.rs:398-440): the trail's
    per-row max-alpha column drawn as 1-px quads colored by sign around the
    center line, plus a 2-px marker at the current value.  ``trail`` is a
    :class:`openmeters_tpu_torch.views.CorrelationTrail`."""
    from openmeters_tpu_torch.views import correlation_trail_alpha

    h = canvas.height
    alpha, marker_y = correlation_trail_alpha(trail, h, edge=edge)
    center = h / 2.0
    pos = np.asarray(positive, np.float32)
    neg = np.asarray(negative, np.float32)
    for y in np.nonzero(alpha > 0.0)[0]:
        c = neg if (y + 0.5) > center else pos
        c = np.concatenate([c[:3], [c[3] * float(alpha[y])]])
        canvas.gradient_quad(x0, float(y), x1, float(y + 1), c)
    if marker_y is not None:
        cur = float(trail.values[0])
        c = neg if cur < 0.0 else pos
        canvas.gradient_quad(x0, marker_y - 1.0, x1, marker_y + 1.0, c)


def render_waveform_frame(
    canvas: Canvas,
    columns: list,
    *,
    fallback_color=(0.3, 0.9, 1.0, 1.0),
) -> None:
    """Waveform min/max columns + per-column band color (waveform/render.rs:
    column quads; color comes from the processor's band mix).  Newest column
    at the right edge, one pixel column per record."""
    n = len(columns)
    if n == 0:
        return
    mid = canvas.height / 2.0
    amp = canvas.height / 2.0 * 0.9
    x1 = canvas.width
    for k, col in enumerate(columns[-canvas.width:][::-1]):
        x = x1 - 1 - k
        color = np.asarray(col.get("color", fallback_color), np.float32)
        color = color.reshape(-1, color.shape[-1]).mean(axis=0)  # mix lanes
        if color.shape[-1] == 3:
            color = np.concatenate([color, [1.0]])
        y_top = mid - float(np.max(col["max"])) * amp
        y_bot = mid - float(np.min(col["min"])) * amp
        canvas.gradient_quad(x, y_top, x + 1, max(y_bot, y_top + 1.0), color)


def render_loudness_frame(
    canvas: Canvas,
    *,
    momentary_lufs: float,
    short_term_lufs: float,
    integrated_lufs: float,
    true_peak_db: float,
    bar_colors=((0.3, 0.9, 1.0, 1.0), (0.2, 0.55, 0.9, 1.0)),
    guide_color=(1.0, 1.0, 1.0, 0.25),
) -> None:
    """Loudness bars (loudness/render.rs:11-24,42-99): two bar groups
    (momentary+short-term, integrated), ``db_to_ratio`` = normalized
    ``(db+60)/64`` with a 0.9 power curve, guide ticks at the reference
    levels, true peak as a marker line on the second group."""
    lo, hi = LOUDNESS_DB_RANGE

    def ratio(db: float) -> float:
        raw = float(np.clip((db - lo) / (hi - lo), 0.0, 1.0))
        return raw**0.9

    meter_w = max(
        canvas.width - LOUDNESS_LEFT_PADDING - LOUDNESS_RIGHT_PADDING, 0.0
    )
    if meter_w <= 0:
        return
    gap = meter_w * LOUDNESS_GAP_FRACTION
    bar_slot = (meter_w - gap) / 2.0
    bar_w = bar_slot * LOUDNESS_BAR_WIDTH_SCALE
    x0 = LOUDNESS_LEFT_PADDING + (bar_slot - bar_w) * 0.5
    y1 = canvas.height - 1.0
    h = canvas.height - 2.0

    groups = (
        ((momentary_lufs, short_term_lufs), None),
        ((integrated_lufs,), true_peak_db),
    )
    for g, (values, peak) in enumerate(groups):
        gx = x0 + g * (bar_w + gap + (bar_slot - bar_w))
        sub_w = bar_w / len(values) * (1.0 - 0.09)
        for i, db in enumerate(values):
            bx = gx + i * (bar_w / len(values))
            top = y1 - h * ratio(db)
            canvas.gradient_quad(
                bx, top, bx + sub_w, y1, bar_colors[i % len(bar_colors)]
            )
        if peak is not None and np.isfinite(peak):
            py = y1 - h * ratio(peak)
            canvas.polyline(
                [(gx, py), (gx + bar_w, py)], (1.0, 0.35, 0.3, 1.0), width=2.0
            )
    for level in LOUDNESS_GUIDE_LEVELS:
        gy = y1 - h * ratio(level)
        canvas.polyline(
            [(LOUDNESS_LEFT_PADDING - 7.0, gy), (LOUDNESS_LEFT_PADDING - 3.0, gy)],
            guide_color,
            width=1.0,
        )


# -- frame orchestration -------------------------------------------------------


def compose_rgba(rgba: np.ndarray, background=(0.0, 0.0, 0.0, 1.0)) -> np.ndarray:
    """Composite a premultiplied RGBA image over a background, to u8 RGB."""
    bg = _premul(background)
    out = rgba[..., :3] + bg[None, None, :3] * (1.0 - rgba[..., 3:4])
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


# the snapshot fields render_series reads: of every hop (the time-scrolling
# panes and the correlation trail), and of the last hop
_EVERY_HOP = {
    "spectrogram": ("codes", "valid", "freq_hz", "time_offset", "power", "point_valid"),
    "stereometer": ("points_valid", "correlations"),
    "waveform": ("col_min", "col_max", "col_color", "col_rms_db", "col_valid"),
}
_LAST_HOP = {
    "spectrum": ("weighted_db",),
    "oscilloscope": ("samples", "trace_valid", "span", "frac"),
    "stereometer": ("points", "points_valid"),
    "loudness": ("momentary_lufs", "short_term_lufs", "integrated_lufs", "true_peak_db"),
}


def _to_host(leaves: list) -> list[np.ndarray]:
    """Each leaf as a numpy array.  Tensors on a card come over in one copy:
    their bytes joined on the device, one ``.cpu()``, split on the host."""
    out = [None] * len(leaves)
    on_card = []
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cpu":
                out[i] = x.numpy()
            else:
                on_card.append(i)
        else:
            out[i] = np.asarray(x)
    if on_card:
        parts = [leaves[i].contiguous().reshape(-1) for i in on_card]
        raw = torch.cat([p.view(torch.uint8) for p in parts]).cpu().numpy()
        off = 0
        for i, p in zip(on_card, parts):
            n = p.numel() * p.element_size()
            dtype = torch.empty(0, dtype=p.dtype).numpy().dtype
            out[i] = raw[off : off + n].view(dtype).reshape(leaves[i].shape)
            off += n
    return out


def host_series(series: list, stream: int = 0) -> list:
    """The part of an ``api.analyze`` snapshot series that
    :func:`render_series` reads, for one stream, as numpy: a list of hop
    dicts of the same snapshot types, each field ``[1, ...]`` (stream 0),
    ``None`` where the renderer does not read it.  Every hop's field is
    stacked on its device first, so a series on the card costs one copy."""
    last = series[-1]
    plan = []  # (name, field, every hop)
    for name, snap in last.items():
        fields = snap._fields
        plan += [(name, f, True) for f in _EVERY_HOP.get(name, ()) if f in fields]
        plan += [(name, f, False) for f in _LAST_HOP.get(name, ())
                 if f in fields and f not in _EVERY_HOP.get(name, ())]
    leaves = []
    for name, field, every in plan:
        if every:
            parts = [getattr(hop[name], field)[stream] for hop in series]
            stack = torch.stack if isinstance(parts[0], torch.Tensor) else np.stack
            leaves.append(stack(parts))
        else:
            leaves.append(getattr(last[name], field)[stream : stream + 1])
    host = dict(zip([(n, f) for n, f, _ in plan], _to_host(leaves)))
    out = []
    for i in range(len(series)):
        hop = {}
        for name, snap in last.items():
            kw = {}
            for f in snap._fields:
                if (name, f) not in host:
                    kw[f] = None
                elif f in _EVERY_HOP.get(name, ()):
                    kw[f] = host[(name, f)][i][None]
                else:
                    kw[f] = host[(name, f)] if i == len(series) - 1 else None
            hop[name] = type(snap)(**kw)
        out.append(hop)
    return out


def render_snapshots(snaps: dict, config, out_dir, stream: int = 0,
                     width: int = 960, height: int = 540) -> list:
    """Render one engine snapshot dict to PNGs (single-frame convenience:
    spectrogram/waveform history is just that hop's columns)."""
    return render_series([snaps], config, out_dir, stream=stream,
                         width=width, height=height)


def render_series(series: list, config, out_dir, stream: int = 0,
                  width: int = 960, height: int = 540) -> list:
    """Render an ``api.analyze`` snapshot series to PNG files, one per
    active visual.  Time-scrolling visuals (spectrogram, waveform)
    accumulate their column history across the whole series — the host-side
    analogue of the reference's GPU column ring (spectrogram/render.rs
    history buffer, newest column at the right edge); the instantaneous
    visuals render the final snapshot.  Snapshots may hold numpy arrays or
    tensors on any device (:func:`host_series` moves what is read to the
    host first).  Returns the written paths."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    written = []
    series = host_series(series, stream)
    stream = 0
    snaps = series[-1]

    def emit(name: str, img_u8: np.ndarray):
        path = os.path.join(out_dir, f"{name}.png")
        write_png(path, img_u8)
        written.append(path)

    if "spectrogram" in snaps:
        from openmeters_tpu_torch.analyzers.spectrogram import (
            CLASSIC_DB_STORE_LO,
            CLASSIC_DB_STORE_RANGE,
            ReassignedColumns,
            SpectrogramAnalyzer,
        )

        cfg = config.spectrogram.normalized()
        if isinstance(snaps["spectrogram"], ReassignedColumns):
            fs, ts, ps, ms = [], [], [], []
            col_counter = 0
            for hop in series:
                sg = hop["spectrogram"]
                col_ok = np.asarray(sg.valid)[stream]
                if not col_ok.any():
                    continue
                idx = np.nonzero(col_ok)[0]
                toff = np.asarray(sg.time_offset)[stream][idx]
                t_img = (
                    col_counter + np.arange(len(idx), dtype=np.float32)[:, None]
                    + toff
                )
                fs.append(np.asarray(sg.freq_hz)[stream][idx].ravel())
                ts.append(t_img.ravel())
                ps.append(np.asarray(sg.power)[stream][idx].ravel())
                ms.append(np.asarray(sg.point_valid)[stream][idx].ravel())
                col_counter += len(idx)
            if fs:
                t_all = np.concatenate(ts) - max(col_counter - width, 0)
                rgba = render_spectrogram_reassigned(
                    np.concatenate(fs),
                    t_all,
                    np.concatenate(ps),
                    np.concatenate(ms) & (t_all >= 0.0),
                    width=width,
                    height=height,
                    power_scale=SpectrogramAnalyzer(cfg).power_scale,
                )
                emit("spectrogram", compose_rgba(rgba))
        else:
            db_cols = []
            for hop in series:
                sg = hop["spectrogram"]
                valid = np.asarray(sg.valid)[stream]
                if valid.any():
                    codes = np.asarray(sg.codes)[stream][valid]
                    db_cols.append(
                        codes.astype(np.float32)
                        * (CLASSIC_DB_STORE_RANGE / 65535.0)
                        + CLASSIC_DB_STORE_LO
                    )
            if db_cols:
                db = np.concatenate(db_cols, axis=0)[-width:]
                rgba = render_spectrogram_classic(
                    db,
                    sample_rate=config.sample_rate,
                    fft_size=cfg.fft_size,
                    width=width,
                    height=height,
                )
                emit("spectrogram", compose_rgba(rgba))

    if "spectrum" in snaps:
        from openmeters_tpu_torch.views import (
            SPECTRUM_MIN_FREQUENCY,
            SpectrumPeakLabel,
            spectrum_grid_ticks,
            spectrum_points,
        )

        sp = snaps["spectrum"]
        scfg = config.spectrum.normalized()
        bins_hz = (
            np.arange(scfg.fft_size // 2 + 1, dtype=np.float32)
            * config.sample_rate
            / scfg.fft_size
        )
        db = np.asarray(sp.weighted_db)[stream, 0]
        scale = FrequencyScale.LOGARITHMIC
        cv = Canvas(width, height)
        pts, valid = spectrum_points(
            db, bins_hz, scale, floor_db=float(scfg.floor_db)
        )
        peak = SpectrumPeakLabel(floor_db=float(scfg.floor_db))
        peak.update(bins_hz, db, scale)
        render_spectrum_frame(
            cv, pts, valid,
            ticks=spectrum_grid_ticks(
                SPECTRUM_MIN_FREQUENCY, float(bins_hz[-1]), scale
            ),
            peak_marker=peak.marker_pos if peak.content else None,
            peak_opacity=peak.opacity,
        )
        emit("spectrum", cv.to_srgb_u8())

    if "oscilloscope" in snaps:
        cv = Canvas(width, height)
        render_oscilloscope_frame(cv, snaps["oscilloscope"], stream)
        emit("oscilloscope", cv.to_srgb_u8())

    if "stereometer" in snaps:
        from openmeters_tpu_torch.views import CorrelationTrail

        st = snaps["stereometer"]
        cv = Canvas(height, height)
        cloud = np.asarray(st.points)[stream, 0]  # full-band cloud [target, 2]
        ok = bool(np.asarray(st.points_valid)[stream])
        render_stereometer_frame(
            cv, cloud, np.full((cloud.shape[0],), ok, bool)
        )
        # full-band correlation trail across the series -> right-edge meter
        trail = CorrelationTrail()
        for hop in series:
            sm = hop["stereometer"]
            if bool(np.asarray(sm.points_valid)[stream]):
                trail.push_front(float(np.asarray(sm.correlations)[stream, 0]))
        render_correlation_meter(cv, trail, x0=cv.width - 10.0, x1=cv.width - 2.0)
        emit("stereometer", cv.to_srgb_u8())

    if "waveform" in snaps:
        from openmeters_tpu_torch.views import WaveformHistory

        hist = WaveformHistory(width)
        for hop in series:
            hist.push_snapshot(hop["waveform"], stream)
        cv = Canvas(width, height)
        render_waveform_frame(cv, hist.columns)
        emit("waveform", cv.to_srgb_u8())

    if "loudness" in snaps:
        ld = snaps["loudness"]
        cv = Canvas(max(width // 3, 240), height)
        render_loudness_frame(
            cv,
            momentary_lufs=float(np.asarray(ld.momentary_lufs)[stream]),
            short_term_lufs=float(np.asarray(ld.short_term_lufs)[stream]),
            integrated_lufs=float(np.asarray(ld.integrated_lufs)[stream]),
            true_peak_db=float(np.max(np.asarray(ld.true_peak_db)[stream])),
        )
        emit("loudness", cv.to_srgb_u8())

    return written
