"""Live render consumer: the headless analogue of the reference's render
loop (port of ``render_live.py``).

In the reference, the frame clock advances the engine on ``RedrawRequested``
and each visual's widget draws the newest processor state through a wgpu
pipeline every frame (``ui/widgets/frame_clock.rs:102-151`` →
``visuals/*/render.rs``).  Here the serving loop owns the hop cadence and a
display-rate consumer rides the drain callback: it feeds incremental view
state (correlation trail, reassigned splat scroll) from every drained fetch,
and at its own frame interval rasterizes each active visual with the
:mod:`openmeters_tpu_torch.render` pipelines, presenting to PNG files (atomic
tmp+rename, so a file watcher always sees complete frames) instead of a
surface.

Data sources per pane mirror the reference's state split:

- loudness / correlation: packed meter leaves from the drained fetch
  (available in both ``fetch='meters'`` and ``'full'`` modes);
- classic spectrogram / waveform: the ``declare_view`` host history rings —
  fed by the drain in ``fetch='full'`` mode (the GPU column ring analogue,
  ``spectrogram/render.rs`` history buffer);
- reassigned spectrogram: a scrolling splat-accumulated power image built
  incrementally from the drained point columns (the ``Rg16Float``
  accumulation texture analogue, ``spectrogram.wgsl:216-225``);
- spectrum / oscilloscope: the display-clock bulk fetches
  (:meth:`MeterServer.fetch_spectrum` / ``fetch_osc_traces``) of the shown
  stream's rows — one device transfer per rendered frame, never on the hop
  path (``frame_clock.rs:102-118`` semantics).

Every pane reads numpy: the drained meters (``last_meters()``), the host
history rings and the ``fetch_*`` snapshots, which the server copies off
the card; the rasterization is host work.
"""

from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["LiveRenderer", "attach_render_consumer"]


def _find(meters: dict, visual: str, field: str):
    """The packed leaf for one snapshot field (keys are pytree paths like
    ``['loudness'].momentary_lufs``; ``field`` matches the leaf name suffix
    so ``valid`` never aliases ``point_valid``)."""
    return next(
        (
            v
            for k, v in meters.items()
            if visual in k and (k.endswith("." + field) or k.endswith(field + "']"))
        ),
        None,
    )


class LiveRenderer:
    """Persistent per-consumer view state + the per-frame rasterization.

    One instance per output directory; the view ballistics that the
    reference keeps in per-visual ``state.rs`` objects (correlation trail,
    spectrum peak label, splat accumulation) live here so they evolve at
    the consumer's own display rate across frames."""

    def __init__(self, server, out_dir: str, stream: int = 0,
                 width: int = 960, height: int = 540, theme=None):
        from openmeters_tpu_torch.themes import BUILTIN_THEMES
        from openmeters_tpu_torch.views import CorrelationTrail, SpectrumPeakLabel

        os.makedirs(out_dir, exist_ok=True)
        self.server = server
        self.out_dir = out_dir
        self.stream = stream
        self.width = width
        self.height = height
        self.theme = theme or BUILTIN_THEMES["default"]
        self.frames = 0  # rendered frame count (tests / stats)

        # pre-ingest retention feedback: bound the host rings to exactly
        # the display width (registry.rs:181-209)
        server.declare_view(
            stream=stream, spectrogram_columns=width, waveform_columns=width
        )

        self._trail = CorrelationTrail()
        sp_cfg = getattr(server.engine.config, "spectrum", None)
        self._peak = SpectrumPeakLabel(
            floor_db=float(sp_cfg.floor_db) if sp_cfg is not None else -99.9
        )
        # reassigned splat scroll: [width, height] power image, newest
        # column at the right edge, frequency on the render scale
        self._reassigned = None

    # -- drain-rate incremental feeds ------------------------------------

    def feed(self, server) -> None:
        """Consume one drained fetch: advance the trail and the reassigned
        scroll.  Called per drain (hop rate), cheap — no rasterization."""
        meters = server.last_meters()
        if not meters:
            return
        corr = _find(meters, "stereometer", "correlations")
        ok = _find(meters, "stereometer", "points_valid")
        if corr is not None and ok is not None and bool(ok[self.stream]):
            self._trail.push_front(float(corr[self.stream, 0]))
        self._feed_reassigned(meters)

    def _feed_reassigned(self, meters: dict) -> None:
        sg = self.server.engine.analyzers.get("spectrogram")
        if sg is None or not sg.config.use_reassignment:
            self._reassigned = None
            return
        valid = _find(meters, "spectrogram", "valid")
        power = _find(meters, "spectrogram", "power")
        if valid is None or power is None:
            return  # fetch='meters' ships no bulk columns
        st = self.stream
        cols = np.asarray(valid[st], bool)
        k = int(cols.sum())
        img = self._reassigned
        if img is None or img.shape != (self.width, self.height):
            img = np.zeros((self.width, self.height), np.float32)
        if k:
            from openmeters_tpu_torch.views import reassigned_accumulate

            img = np.roll(img, -k, axis=0)
            img[-k:] = 0.0
            idx = np.nonzero(cols)[0]
            toff = np.asarray(
                _find(meters, "spectrogram", "time_offset")[st][idx],
                np.float32,
            )
            # column j of this batch lands j hops before the newest edge
            t = (
                self.width - k
                + np.arange(k, dtype=np.float32)[:, None]
                + toff
            )
            pv = np.asarray(
                _find(meters, "spectrogram", "point_valid")[st][idx], bool
            ) & (t >= -0.5)
            img += reassigned_accumulate(
                np.asarray(_find(meters, "spectrogram", "freq_hz")[st][idx]),
                t,
                np.asarray(power[st][idx]),
                pv,
                time_bins=self.width,
                freq_lo_hz=20.0,
                freq_hi_hz=20_000.0,
                freq_bins=self.height,
                power_scale=sg.power_scale,
            )
        self._reassigned = img

    # -- frame-rate rasterization -----------------------------------------

    def set_theme(self, theme) -> None:
        """Swap the live theme (apply_theme analogue, ui/app.rs:142-146);
        takes effect at the next rendered frame."""
        self.theme = theme

    def render(self) -> list[str]:
        """Rasterize every active visual to ``{out_dir}/{visual}.png``.
        Returns the written paths."""
        written = []
        meters = self.server.last_meters() or {}
        for name, fn in (
            ("loudness", self._frame_loudness),
            ("spectrogram", self._frame_spectrogram),
            ("spectrum", self._frame_spectrum),
            ("oscilloscope", self._frame_oscilloscope),
            ("stereometer", self._frame_stereometer),
            ("waveform", self._frame_waveform),
        ):
            if name not in self.server.engine.analyzers:
                continue
            img = fn(meters)
            if img is None:
                continue
            written.append(self._present(name, img))
        self.frames += 1
        return written

    def _present(self, name: str, img_u8: np.ndarray) -> str:
        """Atomic tmp+rename write (persistence.rs:13-20 discipline): a
        watching consumer never reads a torn frame."""
        from openmeters_tpu_torch.render import encode_png

        path = os.path.join(self.out_dir, f"{name}.png")
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(encode_png(img_u8))
        os.replace(tmp, path)
        return path

    def _frame_loudness(self, meters: dict):
        from openmeters_tpu_torch.render import Canvas, render_loudness_frame

        mom = _find(meters, "loudness", "momentary_lufs")
        if mom is None:
            return None
        st = self.stream
        cv = Canvas(max(self.width // 3, 240), self.height)
        render_loudness_frame(
            cv,
            bar_colors=(
                self.theme.stroke("loudness", 1.0),
                self.theme.stroke("loudness", 0.0),
            ),
            momentary_lufs=float(mom[st]),
            short_term_lufs=float(
                _find(meters, "loudness", "short_term_lufs")[st]
            ),
            integrated_lufs=float(
                _find(meters, "loudness", "integrated_lufs")[st]
            ),
            true_peak_db=float(
                np.max(_find(meters, "loudness", "true_peak_db")[st])
            ),
        )
        return cv.to_srgb_u8()

    def _frame_spectrogram(self, meters: dict):
        sg = self.server.engine.analyzers.get("spectrogram")
        if sg is None:
            return None
        if sg.config.use_reassignment:
            if self._reassigned is None:
                return None
            from openmeters_tpu_torch.render import (
                DB_ANALYSIS_FLOOR,
                compose_rgba,
                shade_db,
            )

            power_img = self._reassigned.T[::-1]  # freq up, newest right
            db = np.where(
                power_img > 0.0,
                np.maximum(
                    10.0 * np.log10(np.maximum(power_img, 1e-20)),
                    DB_ANALYSIS_FLOOR,
                ),
                -np.inf,
            )
            rgba = shade_db(db, DB_ANALYSIS_FLOOR, self.theme.palette("spectrogram"))
            rgba *= (power_img > 0.0)[..., None]
            return compose_rgba(rgba.astype(np.float32))
        hist = self.server._view_histories.get("spectrogram")  # noqa: SLF001
        if hist is None or hist.filled == 0:
            return None
        from openmeters_tpu_torch.analyzers.spectrogram import (
            CLASSIC_DB_STORE_LO,
            CLASSIC_DB_STORE_RANGE,
        )
        from openmeters_tpu_torch.render import (
            compose_rgba,
            render_spectrogram_classic,
        )

        db = (
            hist.view().astype(np.float32) * (CLASSIC_DB_STORE_RANGE / 65535.0)
            + CLASSIC_DB_STORE_LO
        )
        rgba = render_spectrogram_classic(
            db,
            sample_rate=self.server.engine.config.sample_rate,
            fft_size=sg.config.fft_size,
            width=self.width,
            height=self.height,
            palette=self.theme.palette("spectrogram"),
        )
        return compose_rgba(rgba)

    def _frame_spectrum(self, meters: dict):
        snap = self.server.fetch_spectrum(stream=self.stream)
        if snap is None:
            return None
        from openmeters_tpu_torch.render import Canvas, render_spectrum_frame
        from openmeters_tpu_torch.utils.frequency import FrequencyScale
        from openmeters_tpu_torch.views import (
            SPECTRUM_MIN_FREQUENCY,
            spectrum_grid_ticks,
            spectrum_points,
        )

        cfg = self.server.engine.config
        scfg = cfg.spectrum.normalized()
        bins_hz = (
            np.arange(scfg.fft_size // 2 + 1, dtype=np.float32)
            * cfg.sample_rate
            / scfg.fft_size
        )
        db = np.asarray(snap.weighted_db)[0, 0]  # the one stream fetched
        scale = FrequencyScale.LOGARITHMIC
        cv = Canvas(self.width, self.height)
        pts, valid = spectrum_points(
            db, bins_hz, scale, floor_db=float(scfg.floor_db)
        )
        self._peak.update(bins_hz, db, scale)  # live decay across frames
        render_spectrum_frame(
            cv, pts, valid,
            color=self.theme.stroke("spectrum"),
            ticks=spectrum_grid_ticks(
                SPECTRUM_MIN_FREQUENCY, float(bins_hz[-1]), scale
            ),
            peak_marker=self._peak.marker_pos if self._peak.content else None,
            peak_opacity=self._peak.opacity,
        )
        return cv.to_srgb_u8()

    def _frame_oscilloscope(self, meters: dict):
        snap = self.server.fetch_osc_traces(stream=self.stream)
        if snap is None:
            return None
        from openmeters_tpu_torch.render import Canvas, render_oscilloscope_frame

        cv = Canvas(self.width, self.height)
        render_oscilloscope_frame(
            cv, snap, 0,  # the one stream fetched
            colors=(
                self.theme.stroke("oscilloscope", 1.0),
                self.theme.stroke("oscilloscope", 0.0),
            ),
        )
        return cv.to_srgb_u8()

    def _frame_stereometer(self, meters: dict):
        from openmeters_tpu_torch.render import (
            Canvas,
            render_correlation_meter,
            render_stereometer_frame,
        )

        pts = _find(meters, "stereometer", "points")
        ok = _find(meters, "stereometer", "points_valid")
        cv = Canvas(self.height, self.height)
        if pts is not None and ok is not None and pts.ndim >= 3:
            cloud = np.asarray(pts[self.stream, 0])
            valid = np.full((cloud.shape[0],), bool(ok[self.stream]), bool)
            render_stereometer_frame(
                cv, cloud, valid, color=self.theme.stroke("stereometer")
            )
        elif len(self._trail.values) == 0:
            return None  # meters mode before any correlation arrived
        render_correlation_meter(
            cv, self._trail, x0=cv.width - 10.0, x1=cv.width - 2.0
        )
        return cv.to_srgb_u8()

    def _frame_waveform(self, meters: dict):
        hist = self.server._view_histories.get("waveform")  # noqa: SLF001
        if hist is None or not hist.columns:
            return None
        from openmeters_tpu_torch.render import Canvas, render_waveform_frame

        cv = Canvas(self.width, self.height)
        render_waveform_frame(
            cv, hist.columns, fallback_color=self.theme.stroke("waveform")
        )
        return cv.to_srgb_u8()


def attach_render_consumer(
    server, out_dir: str, stream: int = 0, every: float = 0.5,
    width: int = 960, height: int = 540, theme=None,
) -> LiveRenderer:
    """Attach a live PNG render consumer to a running :class:`MeterServer`.

    Composes with any existing drain consumer (TUI, settings watcher) the
    same way ``attach_settings_watcher`` does; feeds incremental view state
    every drain and rasterizes at most every ``every`` seconds.  Bulk panes
    (classic spectrogram / waveform / Lissajous cloud) need the server in
    ``fetch='full'`` mode — in ``'meters'`` mode the consumer renders the
    loudness bars, correlation meter, spectrum, and oscilloscope panes from
    the display-clock fetches alone."""
    r = LiveRenderer(server, out_dir, stream=stream, width=width,
                     height=height, theme=theme)
    # the theme is resolved once, here: nothing reloads it while serving
    # (``set_theme`` swaps it for a caller that holds the renderer)
    server.live_renderer = r
    prev = server.on_drain
    state = {"next": 0.0}

    def on_drain(s):
        if prev is not None:
            prev(s)
        r.feed(s)
        now = time.monotonic()
        if now >= state["next"]:
            state["next"] = now + every
            r.render()

    server.on_drain = on_drain
    return r
