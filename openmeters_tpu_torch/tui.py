"""Live terminal meters: the UI layer's headless analogue (SURVEY §2.14;
port of ``tui.py``).

The reference renders its meters in an iced GUI at display rate
(``src/ui/app.rs``, frame clock ``ui/widgets/frame_clock.rs``); the rebuild
is headless, so this module gives ``serve`` a terminal view instead: a pure
formatter from the server's drained meter leaves (``MeterServer.
last_meters()``) to an ANSI frame, plus a small stateful view owning the
display ballistics the reference keeps in its view models — loudness
peak-hold (loudness/state.rs:20-59 via :class:`views.PeakHold`) and the
correlation trail (stereometer/render.rs:63-76 via
:class:`views.CorrelationTrail`).

Everything is plain strings — testable without a terminal; the CLI decides
whether to add cursor-home escapes.
"""

from __future__ import annotations

import numpy as np

from openmeters_tpu_torch.views import CorrelationTrail, PeakHold

BLOCKS = " ▏▎▍▌▋▊▉█"  # 1/8th blocks (horizontal)
VBLOCKS = " ▁▂▃▄▅▆▇█"  # 1/8th blocks (vertical, for sparklines)

# key-toggle order == EngineConfig analyzer fields; keys '1'..'6' in
# attach_key_controls map to these (the headless config page's visual
# toggles, ui/config.rs visual checkboxes)
ANALYZERS = (
    "loudness", "spectrogram", "spectrum",
    "oscilloscope", "stereometer", "waveform",
)


def _bar(value: float, lo: float, hi: float, width: int) -> str:
    """Left-to-right level bar with 1/8th-block resolution."""
    t = 0.0 if hi <= lo else (float(value) - lo) / (hi - lo)
    t = min(max(t, 0.0), 1.0)
    cells = t * width
    full = int(cells)
    frac = int((cells - full) * 8)
    s = "█" * full
    if full < width and frac:
        s += BLOCKS[frac]
    return s.ljust(width)


def _center_bar(value: float, width: int) -> str:
    """[-1, +1] bar growing from the center (correlation meter)."""
    v = min(max(float(value), -1.0), 1.0)
    half = width // 2
    n = int(round(abs(v) * half))
    left = ("█" * n).rjust(half) if v < 0 else " " * half
    right = ("█" * n).ljust(half) if v >= 0 else " " * half
    return left + "│" + right


def _marker_bar(value: float, hold: float, lo: float, hi: float, width: int) -> str:
    """Level bar plus a peak-hold tick at ``hold``."""
    s = list(_bar(value, lo, hi, width))
    if hi > lo:
        t = (min(max(float(hold), lo), hi) - lo) / (hi - lo)
        i = min(int(t * width), width - 1)
        if s[i] == " ":
            s[i] = "▕"
    return "".join(s)


def _sparkline(db_bins, lo_db: float, hi_db: float, width: int,
               sample_rate: float, f_lo: float = 20.0) -> str:
    """Log-frequency sparkline of one trace's dB bins: ``width`` buckets
    spaced geometrically from ``f_lo`` to Nyquist, max-reduced per bucket
    (the spectrum view's log x-scale, spectrum/state.rs:26-120, collapsed
    to one character of height per bucket)."""
    db = np.asarray(db_bins, np.float32).ravel()
    bins = db.shape[0]
    if bins < 2:
        return " " * width
    nyq = sample_rate / 2.0
    f_lo = min(max(f_lo, nyq / (bins - 1)), nyq * 0.5)
    edges = np.geomspace(f_lo, nyq, width + 1)
    idx = np.clip((edges / nyq * (bins - 1)).astype(int), 0, bins - 1)
    out = []
    for i in range(width):
        a = idx[i]
        b = max(idx[i + 1], a + 1)
        t = (float(db[a:b].max()) - lo_db) / (hi_db - lo_db)
        out.append(VBLOCKS[min(max(int(t * 8), 0), 8)])
    return "".join(out)


def _pick(meters: dict, part: str):
    """First packed leaf whose keystr path contains ``part`` (layout keys
    look like ``['loudness'].momentary_lufs``)."""
    for key, arr in meters.items():
        if part in key:
            return np.asarray(arr)
    return None


class TuiView:
    """Stateful display: ballistics across frames for one stream."""

    def __init__(self, stream: int = 0, width: int = 40,
                 sample_rate: float = 48_000.0):
        self.stream = int(stream)
        self.width = int(width)
        self.sample_rate = float(sample_rate)
        self._tp_hold = PeakHold.new((1,), floor_db=-60.0)
        self._trail = CorrelationTrail()

    def render(self, meters: dict, now: float, spectrum=None, spectrum_row: int | None = None) -> str:
        """Format one frame.  ``spectrum`` is an optional SpectrumSnapshot
        (numpy pytree from ``MeterServer.fetch_spectrum``) rendered as a
        log-frequency sparkline pane; ``spectrum_row`` is its row of the
        shown stream (default: the stream's index; 0 for a snapshot fetched
        with ``stream=``)."""
        s, w = self.stream, self.width
        lines = []

        def val(part: str):
            arr = _pick(meters, part)
            if arr is None:
                return None
            flat = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr[:, None]
            return flat[s] if s < flat.shape[0] else None

        mom = val("momentary_lufs")
        if mom is not None:
            lines.append(f"M  {_bar(mom[0], -60, 0, w)} {mom[0]:7.1f} LUFS")
        st = val("short_term_lufs")
        if st is not None:
            lines.append(f"S  {_bar(st[0], -60, 0, w)} {st[0]:7.1f} LUFS")
        tp = val("true_peak_db")
        if tp is not None:
            cur = float(np.max(tp))
            hold = float(self._tp_hold.update(np.float32([cur]), now)[0])
            lines.append(
                f"TP {_marker_bar(cur, hold, -60, 6, w)} {cur:7.1f} dBTP"
            )
        corr = val("correlations")
        if corr is not None:
            self._trail.push_front(float(corr[0]))
            lines.append(f"C  {_center_bar(corr[0], w)} {corr[0]:+7.2f}")
        per = val("period")
        if per is not None and per[0] > 0:
            f0 = self.sample_rate / float(per[0])
            lines.append(f"f0 {f0:7.1f} Hz")
        if spectrum is not None:
            raw = np.asarray(spectrum.raw_db)
            row = s if spectrum_row is None else spectrum_row
            if row < raw.shape[0]:
                trace = raw[row, 0]
                lines.append(
                    f"SP {_sparkline(trace, -100.0, 0.0, w, self.sample_rate)}"
                    f" {float(trace.max()):6.1f} dB pk"
                )
        return "\n".join(lines)


def serve_tui_callback(stream: int = 0, width: int = 40, min_interval: float = 1 / 15):
    """Build a ``MeterServer.on_drain`` callback that repaints a terminal
    frame (stderr, cursor-home) at most every ``min_interval`` seconds —
    the frame-clock cadence of the reference UI (frame_clock.rs:17-151)."""
    import sys
    import time

    view = TuiView(stream=stream, width=width)
    state = {"next": 0.0}

    def on_drain(server) -> None:
        now = time.perf_counter()
        if now < state["next"]:
            return
        state["next"] = now + min_interval
        view.sample_rate = float(server.engine.config.sample_rate)
        meters = server.last_meters()
        if not meters:
            return
        spectrum = None
        if view.stream < server.config.n_streams:
            # display-clock bulk read of the shown stream's rows (one transfer)
            spectrum = server.fetch_spectrum(stream=view.stream)
        frame = view.render(meters, now, spectrum=spectrum, spectrum_row=0)
        r = server.stats
        head = (
            f"openmeters_tpu_torch serve — {server.config.n_streams} streams, "
            f"stream #{view.stream}, "
            f"hop {server.engine.config.block_frames}, "
            f"{r.hops} hops, {r.resets} resets"
        )
        # the config-page analogue's toggle legend: key -> analyzer, filled
        # dot = enabled (ui/config.rs visual checkboxes)
        toggles = " ".join(
            f"[{i + 1}{'●' if name in server.engine.analyzers else '○'}]{name[:5]}"
            for i, name in enumerate(ANALYZERS)
        )
        if server.reconfig_pending:
            toggles += "  (reconfiguring…)"
        sys.stderr.write(
            "\x1b[H\x1b[2J" + head + "\n" + toggles + "\n\n" + frame + "\n"
        )
        sys.stderr.flush()

    on_drain.view = view  # key controls steer the same view (stream cycling)
    return on_drain


def _default_analyzer_config(name: str):
    """The stock EngineConfig's config object for one analyzer field —
    used to re-enable a visual that was disabled before this process saw
    its config (the reference's config page re-enables with the persisted
    per-visual settings; without a stash the defaults are what it has)."""
    import dataclasses

    from openmeters_tpu_torch.engine import EngineConfig

    for f in dataclasses.fields(EngineConfig):
        if f.name == name:
            if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                return f.default_factory()  # type: ignore[misc]
            return f.default
    raise KeyError(name)


def toggle_analyzer(server, name: str, stash: dict | None = None) -> bool:
    """Enable/disable one analyzer on a RUNNING server — the headless
    config-page visual toggle (ui/config.rs checkboxes →
    registry.rs set_enabled).  Disabling stashes the analyzer's current
    config in ``stash`` so a re-enable restores its settings (the
    reference keeps per-visual settings across toggles in persistence);
    re-enabling without a stash entry uses the stock default.

    The swap rides :meth:`MeterServer.apply_settings_async` (background
    compile, hop-boundary adoption, field-level state retention for the
    untouched analyzers).  Returns True when a reconfiguration was
    launched; False when refused (unknown name, a reconfiguration already
    in flight, or the toggle would disable the last enabled analyzer).
    """
    import dataclasses

    if name not in ANALYZERS or server.reconfig_pending:
        return False
    cfg = server.engine.config
    cur = getattr(cfg, name)
    if cur is not None:
        enabled = [a for a in ANALYZERS if getattr(cfg, a) is not None]
        if len(enabled) <= 1:
            return False  # an engine with zero analyzers cannot serve
        if stash is not None:
            stash[name] = cur
        new_cfg = dataclasses.replace(cfg, **{name: None})
    else:
        restored = (stash or {}).get(name) or _default_analyzer_config(name)
        new_cfg = dataclasses.replace(cfg, **{name: restored})
    server.apply_settings_async(new_cfg)  # its warm-up thread is not joined
    return True


def attach_key_controls(server, source=None, view=None):
    """Keyboard shortcuts for a serving loop — the reference binds
    ctrl+space (toggle DSP pause) and close/quit at the UI layer
    (ui/app/message.rs:59-83) and toggles visuals on its config page
    (ui/config.rs); the headless mapping reads single keys from ``source``
    (default stdin) without blocking the hop cadence:

    - ``p`` or space: toggle global pause (``MeterServer.set_paused``,
      meter.rs:126-142 — the transport keeps timing gaps so resume
      synthesizes the missed span as silence, no stale backlog burst)
    - ``q``: stop the running ``run()`` loop after the current hop
    - ``1``..``6``: toggle an analyzer live (:func:`toggle_analyzer` —
      background compile, hop-boundary swap; settings stashed across
      toggles)
    - ``s``/``S``: cycle the TUI's displayed stream forward/backward
      (needs ``view``, e.g. ``serve_tui_callback(...).view``)

    Rides ``on_tick`` (every loop iteration), NOT ``on_drain``: a paused
    server stops draining, so a drain-hooked unpause key would never be
    read again.  The CLI puts a real terminal into cbreak mode first;
    tests feed a pipe.  Returns the composed callback.
    """
    import os
    import sys

    src = source if source is not None else sys.stdin
    fd = src.fileno()
    os.set_blocking(fd, False)
    prev = server.on_tick
    stash: dict = {}

    def on_tick(s) -> None:
        if prev is not None:
            prev(s)
        try:
            data = os.read(fd, 16)
        except (BlockingIOError, OSError):
            return
        if not data:
            return
        for ch in data.decode("ascii", "ignore"):
            if ch in (" ", "p"):
                s.set_paused(not s.paused)
            elif ch == "q":
                s.stop()
            elif ch in "123456":
                toggle_analyzer(s, ANALYZERS[int(ch) - 1], stash)
            elif ch in ("s", "S") and view is not None:
                step = 1 if ch == "s" else -1
                view.stream = (view.stream + step) % s.config.n_streams

    server.on_tick = on_tick
    return on_tick
