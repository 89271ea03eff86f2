"""CLI: headless analysis, serving and diagnostics on the card (port of
``__main__.py``)::

    python -m openmeters_tpu_torch analyze tone.wav [--settings settings.json]
    python -m openmeters_tpu_torch render tone.wav out_dir/ [--settings ...]
    python -m openmeters_tpu_torch serve [--socket PATH --rates 44100,48000]
    python -m openmeters_tpu_torch serve --tui --render-dir frames/ --fetch full
    python -m openmeters_tpu_torch themes list|show|create|set-stop|delete
    python -m openmeters_tpu_torch settings --init settings.json
    python -m openmeters_tpu_torch selftest
    python -m openmeters_tpu_torch precompile

Every command that computes runs on the card (``--device cuda``, the
default) and raises where no card is present, unless given ``--device
cpu``.  The meters are computed on the device; the display layers
(``render``, ``serve --tui`` and ``--render-dir``) draw them on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _device(args) -> torch.device:
    """The command's device; ``cuda`` with no card present raises."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to run on the CPU")
    return dev


def cmd_analyze(args) -> int:
    from openmeters_tpu_torch.analyzers.spectrogram import unpack_classic_db
    from openmeters_tpu_torch.api import analyze_wav
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.persistence import SettingsHandle

    cfg = SettingsHandle.load_or_default(args.settings) if args.settings else EngineConfig()
    snaps = analyze_wav(args.wav, cfg, device=_device(args))
    if not snaps:
        print("no complete hops in input", file=sys.stderr)
        return 1
    last = snaps[-1]
    out = {}
    if "loudness" in last:
        l = last["loudness"]
        out["loudness"] = {
            "short_term_lufs": float(l.short_term_lufs[0]),
            "momentary_lufs": float(l.momentary_lufs[0]),
            "true_peak_db": float(np.max(_np(l.true_peak_db[0]))),
        }
    if "spectrum" in last:
        out["spectrum"] = {"peak_bin_db": float(np.max(_np(last["spectrum"].raw_db[0, 0])))}
    if "spectrogram" in last:
        sg = last["spectrogram"]
        if hasattr(sg, "codes"):
            codes, valid = _np(sg.codes[0]), _np(sg.valid[0])
            if valid.any():
                col = codes[np.nonzero(valid)[0][-1]]
                out["spectrogram"] = {"peak_db": float(np.max(unpack_classic_db(col)))}
    if "oscilloscope" in last:
        osc = last["oscilloscope"]
        out["oscilloscope"] = {
            "locked": bool(_np(osc.locked[0]).any()),
            "period_samples": float(_np(osc.period[0]).max()),
        }
    if "stereometer" in last:
        out["stereometer"] = {"correlation": float(last["stereometer"].correlations[0, 0])}
    out["hops"] = len(snaps)
    print(json.dumps(out, indent=None if args.compact else 2))
    return 0


def _serving_engine_config(args):
    """The engine config a serving command runs: ``--settings`` (any
    persisted configuration, lossy schema) over ``--config default`` (the
    stock ``EngineConfig()``) over ``--config serve`` (the lean classic
    spectrogram throughput config), at the transport's 2 channels."""
    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.persistence import SettingsHandle

    if args.settings:
        return dataclasses.replace(SettingsHandle.load_or_default(args.settings), channels=2)
    if args.config == "default":
        return EngineConfig(channels=2)
    return EngineConfig(
        channels=2,
        spectrogram=SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False),
        spectrum=None,
    )


def cmd_serve(args) -> int:
    """Run the serving loop: with the native tone feeder standing in for
    producers (also the serving benchmark), or, with ``--socket``, for
    external producers over the session runtime."""
    from openmeters_tpu_torch.ingest import Feeder
    from openmeters_tpu_torch.serve import (
        MeterServer,
        MultiRateMeterServer,
        ServeConfig,
        attach_settings_watcher,
        ingest_benchmark,
    )

    if args.socket and (args.tui or args.render_dir):
        print("--tui and --render-dir show one served stream: they do not combine with --socket",
              file=sys.stderr)
        return 2
    if args.watch_settings and not args.settings:
        print("--watch-settings requires --settings", file=sys.stderr)
        return 2
    if args.ingest_only:
        report = ingest_benchmark(
            n_streams=args.streams, duration_s=args.duration, feeder_threads=args.feeder_threads,
            assembler_shards=args.assembler_shards, realtime=not args.flat_out,
        )
        print(json.dumps(report))
        return 0
    device = _device(args)
    serve_cfg = ServeConfig(
        n_streams=args.streams, channels=2, engine=_serving_engine_config(args),
        realtime=not args.flat_out, fetch=args.fetch, assembler_shards=args.assembler_shards,
        scan_hops=args.scan_hops,
    )

    if args.socket:
        # external producers connect over the unix socket: identity
        # routing, one engine a rate bucket
        rates = tuple(float(r) for r in args.rates.split(","))
        server = MultiRateMeterServer(serve_cfg, rates, socket_path=args.socket, device=device)
        try:
            if args.watch_settings:
                # each bucket's watcher pins its own rate and block
                for bucket in server.servers.values():
                    attach_settings_watcher(bucket, args.settings)
            report = server.run(args.duration)
            view = server.runtime.view()
        finally:
            server.close()
        report["links"] = view["links"]
        print(json.dumps(report, default=str))
        return 0

    server = MeterServer(serve_cfg, device=device)
    signals: list[int] = []
    if args.checkpoint:
        # resume the meters' state across restarts; SIGTERM and SIGINT stop
        # the loop at its next tick, and the carry is saved on the way out
        # (never from the handler: the step updates the carry in place)
        import os
        import signal

        restored = os.path.exists(args.checkpoint)
        if restored:
            server.restore(args.checkpoint)

        def _on_signal(signum, frame):  # noqa: ARG001
            signals.append(signum)

        def _on_tick(s):
            if signals:
                s.stop()

        server.on_tick = _on_tick
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
        if restored:  # said once a signal would be honoured
            print(f"# restored carry from {args.checkpoint}", file=sys.stderr, flush=True)
    restore_term = None
    if args.tui:
        from openmeters_tpu_torch.tui import attach_key_controls, serve_tui_callback

        # a paint at display rate on stderr; composed before the watcher
        server.on_drain = serve_tui_callback(stream=args.tui_stream)
        if sys.stdin.isatty():
            # keys: p or space pauses, q quits, 1-6 toggle an analyzer live,
            # s/S cycle the stream shown; cbreak so they arrive unbuffered
            import termios
            import tty

            fd = sys.stdin.fileno()
            saved = termios.tcgetattr(fd)
            tty.setcbreak(fd)

            def restore_term():
                termios.tcsetattr(fd, termios.TCSADRAIN, saved)

            attach_key_controls(server, view=server.on_drain.view)
    if args.watch_settings:
        attach_settings_watcher(server, args.settings)
    if args.render_dir:
        # every active visual to PNGs at display rate; the bulk panes
        # (classic spectrogram, waveform, Lissajous cloud) need --fetch full
        from openmeters_tpu_torch.render_live import attach_render_consumer

        attach_render_consumer(
            server, args.render_dir, stream=args.tui_stream, every=args.render_every,
            theme=_resolve_theme(args.theme, args.themes_dir, args.settings),
        )
    feeder = Feeder(server.transport, n_threads=args.feeder_threads, frames_per_push=1024)
    try:
        report = server.run(args.duration)
    finally:
        if restore_term is not None:
            restore_term()
        ok, failed = feeder.stop()
        if args.checkpoint:
            server.checkpoint(args.checkpoint)
        server.close()
    if signals:
        return 128 + signals[0]
    report["feeder_pushes_ok"] = ok
    report["feeder_pushes_failed"] = failed
    server.stats.log_summary()
    print(json.dumps(report))
    return 0


def cmd_render(args) -> int:
    """Analyze a WAV on the device and rasterize every active visual to PNG
    files on the host: the final snapshot, and the time-scrolling panes'
    history across the whole file."""
    from openmeters_tpu_torch.api import analyze
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.io.wav import read_wav
    from openmeters_tpu_torch.persistence import SettingsHandle
    from openmeters_tpu_torch.render import render_series

    cfg = SettingsHandle.load_or_default(args.settings) if args.settings else EngineConfig()
    samples, rate = read_wav(args.wav)
    # the engine analyzes at the WAV's own rate; the renderer maps bins to Hz
    # with that rate too
    cfg = dataclasses.replace(cfg, sample_rate=rate)
    snaps = analyze(samples, rate, cfg, device=_device(args))
    if not snaps:
        print("no complete hops in input", file=sys.stderr)
        return 1
    for path in render_series(snaps, cfg, args.out, width=args.width, height=args.height):
        print(path)
    return 0


def cmd_precompile(args) -> int:
    """Build what a ``serve`` process would build at its start (the CUDA
    kernel library on the card, the transport library) and warm a
    ``MeterServer`` of the serving config, so a deployment builds once.
    Prints the seconds of each and the build directory."""
    import time

    from openmeters_tpu_torch.ingest import transport
    from openmeters_tpu_torch.ops import _build
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig

    device = _device(args)
    t0 = time.perf_counter()
    transport._get_lib()  # noqa: SLF001
    if device.type == "cuda":
        _build.load_library()
    t1 = time.perf_counter()
    server = MeterServer(
        ServeConfig(n_streams=args.streams, channels=2, engine=_serving_engine_config(args),
                    scan_hops=args.scan_hops),
        device=device,
    )
    server.close()
    t2 = time.perf_counter()
    print(json.dumps({
        "build_s": round(t1 - t0, 2),
        "warm_s": round(t2 - t1, 2),
        "build_dir": str(_build.BUILD_DIR),
        "device": str(device),
        "config": args.config,
        "streams": args.streams,
        "scan_hops": args.scan_hops,
    }))
    return 0


def cmd_settings(args) -> int:
    from openmeters_tpu_torch.engine import EngineConfig
    from openmeters_tpu_torch.persistence import UiSettings, encode_settings, encode_ui, write_json_atomic

    doc = encode_settings(EngineConfig())
    doc["ui"] = encode_ui(UiSettings())
    write_json_atomic(args.init, doc)
    print(f"wrote default settings to {args.init}")
    return 0


def _resolve_theme(name, themes_dir, settings_path):
    """The live theme: ``--theme`` if given, else the persisted ``ui.theme``
    of ``--settings``, else the builtin default.  Resolved once, at start."""
    from openmeters_tpu_torch.persistence import SettingsHandle
    from openmeters_tpu_torch.themes import BUILTIN_THEMES, ThemeStore

    if name is None and settings_path:
        name = SettingsHandle.load_ui_or_default(settings_path).theme
    if name is None or name == "default":
        return BUILTIN_THEMES["default"]
    return ThemeStore(themes_dir).load(name)


def _parse_color(text: str):
    """``R,G,B[,A]`` floats in [0, 1] as an RGBA list, or ``None``."""
    try:
        rgba = [float(x) for x in text.split(",")]
    except ValueError:
        return None
    if len(rgba) == 3:
        rgba.append(1.0)
    if len(rgba) != 4 or not all(0.0 <= c <= 1.0 for c in rgba):
        return None
    return rgba


def cmd_themes(args) -> int:
    """Theme store operations: the headless palette editor
    (ui/palette_editor.rs drives the same stop edits through a GUI)."""
    from openmeters_tpu_torch.themes import BUILTIN_THEMES, VISUALS, Theme, ThemeStore
    from openmeters_tpu_torch.views import GradientPalette

    store = ThemeStore(args.dir)
    if args.action in ("show", "set-stop", "delete") and not args.name:
        print(f"themes {args.action} needs a theme name")
        return 1
    if args.action == "set-stop" and args.visual not in VISUALS:
        print(f"set-stop needs a visual out of {', '.join(VISUALS)}")
        return 1
    if args.action == "list":
        for name in store.list_themes():
            print(f"{name}{' (builtin)' if name in BUILTIN_THEMES else ''}")
        return 0
    if args.action == "show":
        theme = store.load(args.name)
        doc = {
            v: {"stops": p.colors.tolist(), "positions": p.positions.tolist(), "spreads": p.spreads.tolist()}
            for v, p in sorted(theme.palettes.items())
        }
        print(json.dumps({"name": theme.name, "palettes": doc}, indent=2))
        return 0
    if args.action == "delete":
        ok = store.delete(args.name)
        print(f"{'deleted' if ok else 'cannot delete'} {args.name}")
        return 0 if ok else 1
    if args.action == "create":
        base = store.load(args.base)
        saved = store.save(Theme(args.name or base.name, palettes=dict(base.palettes)), name=args.name)
        print(f"saved theme {saved}")
        return 0
    # set-stop
    theme = store.load(args.name)
    palette = theme.palette(args.visual)
    colors = np.array(palette.colors, np.float32)
    positions = np.array(palette.positions, np.float32)
    spreads = np.array(palette.spreads, np.float32)
    i = args.stop
    if not 0 <= i < len(colors):
        print(f"stop {i} out of range (palette has {len(colors)} stops)")
        return 1
    if args.color:
        rgba = _parse_color(args.color)
        if rgba is None:
            print(f"--color {args.color}: want R,G,B or R,G,B,A, each in [0, 1]")
            return 1
        colors[i] = rgba
    if args.position is not None and 0 < i < len(colors) - 1:
        positions[i] = args.position
    if args.spread is not None:
        spreads[i] = args.spread
    palettes = dict(theme.palettes)
    palettes[args.visual] = GradientPalette.make(colors, positions, spreads)
    saved = store.save(Theme(args.name, palettes=palettes), name=args.name)
    print(f"saved theme {saved}")
    return 0


def cmd_selftest(args) -> int:
    """Tiny end-to-end smoke: tone in, sane meters out."""
    from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu_torch.api import analyze
    from openmeters_tpu_torch.engine import EngineConfig

    rate = 48_000.0
    t = np.arange(int(rate * 0.5)) / rate
    tone = (0.5 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    cfg = EngineConfig(
        spectrogram=SpectrogramConfig(fft_size=1024, hop_size=256, use_reassignment=False),
        spectrum=None, oscilloscope=None, stereometer=None, waveform=None,
    )
    snaps = analyze(np.stack([tone, tone], -1), rate, cfg, device=_device(args))
    lufs = float(snaps[-1]["loudness"].momentary_lufs[0])
    ok = abs(lufs + 6.0) < 0.5
    print(f"momentary LUFS of -6 dBFS stereo 997 Hz tone: {lufs:.2f} ({'OK' if ok else 'FAIL'})")
    return 0 if ok else 1


def main(argv=None) -> int:
    from openmeters_tpu_torch.tracing import init_tracing

    init_tracing()
    p = argparse.ArgumentParser(prog="openmeters_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device: the card (default) or 'cpu'; no fallback")

    pa = sub.add_parser("analyze", help="analyze a WAV file")
    pa.add_argument("wav")
    pa.add_argument("--settings", help="settings JSON (lossy schema)")
    pa.add_argument("--compact", action="store_true")
    device_arg(pa)
    pa.set_defaults(fn=cmd_analyze)

    pr = sub.add_parser("render", help="render a WAV's meters to PNGs")
    pr.add_argument("wav")
    pr.add_argument("out", help="output directory for PNG frames")
    pr.add_argument("--settings", help="settings JSON (lossy schema)")
    pr.add_argument("--width", type=int, default=960)
    pr.add_argument("--height", type=int, default=540)
    device_arg(pr)
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("serve", help="run the serving loop (synthetic feed, or producers on a socket)")
    pv.add_argument("--settings", help="serve a persisted settings JSON (lossy schema) instead of a named --config")
    pv.add_argument("--config", choices=["serve", "default"], default="serve",
                    help="'serve': lean classic-spectrogram throughput config; 'default': the stock "
                    "EngineConfig() (all six analyzers, reassignment on)")
    pv.add_argument("--watch-settings", action="store_true",
                    help="hot-reload --settings while serving: an edit warms a new engine in the "
                    "background and swaps at a hop boundary, keeping the state")
    pv.add_argument("--streams", type=int, default=256)
    pv.add_argument("--duration", type=float, default=5.0)
    pv.add_argument("--fetch", choices=["meters", "full", "none"], default="meters")
    pv.add_argument("--feeder-threads", type=int, default=4)
    pv.add_argument("--assembler-shards", type=int, default=1)
    pv.add_argument("--flat-out", action="store_true", help="no pacing: measure max throughput")
    pv.add_argument("--scan-hops", type=int, default=1, help="engine hops per advance")
    pv.add_argument("--socket", help="unix socket path: serve external producers (identity routing, "
                    "per-rate buckets) instead of the synthetic feeder")
    pv.add_argument("--rates", default="48000", help="comma-separated sample-rate buckets for --socket")
    pv.add_argument("--tui", action="store_true", help="live terminal meters at display rate (stderr)")
    pv.add_argument("--tui-stream", type=int, default=0, help="stream shown by --tui and --render-dir")
    pv.add_argument("--render-dir", help="rasterize every active visual to PNGs in this directory at "
                    "display rate (bulk panes need --fetch full)")
    pv.add_argument("--render-every", type=float, default=0.5,
                    help="seconds between rendered frames for --render-dir")
    pv.add_argument("--theme", help="theme for --render-dir (default: the persisted ui.theme from "
                    "--settings, else the builtin default)")
    pv.add_argument("--themes-dir", default="themes", help="theme store directory (default: themes/)")
    pv.add_argument("--ingest-only", action="store_true", help="host-only ingest benchmark (no device work)")
    pv.add_argument("--checkpoint", help="carry checkpoint path: restore on start if it exists; save on "
                    "exit and on SIGTERM/SIGINT")
    device_arg(pv)
    pv.set_defaults(fn=cmd_serve)

    pp = sub.add_parser("precompile", help="build the kernels and the transport and warm a server, so a "
                        "production `serve` starts built")
    pp.add_argument("--streams", type=int, default=256)
    pp.add_argument("--scan-hops", type=int, default=1)
    pp.add_argument("--settings", help="precompile a persisted settings JSON")
    pp.add_argument("--config", choices=["serve", "default"], default="serve",
                    help="'serve': the serve command's engine config; 'default': the stock EngineConfig()")
    device_arg(pp)
    pp.set_defaults(fn=cmd_precompile)

    ps = sub.add_parser("settings", help="settings utilities")
    ps.add_argument("--init", required=True, help="write default settings JSON")
    ps.set_defaults(fn=cmd_settings)

    pth = sub.add_parser("themes", help="theme store: list/show/create/edit palettes (headless palette editor)")
    pth.add_argument("action", choices=["list", "show", "create", "set-stop", "delete"])
    pth.add_argument("name", nargs="?", help="theme name")
    pth.add_argument("visual", nargs="?", help="visual whose palette to edit (set-stop)")
    pth.add_argument("--dir", default="themes", help="theme store directory (default: themes/)")
    pth.add_argument("--base", default="default", help="base theme for create (default: default)")
    pth.add_argument("--stop", type=int, default=0, help="stop index for set-stop")
    pth.add_argument("--color", help="R,G,B[,A] floats in [0,1] for set-stop")
    pth.add_argument("--position", type=float, help="interior stop position in (0,1) for set-stop")
    pth.add_argument("--spread", type=float, help="stop spread for set-stop")
    pth.set_defaults(fn=cmd_themes)

    pt = sub.add_parser("selftest", help="end-to-end smoke test")
    device_arg(pt)
    pt.set_defaults(fn=cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
