"""The port's terminal meters and key controls (``tui.py``) against the JAX
package's: tests/test_serve.py's TUI cases as pairs, on the CPU.  Given
the same meters and spectrum, both ``TuiView``s print the same frames; on
each package's own server the frames agree line by line within the
meters' bars, and the keys drive both servers the same way."""

import contextlib
import dataclasses
import io
import os
import re
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_pairs import to_jax, unaligned  # noqa: E402

import openmeters_tpu.tui as jtui  # noqa: E402
import openmeters_tpu_torch.tui as ttui  # noqa: E402
from openmeters_tpu import serve as jserve  # noqa: E402
from openmeters_tpu.analyzers.spectrum import SpectrumSnapshot as JSpectrumSnapshot  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig, SpectrumSnapshot  # noqa: E402
from openmeters_tpu_torch.analyzers.stereometer import StereometerConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig  # noqa: E402
from openmeters_tpu_torch.serve import MeterServer, ServeConfig  # noqa: E402

RATE, B = 48_000.0, 256


def tui_engine() -> EngineConfig:
    """Loudness, a classic 256/64 spectrogram, a 2048/256 spectrum and the
    stereometer: every pane of the TUI."""
    return EngineConfig(channels=2,
                        spectrogram=SpectrogramConfig(fft_size=256, hop_size=64, use_reassignment=False),
                        spectrum=SpectrumConfig(fft_size=2048, hop_size=256), oscilloscope=None,
                        stereometer=StereometerConfig(), waveform=None)


def pair(engine: EngineConfig, fetch: str = "meters", streams: int = 2):
    cfg = ServeConfig(n_streams=streams, channels=2, engine=engine, realtime=False, fetch=fetch, fetch_every=2)
    jax_server = jserve.MeterServer(to_jax(cfg))
    # see tests/test_torch_serve.py::pair
    jax_server._buffers = [tuple(unaligned(a) for a in bufs) for bufs in jax_server._buffers]
    return jax_server, MeterServer(cfg, device="cpu")


def push(servers, i: int) -> None:
    """Block ``i``: a -20 dBFS 997 Hz tone on stream 0, a quieter 300 Hz
    tone with its right channel inverted on stream 1."""
    t = np.arange(i * B, (i + 1) * B) / RATE
    tones = [0.1 * np.sin(2 * np.pi * 997.0 * t), 0.03 * np.sin(2 * np.pi * 300.0 * t)]
    blocks = [np.stack([tones[0], tones[0]], -1), np.stack([tones[1], -0.5 * tones[1]], -1)]
    for srv in servers:
        for st in range(srv.config.n_streams):
            srv.transport.push_pcm(st, np.ascontiguousarray(blocks[st % 2], np.float32), int(i * B / RATE * 1e9))


NUMBER = re.compile(r"[-+]?\d+\.\d+")


def test_tui_frames_identical_on_the_same_meters():
    """The JAX server's drained meters and spectrum, on each drain, into
    both packages' ``TuiView`` (stream 1, its ballistics advanced by the
    same clock): every frame identical."""
    src, port = pair(tui_engine())
    port.close()
    views = {"jax": jtui.TuiView(stream=1, width=24), "torch": ttui.TuiView(stream=1, width=24)}
    frames = {k: [] for k in views}

    def on_drain(s):
        meters, spectrum = s.last_meters(), s.fetch_spectrum()
        now = 0.05 * len(frames["jax"])
        for k, view in views.items():
            frames[k].append(view.render(meters, now, spectrum=spectrum))

    src.on_drain = on_drain
    try:
        for i in range(60):
            push([src], i)
            src.advance()
    finally:
        src.close()
    assert len(frames["jax"]) > 10
    assert frames["torch"] == frames["jax"]
    last = frames["torch"][-1]
    assert all(tag in last for tag in ("M ", "S ", "TP ", "C ", "SP ", "LUFS", "dB pk"))


def test_tui_frames_on_each_server_within_the_bars():
    """tests/test_serve.py:256 as a pair: ``on_drain`` fires at the drain
    cadence on both servers, and each drain's frame (stream 0) has the same
    lines, every number within 0.05 of the JAX package's."""
    servers = pair(tui_engine())
    views = [jtui.TuiView(stream=0, width=24), ttui.TuiView(stream=0, width=24)]
    frames = [[], []]
    for srv, view, out in zip(servers, views, frames):
        srv.on_drain = lambda s, view=view, out=out: out.append(
            view.render(s.last_meters(), now=0.1 * len(out), spectrum=s.fetch_spectrum()))
    try:
        for i in range(60):
            push(servers, i)
            for srv in servers:
                srv.advance()
    finally:
        for srv in servers:
            srv.close()
    assert len(frames[0]) == len(frames[1]) > 10
    for j, t in zip(*frames):
        jl, tl = j.splitlines(), t.splitlines()
        assert [ln[:3] for ln in tl] == [ln[:3] for ln in jl]
        for a, b in zip(jl, tl):
            na, nb = (np.array([float(x) for x in NUMBER.findall(ln)]) for ln in (a, b))
            assert na.shape == nb.shape and np.all(np.abs(na - nb) <= 0.05 + 1e-9), (a, b)
    assert "█" in frames[1][-1] and "LUFS" in frames[1][-1]


def test_tui_spectrum_sparkline_pane_identical():
    """tests/test_serve.py:956 on both packages: one hot bin, one raised
    bucket near the top of the scale; an out-of-range stream prints no
    pane; and the port's one-stream fetch (``spectrum_row=0``) prints what
    the whole snapshot does."""
    bins = 1025
    raw = np.full((2, 1, bins), -100.0, np.float32)
    raw[0, 0, 100] = -6.0
    raw[1, 0, 500] = -40.0
    snaps = {"jax": JSpectrumSnapshot(weighted_db=raw.copy(), raw_db=raw, updated=np.ones((2,), bool)),
             "torch": SpectrumSnapshot(weighted_db=raw.copy(), raw_db=raw, updated=np.ones((2,), bool))}
    outs = {}
    for k, pkg in (("jax", jtui), ("torch", ttui)):
        outs[k] = [pkg.TuiView(stream=s, width=32).render({}, now=0.0, spectrum=snaps[k]) for s in (0, 1, 7)]
    assert outs["torch"] == outs["jax"]
    spark = [ln for ln in outs["torch"][0].splitlines() if ln.startswith("SP ")][0]
    assert [c for c in spark if c in "▁▂▃▄▅▆▇█"] == ["▇"] and "-6.0" in spark
    assert "SP " not in outs["torch"][2]
    one = SpectrumSnapshot(*(x[1:2] for x in snaps["torch"]))
    assert ttui.TuiView(stream=1, width=32).render({}, 0.0, spectrum=one, spectrum_row=0) == outs["torch"][1]


def test_serve_tui_callback_paints_on_drain():
    """``serve_tui_callback`` on both servers: a cursor-home paint on
    stderr with the same toggle legend, and the same frame lines."""
    servers = pair(tui_engine())
    paints = [io.StringIO(), io.StringIO()]
    for srv, pkg in zip(servers, (jtui, ttui)):
        srv.on_drain = pkg.serve_tui_callback(stream=0, width=20, min_interval=0.0)
    try:
        for i in range(40):
            push(servers, i)
            for srv, buf in zip(servers, paints):
                with contextlib.redirect_stderr(buf):
                    srv.advance()
    finally:
        for srv in servers:
            srv.close()
    last = [p.getvalue().split("\x1b[H\x1b[2J")[-1].splitlines() for p in paints]
    assert last[0][0].startswith("openmeters_tpu serve") and last[1][0].startswith("openmeters_tpu_torch serve")
    assert last[1][0].split(" serve", 1)[1] == last[0][0].split(" serve", 1)[1]
    assert last[1][1] == last[0][1] == "[1●]loudn [2●]spect [3●]spect [4○]oscil [5●]stere [6○]wavef"
    assert [ln[:3] for ln in last[1][3:]] == [ln[:3] for ln in last[0][3:]]
    assert paints[1].getvalue().count("\x1b[H") == paints[0].getvalue().count("\x1b[H") > 5
    assert servers[1].on_drain.view.stream == 0


def test_default_analyzer_config_is_the_stock_one():
    """Re-enabling a visual without a stash takes the stock
    ``EngineConfig()``'s settings, the JAX package's."""
    for name in ttui.ANALYZERS:
        assert to_jax(ttui._default_analyzer_config(name)) == jtui._default_analyzer_config(name)
    assert ttui.ANALYZERS == jtui.ANALYZERS
    with pytest.raises(KeyError):
        ttui._default_analyzer_config("nosuch")


def test_key_controls_pause_and_quit_on_both():
    """tests/test_serve.py:865 on both servers: ``p`` pauses from the tick
    hook (no hop while paused), space resumes, ``q`` ends ``run()``
    early."""
    states = []
    for srv in pair(tui_engine(), fetch="none", streams=1):
        r, w = os.pipe()
        rf = os.fdopen(r, "rb", buffering=0)
        try:
            srv.on_tick = None
            (jtui if isinstance(srv, jserve.MeterServer) else ttui).attach_key_controls(srv, source=rf)
            os.write(w, b"p")
            srv.run(0.2)
            paused = (srv.paused, srv.stats.hops)
            os.write(w, b" ")
            srv.run(0.2)
            resumed = (srv.paused, srv.stats.hops > 0)
            os.write(w, b"q")
            t0 = time.monotonic()
            srv.run(30.0)
            states.append((paused, resumed, time.monotonic() - t0 < 5.0))
        finally:
            rf.close()
            os.close(w)
            srv.close()
    assert states[1] == states[0] == ((True, 0), (False, True), True)


def test_key_controls_toggle_analyzers():
    """tests/test_serve.py:982 on the port's server: ``2`` toggles the
    spectrogram off and on through ``apply_settings_async`` (a swap at a
    hop boundary), its non-stock settings restored from the stash; ``1``
    refuses to disable the last analyzer; ``s``/``S`` cycle the view's
    stream."""
    engine = dataclasses.replace(
        tui_engine(), spectrum=None, stereometer=None,
        spectrogram=SpectrogramConfig(fft_size=512, hop_size=128, use_reassignment=False))
    server = MeterServer(ServeConfig(n_streams=3, channels=2, engine=engine, realtime=False, fetch="meters"),
                         device="cpu")
    view = ttui.TuiView(stream=0)
    r, w = os.pipe()
    rf = os.fdopen(r, "rb", buffering=0)
    i = [0]

    def hops_until(pred, bound=600):
        for _ in range(bound):
            push([server], i[0])
            i[0] += 1
            server.on_tick(server)
            server.advance()
            if pred():
                return True
            if server.reconfig_pending:
                time.sleep(0.02)
        return False

    try:
        ttui.attach_key_controls(server, source=rf, view=view)
        os.write(w, b"2")
        assert hops_until(lambda: not server.reconfig_pending and "spectrogram" not in server.engine.analyzers)
        os.write(w, b"1")
        assert hops_until(lambda: True, bound=3)
        assert not server.reconfig_pending and "loudness" in server.engine.analyzers
        assert not ttui.toggle_analyzer(server, "loudness") and not ttui.toggle_analyzer(server, "nosuch")
        os.write(w, b"2")
        assert hops_until(lambda: not server.reconfig_pending and "spectrogram" in server.engine.analyzers)
        assert server.engine.config.spectrogram.fft_size == 512
        m = server.fetch_meters_now()
        assert m is not None and any("spectrogram" in k for k in m)
        os.write(w, b"sss")
        hops_until(lambda: True, bound=1)
        assert view.stream == 0
        os.write(w, b"S")
        hops_until(lambda: True, bound=1)
        assert view.stream == 2
    finally:
        rf.close()
        os.close(w)
        server.close()
