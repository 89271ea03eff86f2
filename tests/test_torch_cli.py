"""PyTorch port, the CLI (``python -m openmeters_tpu_torch``) and the
serving pieces behind it that the JAX package's CLI tests drive: ``analyze``
against the JAX CLI's output on the same WAV (the bars of
``utils/parity.py``' ``check_analyze``), ``settings --init`` byte for byte,
``selftest``, ``precompile``, ``serve`` with the feeder and a checkpoint
(restart, restore, SIGTERM), ``serve --socket`` with a producer of each
package, the settings watcher, and ``declare_view``'s histories against
the JAX server's.  Everything runs with ``--device cpu``.

Nothing here asserts wall-clock timing: waits poll a condition up to a
deadline, threads and subprocesses are joined with a timeout, and sockets
live under ``tmp_path``."""

import argparse
import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_pairs import stereo_audio, tiny_engine, to_jax, unaligned  # noqa: E402

from openmeters_tpu import __main__ as jcli  # noqa: E402
from openmeters_tpu import serve as jserve  # noqa: E402
from openmeters_tpu.ingest.runtime import ProducerClient as JProducerClient  # noqa: E402
from openmeters_tpu_torch import __main__ as tcli  # noqa: E402
from openmeters_tpu_torch import serve as tserve  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrogram import SpectrogramConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.spectrum import SpectrumConfig  # noqa: E402
from openmeters_tpu_torch.analyzers.waveform import WaveformConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig  # noqa: E402
from openmeters_tpu_torch.ingest.runtime import ProducerClient  # noqa: E402
from openmeters_tpu_torch.io.wav import write_wav  # noqa: E402
from openmeters_tpu_torch.persistence import SettingsHandle, encode_settings, write_json_atomic  # noqa: E402
from openmeters_tpu_torch.utils.parity import CLASSIC_CODES, STEREO_WAVE_BARS, check_analyze  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 120.0
RATE, B = 48_000.0, 256


def wait_for(cond, timeout: float = WAIT_S, step: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(step)
    return True


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def cli_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


# -- analyze, settings, selftest, precompile ---------------------------------------


def test_selftest_on_the_cpu(capsys):
    assert tcli.main(["selftest", "--device", "cpu"]) == 0
    assert "(OK)" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["selftest"], ["analyze", "missing.wav"], ["serve", "--duration", "1"],
                                  ["precompile"]])
def test_card_is_the_default_and_never_falls_back(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


ANALYZE_CASES = {
    # the literal default with the spectrum at hop 512 (a setting of the reference UI)
    "default_hop512": dataclasses.replace(EngineConfig(), spectrum=SpectrumConfig(hop_size=512)),
    # a classic spectrogram, so the output has its peak
    "classic": EngineConfig(spectrogram=SpectrogramConfig(1024, 128, use_reassignment=False), spectrum=None,
                            oscilloscope=None, waveform=None),
}


@pytest.mark.parametrize("case", sorted(ANALYZE_CASES))
def test_analyze_matches_jax_cli(tmp_path, capsys, case):
    """The port's ``analyze --device cpu`` against the JAX CLI's on the same
    WAV and settings file: every field within its bar."""
    rng = np.random.default_rng(31)
    t = np.arange(int(0.9 * RATE)) / RATE
    left = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1700.0 * t) + 0.01 * rng.standard_normal(
        t.shape)
    right = 0.6 * left + 0.05 * np.sin(2 * np.pi * 3100.0 * t)
    wav, settings = str(tmp_path / "in.wav"), str(tmp_path / "settings.json")
    write_wav(wav, np.stack([left, right], -1).astype(np.float32), RATE)
    write_json_atomic(settings, encode_settings(ANALYZE_CASES[case]))
    assert tcli.main(["analyze", wav, "--settings", settings, "--compact", "--device", "cpu"]) == 0
    ours = last_json(capsys.readouterr().out)
    assert jcli.main(["analyze", wav, "--settings", settings, "--compact"]) == 0
    ref = last_json(capsys.readouterr().out)
    check_analyze(ours, ref, case)
    assert ("spectrogram" in ours) == (case == "classic")


def test_settings_init_writes_the_jax_cli_bytes(tmp_path):
    ours, ref = tmp_path / "port.json", tmp_path / "jax.json"
    assert tcli.main(["settings", "--init", str(ours)]) == 0
    assert jcli.main(["settings", "--init", str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes()
    assert SettingsHandle.load_or_default(str(ours)) == EngineConfig()


def test_precompile_reports_build_and_warm_up(capsys):
    assert tcli.main(["precompile", "--device", "cpu", "--streams", "2"]) == 0
    out = last_json(capsys.readouterr().out)
    assert out["build_s"] >= 0.0 and out["warm_s"] > 0.0 and out["device"] == "cpu"
    assert Path(out["build_dir"]).is_dir()


@pytest.mark.parametrize("argv", [["render", "in.wav", "out"], ["themes", "list"], ["serve", "--tui"],
                                  ["serve", "--render-dir", "frames"],
                                  ["serve", "--socket", "s.sock", "--render-dir", "frames"]])
def test_display_layers_raise_naming_the_slice(argv, tmp_path, monkeypatch, capsys):
    """The display surfaces are ported: none raises ``NotImplementedError``.
    ``render`` computes on the card by default (and raises where none is
    present); ``themes`` runs; ``serve --tui`` and ``--render-dir`` serve
    on the CPU when asked; with ``--socket`` they exit 2."""
    monkeypatch.chdir(tmp_path)
    if argv[0] == "render":
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        write_wav("in.wav", stereo_audio(1, 4096, 3)[0], RATE)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
        return
    if argv[0] == "themes":
        assert tcli.main(argv) == 0
        assert "heat (builtin)" in capsys.readouterr().out
        return
    write_json_atomic("tiny.json", encode_settings(tiny_engine()))
    rc = tcli.main([*argv, "--device", "cpu", "--streams", "2", "--duration", "4.0", "--settings", "tiny.json"])
    if "--socket" in argv:
        assert rc == 2 and "--socket" in capsys.readouterr().err
        return
    assert rc == 0 and last_json(capsys.readouterr().out)["hops"] > 0
    if "--render-dir" in argv:
        assert (tmp_path / "frames" / "loudness.png").exists()


def test_themes_set_stop_rejects_a_bad_color(tmp_path, capsys):
    """``themes set-stop --color`` takes 3 or 4 components in [0, 1]: other
    input returns 1 with a message and leaves the theme file as it was;
    valid input writes the JAX CLI's file."""
    d = str(tmp_path / "themes")
    assert tcli.main(["themes", "create", "mine", "--dir", d]) == 0
    before = (tmp_path / "themes" / "mine.json").read_bytes()
    for color in ("0.5,0.1", "0.5,0.1,0.2,0.3,0.4", "1.5,0,0", "-0.1,0,0", "a,b,c", "nan,0,0"):
        capsys.readouterr()
        assert tcli.main(["themes", "set-stop", "mine", "spectrum", "--dir", d, f"--color={color}"]) == 1
        assert f"--color {color}" in capsys.readouterr().out
        assert (tmp_path / "themes" / "mine.json").read_bytes() == before
    jd = str(tmp_path / "jax")
    argv = ["themes", "set-stop", "mine", "spectrum", "--stop", "1", "--color", "0.25,0.5,1"]
    for main, where in ((tcli.main, d), (jcli.main, jd)):
        assert main(["themes", "create", "mine", "--dir", where]) == 0
        assert main([*argv, "--dir", where]) == 0
    assert (tmp_path / "themes" / "mine.json").read_bytes() == (tmp_path / "jax" / "mine.json").read_bytes()


def test_themes_parses_as_the_jax_cli(monkeypatch):
    """``themes`` computes nothing on a device: its options are the JAX
    CLI's, into the same values, and neither CLI takes ``--device``."""
    argv = ["themes", "set-stop", "mine", "spectrum", "--dir", "d", "--base", "heat", "--stop", "1",
            "--color", "0.1,0.2,0.3", "--position", "0.5", "--spread", "2.0"]
    parsed = []
    for cli in (tcli, jcli):
        monkeypatch.setattr(cli, "cmd_themes", lambda a: parsed.append({k: v for k, v in vars(a).items() if k != "fn"})
                            or 0)
        assert cli.main(argv) == 0
        with pytest.raises(SystemExit) as e:
            cli.main(["themes", "list", "--device", "cpu"])
        assert e.value.code == 2
    assert parsed[0] == parsed[1]


@pytest.mark.parametrize("flag", [["--tui"], ["--render-dir", "frames"]])
def test_serve_socket_refuses_the_display_flags(flag, capsys):
    """``--tui`` and ``--render-dir`` show one stream of the synthetic feed;
    with ``--socket`` the port says so and exits 2 (the JAX CLI ignores
    them without a word)."""
    assert tcli.main(["serve", "--socket", "x.sock", *flag, "--device", "cpu"]) == 2
    assert "do not combine with --socket" in capsys.readouterr().err


def test_serve_display_flags_parse_and_draw(tmp_path, capsys):
    """Every display flag of the JAX CLI's ``serve`` parses in the port's,
    and a short served run on the CPU paints the TUI and writes the panes
    in the chosen theme (a stored one, from ``--themes-dir``)."""
    themes, settings = str(tmp_path / "themes"), str(tmp_path / "tiny.json")
    assert tcli.main(["themes", "create", "mine", "--base", "heat", "--dir", themes]) == 0
    write_json_atomic(settings, encode_settings(tiny_engine(waveform=WaveformConfig(track_history=True))))
    frames = tmp_path / "frames"
    # 4 s: a fetch drains every sixth hop, and a loaded CPU may serve only a
    # few hops a second
    argv = ["serve", "--device", "cpu", "--streams", "2", "--duration", "4.0", "--settings", settings,
            "--fetch", "full", "--tui",
            "--tui-stream", "1", "--render-dir", str(frames), "--render-every", "0.1", "--theme", "mine",
            "--themes-dir", themes]
    capsys.readouterr()
    assert tcli.main(argv) == 0
    out = capsys.readouterr()
    assert last_json(out.out)["hops"] > 0
    assert "stream #1" in out.err and "LUFS" in out.err
    written = {p.name for p in frames.glob("*.png")}  # the bulk panes once their histories fill
    assert "loudness.png" in written and written <= {"loudness.png", "spectrogram.png", "waveform.png"}
    # both CLIs parse the same flags into the same values
    parsed = []
    for cli, args in ((tcli, argv), (jcli, [a for a in argv if a not in ("--device", "cpu")])):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cli, "cmd_serve", lambda a: parsed.append(vars(a)) or 0)
            assert cli.main(args) == 0
    keys = ("tui", "tui_stream", "render_dir", "render_every", "theme", "themes_dir", "fetch")
    assert [{k: p[k] for k in keys} for p in parsed] == [{k: parsed[1][k] for k in keys}] * 2


# -- serve with the feeder: checkpoint, restore, SIGTERM ------------------------------


class _Lines:
    """A subprocess's stderr, line by line, read on a thread."""

    def __init__(self, proc):
        self.q: queue.Queue = queue.Queue()
        self.t = threading.Thread(target=self._read, args=(proc.stderr,), daemon=True)
        self.t.start()

    def _read(self, stream):
        for line in stream:
            self.q.put(line)

    def wait_line(self, needle: str, timeout: float = WAIT_S) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self.q.get(timeout=0.5)
            except queue.Empty:
                continue
            if needle in line:
                return True
        return False


def _serve(ckpt, duration: str):
    return subprocess.Popen(
        [sys.executable, "-m", "openmeters_tpu_torch", "serve", "--device", "cpu", "--streams", "2",
         "--duration", duration, "--checkpoint", str(ckpt)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=cli_env(),
    )


def test_serve_checkpoint_restart_restore_and_sigterm(tmp_path):
    from openmeters_tpu_torch.checkpoint import load_state
    from openmeters_tpu_torch.engine import MeterEngine

    ckpt = tmp_path / "carry.npz"
    first = _serve(ckpt, "1.0")
    try:
        out, err = first.communicate(timeout=300)
    finally:
        if first.returncode is None:
            first.kill()
            first.communicate(timeout=30)
    assert first.returncode == 0, err
    report = last_json(out)
    assert report["hops"] > 0 and report["feeder_pushes_ok"] > 0
    assert ckpt.exists() and "restored" not in err
    written = ckpt.stat().st_mtime_ns

    second = _serve(ckpt, "600")  # restores, then serves until SIGTERM
    lines = _Lines(second)
    try:
        assert lines.wait_line(f"# restored carry from {ckpt}")
        os.kill(second.pid, signal.SIGTERM)
        second.wait(timeout=120)
    finally:
        if second.returncode is None:
            second.kill()
            second.wait(timeout=30)
        lines.t.join(timeout=30)
    assert second.returncode == 128 + signal.SIGTERM
    assert ckpt.stat().st_mtime_ns > written  # the handler (and the exit path) saved the carry
    cfg = tcli._serving_engine_config(argparse.Namespace(settings=None, config="serve"))
    carry = load_state(str(ckpt), MeterEngine(cfg), device="cpu")
    assert carry["loudness"] is not None


# -- serve --socket with a producer of each package -----------------------------------


def _producer(client_cls, sock, name, rate, halt, slots):
    """Wait for the socket, connect, and push a tone until ``halt``."""
    if not wait_for(lambda: os.path.exists(sock)):
        return
    c = client_cls(sock, {"app_name": name, "channels": 2, "sample_rate": rate}, timeout=60.0)
    try:
        slots[name] = c.connect()
        x = (0.4 * np.sin(2 * np.pi * 440.0 * np.arange(int(rate // 10)) / rate)).astype(np.float32)
        n = 0
        while not halt.wait(0.05):
            c.send_pcm(np.stack([x, x], -1), int(n / rate * 1e9))
            n += len(x)
    except OSError:
        pass  # the serve loop closed the link first
    finally:
        c.close()


def test_serve_socket_serves_both_packages_producers(tmp_path, capsys, monkeypatch):
    """``serve --socket --rates 44100,48000`` lists a link of the JAX
    package's client and one of the port's.  The serve loop starts its
    clock once both are connected, so a slow thread cannot miss it."""
    sock = str(tmp_path / "cli.sock")
    halt, slots = threading.Event(), {}
    links = ("app.name:jax44", "app.name:port48")

    class WaitsForLinks(tserve.MultiRateMeterServer):
        def run(self, duration_s):
            assert wait_for(lambda: all(k in self.runtime.view()["active"] for k in links))
            return super().run(duration_s)

    monkeypatch.setattr(tserve, "MultiRateMeterServer", WaitsForLinks)
    threads = [threading.Thread(target=_producer, args=(JProducerClient, sock, "jax44", 44_100.0, halt, slots)),
               threading.Thread(target=_producer, args=(ProducerClient, sock, "port48", RATE, halt, slots))]
    for t in threads:
        t.start()
    try:
        rc = tcli.main(["serve", "--socket", sock, "--rates", "44100,48000", "--streams", "2", "--duration", "1.0",
                        "--fetch", "none", "--device", "cpu"])
    finally:
        halt.set()
        for t in threads:
            t.join(timeout=30)
    assert rc == 0 and not any(t.is_alive() for t in threads)
    assert slots["jax44"] is not None and slots["port48"] is not None
    report = last_json(capsys.readouterr().out)
    assert report["44100.0"]["hops"] > 0 and report["48000.0"]["hops"] > 0
    assert report["links"]["app.name:jax44"]["sample_rate"] == 44_100.0
    assert report["links"]["app.name:port48"]["sample_rate"] == RATE
    assert not os.path.exists(sock)


# -- the settings watcher --------------------------------------------------------------


def test_watch_settings_adopts_an_edited_file(tmp_path, capsys, monkeypatch):
    """``serve --settings f --watch-settings``: an edit of ``f`` (the
    reassigned spectrogram turned on) is warmed and adopted by the serving
    loop, its sample rate and block pinned to the server's."""
    settings = str(tmp_path / "settings.json")
    classic = EngineConfig(channels=2, spectrogram=SpectrogramConfig(256, 64, use_reassignment=False),
                           spectrum=None, oscilloscope=None, stereometer=None, waveform=None)
    write_json_atomic(settings, encode_settings(classic))
    servers = []
    attach = tserve.attach_settings_watcher

    def recording(server, path, min_interval=0.5):
        servers.append(server)
        return attach(server, path, min_interval)

    monkeypatch.setattr(tserve, "attach_settings_watcher", recording)
    seen = {}

    def editor():
        if not wait_for(lambda: servers):
            return
        s = servers[0]
        edited = dataclasses.replace(classic, sample_rate=44_100.0,
                                     spectrogram=SpectrogramConfig(256, 64, use_reassignment=True))
        write_json_atomic(settings, encode_settings(edited))
        seen["adopted"] = wait_for(lambda: s.engine.config.spectrogram.use_reassignment)
        s.stop()

    t = threading.Thread(target=editor)
    t.start()
    try:
        rc = tcli.main(["serve", "--settings", settings, "--watch-settings", "--streams", "2", "--duration", "600",
                        "--device", "cpu"])
    finally:
        if servers:
            servers[0].stop()
        t.join(timeout=WAIT_S)
    assert rc == 0 and not t.is_alive()
    assert seen["adopted"]
    cfg = servers[0].engine.config
    assert cfg.sample_rate == RATE and cfg.block_frames == B  # the transport's, not the file's
    assert last_json(capsys.readouterr().out)["hops"] > 0


def test_watch_settings_requires_settings(capsys):
    assert tcli.main(["serve", "--watch-settings", "--device", "cpu"]) == 2


# -- declare_view's histories -------------------------------------------------------------


def test_declare_view_histories_match_jax():
    """``declare_view`` on the port's server and the JAX package's, both
    ``fetch="full"``: the granted retention, and the spectrogram and
    waveform histories the display-rate drain fills, through a
    reconfiguration that changes the column width and a resize.  The JAX
    server's host buffers sit off 64-byte alignment (``tests/
    test_torch_serve.py::pair`` says why)."""
    engine = tiny_engine(waveform=WaveformConfig())
    cfg = tserve.ServeConfig(n_streams=4, engine=engine, realtime=False, fetch="full", fetch_every=2)
    jax_server = jserve.MeterServer(to_jax(cfg))
    jax_server._buffers = [tuple(unaligned(a) for a in bufs) for bufs in jax_server._buffers]
    servers = (jax_server, tserve.MeterServer(cfg, device="cpu"))
    audio = stereo_audio(4, 80 * B, seed=41)
    try:
        granted = [s.declare_view(stream=1, spectrogram_columns=24, waveform_columns=50) for s in servers]
        assert granted[0] == granted[1] == {"spectrogram_columns": 24, "waveform_columns": 50}
        for i in range(80):
            if i == 40:
                wider = dataclasses.replace(engine, spectrogram=SpectrogramConfig(512, 64, use_reassignment=False))
                servers[0].apply_settings(to_jax(wider))
                servers[1].apply_settings(wider)
            if i == 60:
                assert [s.declare_view(stream=1, spectrogram_columns=9, waveform_columns=20) for s in servers] == [
                    {"spectrogram_columns": 9, "waveform_columns": 20}] * 2
            ts = int(i * B / RATE * 1e9)
            for s in servers:
                for st in range(4):
                    s.transport.push_pcm(st, np.ascontiguousarray(audio[st, i * B : (i + 1) * B]), ts)
                s.advance()
            if i in (39, 79):
                _check_histories(*servers, f"advance {i}")
    finally:
        for s in servers:
            s.close()


def _check_histories(jax_server, ours, where):
    jsg, tsg = jax_server._view_histories["spectrogram"], ours._view_histories["spectrogram"]
    assert (tsg.bins, tsg.columns, tsg.filled) == (jsg.bins, jsg.columns, jsg.filled), where
    assert tsg.filled > 0 and tsg.view().dtype == np.uint16
    a, b = tsg.view().astype(np.int64), jsg.view().astype(np.int64)
    held = b >= b.max(axis=-1, keepdims=True) - round(60.0 * 65535 / 156)
    assert int((np.abs(a - b) * held).max()) <= CLASSIC_CODES, where
    jwf, twf = jax_server._view_histories["waveform"], ours._view_histories["waveform"]
    assert twf.max_columns == jwf.max_columns and len(twf.columns) == len(jwf.columns) > 0, where
    for tc, jc in zip(twf.columns, jwf.columns):
        assert tc.keys() == jc.keys()
        assert np.array_equal(tc["min"], jc["min"]) and np.array_equal(tc["max"], jc["max"]), where
        assert np.abs(tc["color"] - jc["color"]).max() <= STEREO_WAVE_BARS["col_color"], where
        assert np.abs(tc["rms_db"] - jc["rms_db"]).max() <= STEREO_WAVE_BARS["col_rms_db"], where
