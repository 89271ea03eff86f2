"""PyTorch port, the session runtime (``ingest/runtime.py``,
``ingest/producer.py``): the scenarios of ``tests/test_runtime_live.py``
run on the port's runtime and transport, with real producer processes
(``python -m openmeters_tpu_torch.ingest.producer``) and in-process
clients, and the wire protocol checked across the packages in both
directions: the JAX package's client served by the port's runtime, and the
port's client by the JAX package's runtime.

Nothing here asserts wall-clock timing: every wait polls its condition up
to a deadline and then asserts the condition, every subprocess and thread
is joined with a timeout, and every socket lives under ``tmp_path``."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from openmeters_tpu.ingest import Transport as JTransport
from openmeters_tpu.ingest.runtime import ProducerClient as JProducerClient
from openmeters_tpu.ingest.runtime import SessionRuntime as JSessionRuntime
from openmeters_tpu_torch.ingest import Transport
from openmeters_tpu_torch.ingest.runtime import ProducerClient, SessionRuntime

REPO = Path(__file__).resolve().parents[1]
RATE = 48_000.0
BLOCK = 256
WAIT_S = 60.0  # the longest any condition is polled for


def wait_for(cond, timeout: float = WAIT_S, step: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(step)
    return True


@pytest.fixture()
def runtime(tmp_path):
    tp = Transport(n_streams=2, channels=2, block_frames=BLOCK, sample_rate=RATE)
    sock = str(tmp_path / "om.sock")
    rt = SessionRuntime(tp, sock)
    yield tp, rt, sock
    rt.shutdown()


@pytest.fixture()
def spawn():
    """Starts ``python -m openmeters_tpu_torch.ingest.producer`` processes;
    any still running at teardown is terminated."""
    procs = []
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)

    def start(sock, *args):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "openmeters_tpu_torch.ingest.producer", "--socket", sock, *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env,
        ))
        return procs[-1]

    yield start
    stop(*procs)


def slot_of(proc) -> int:
    """The slot a producer process announces on its first line."""
    line = proc.stdout.readline()
    assert line.startswith(b"slot "), (line, proc.stderr.read() if proc.poll() is not None else b"")
    return int(line.split()[1])


def stop(*procs) -> None:
    for p in procs:
        if p.returncode is None:
            p.terminate()
            p.communicate(timeout=30)


def drain_until(tp, cond, timeout: float = WAIT_S):
    """Assemble hops until ``cond(filled, resets)`` holds or the deadline
    passes; returns per-slot nonzero frame counts and reset counts."""
    filled = np.zeros(tp.n_streams, np.int64)
    resets = np.zeros(tp.n_streams, np.int64)
    deadline = time.monotonic() + timeout
    while not cond(filled, resets) and time.monotonic() < deadline:
        batch, reset, _, _ = tp.assemble()
        filled += np.count_nonzero(np.asarray(batch)[:, :, 0], axis=1)
        resets += np.asarray(reset).astype(np.int64)
        time.sleep(0.002)
    return filled, resets


def assemble_when_buffered(tp, slot: int, frames: int):
    """One hop assembled once ``frames`` frames of ``slot`` are buffered."""
    assert wait_for(lambda: tp.buffered_frames(slot) >= frames)
    return tp.assemble()


def test_two_producers_route_by_identity(runtime, spawn):
    tp, rt, sock = runtime
    p1 = spawn(sock, "--app-name", "alpha", "--freq", "220", "--seconds", "120", "--realtime")
    p2 = spawn(sock, "--app-name", "beta", "--freq", "347", "--seconds", "120", "--realtime")
    try:
        slot1, slot2 = slot_of(p1), slot_of(p2)
        assert {slot1, slot2} == {0, 1}
        filled, _ = drain_until(tp, lambda f, r: f[slot1] > 0.2 * RATE and f[slot2] > 0.2 * RATE)
    finally:
        stop(p1, p2)
    assert filled[slot1] > 0.2 * RATE and filled[slot2] > 0.2 * RATE
    view = rt.view()
    assert view["links"]["app.name:alpha"]["slot"] == slot1
    assert view["links"]["app.name:beta"]["slot"] == slot2
    assert view["links"]["app.name:alpha"]["pcm_messages"] > 0
    assert not view["truncated"]


def test_reconnect_reacquires_remembered_slot(runtime, spawn):
    tp, rt, sock = runtime
    p = spawn(sock, "--app-name", "alpha", "--seconds", "0.2")
    out, _ = p.communicate(timeout=60)
    slot_first = int(out.split()[1])
    assert wait_for(lambda: "app.name:alpha" in rt.view()["remembered"])
    q = spawn(sock, "--app-name", "other", "--seconds", "0.1")
    q.communicate(timeout=60)
    p2 = spawn(sock, "--app-name", "alpha", "--seconds", "0.2")
    out2, _ = p2.communicate(timeout=60)
    assert int(out2.split()[1]) == slot_first  # the remembered identity's slot
    _, resets = drain_until(tp, lambda f, r: r[slot_first] >= 1)
    assert resets[slot_first] >= 1  # the reconnect's generation: a reset


def test_truncation_refuses_excess_producers(runtime):
    tp, rt, sock = runtime
    keep = [ProducerClient(sock, {"app_name": n}) for n in ("a", "b")]
    try:
        assert all(c.connect() is not None for c in keep)
        c3 = ProducerClient(sock, {"app_name": "c"})
        assert c3.connect() is None and c3.refusal == {"slot": None, "truncated": True}
        assert rt.view()["truncated"]
    finally:
        for c in keep:
            c.close()


def test_format_switch_resets_at_boundary(runtime, spawn):
    tp, rt, sock = runtime
    p = spawn(sock, "--app-name", "alpha", "--seconds", "1.0", "--realtime", "--format-switch-at", "0.5")
    try:
        slot = slot_of(p)
        # one reset for the first generation, one for the renegotiation
        _, resets = drain_until(tp, lambda f, r: r[slot] >= 2)
        p.communicate(timeout=60)
    finally:
        stop(p)
    assert p.returncode == 0
    assert resets[slot] >= 2


def test_gap_becomes_silence(runtime):
    """A jump of a producer's timeline arrives as silence of the gap's
    length between its PCM."""
    tp, rt, sock = runtime
    c = ProducerClient(sock, {"app_name": "gappy"})
    slot = c.connect()
    try:
        c.send_pcm(0.5 * np.ones((2 * BLOCK, 2), np.float32), 0)
        c.send_pcm(0.25 * np.ones((BLOCK, 2), np.float32), int((2 * BLOCK + 1000) / RATE * 1e9))
        assert wait_for(lambda: tp.buffered_frames(slot) >= 3 * BLOCK)  # the gap's silence is pushed before
        got = np.concatenate([np.asarray(tp.assemble()[0])[slot, :, 0].copy() for _ in range(7)])
    finally:
        c.close()
    want = np.concatenate([np.full(2 * BLOCK, 0.5), np.zeros(1000), np.full(BLOCK, 0.25)])
    assert np.array_equal(got[: len(want)], want.astype(np.float32))


def test_runtime_restart_producer_recovers(tmp_path):
    tp = Transport(n_streams=2, channels=2, block_frames=BLOCK, sample_rate=RATE)
    sock = str(tmp_path / "om.sock")
    rt1 = SessionRuntime(tp, sock)
    halt = threading.Event()
    reconnects = []

    def resilient_producer():
        n = 0
        while not halt.is_set():
            try:
                c = ProducerClient(sock, {"app_name": "phoenix"}, timeout=15.0)
                if c.connect() is None:
                    time.sleep(0.05)
                    continue
                reconnects.append(c.slot)
                while not halt.is_set():
                    c.send_pcm(0.25 * np.ones((BLOCK, 2), np.float32), int(n / RATE * 1e9))
                    n += BLOCK
                    time.sleep(BLOCK / RATE)
            except (OSError, TimeoutError):
                time.sleep(0.02)

    t = threading.Thread(target=resilient_producer, daemon=True)
    t.start()
    rt2 = None
    try:
        filled, _ = drain_until(tp, lambda f, r: f.sum() > 0.1 * RATE)
        assert filled.sum() > 0.1 * RATE
        rt1.shutdown()
        rt2 = SessionRuntime(tp, sock)  # a replacement on the same socket and transport
        refilled, _ = drain_until(tp, lambda f, r: f.sum() > 0.1 * RATE and len(reconnects) >= 2)
        assert refilled.sum() > 0.1 * RATE
        assert len(reconnects) >= 2
        assert wait_for(lambda: "app.name:phoenix" in rt2.view()["active"])
    finally:
        halt.set()
        t.join(timeout=30)
        if rt2 is not None:
            rt2.shutdown()
    assert not t.is_alive()


def test_mono_producer_negotiates_and_pads(runtime):
    tp, rt, sock = runtime
    c = ProducerClient(sock, {"app_name": "mono", "channels": 1})
    slot = c.connect()
    assert slot is not None and c.channels == 1 and c.positions == ["MONO"]
    try:
        c.send_pcm(0.25 * np.ones((BLOCK * 8,), np.float32), 0)
        batch, reset, _, _ = assemble_when_buffered(tp, slot, BLOCK * 8)
        assert reset[slot]
        got = np.asarray(batch)[slot]
        assert np.all(got[:, 0] == 0.25) and np.all(got[:, 1] == 0.0)
    finally:
        c.close()


def test_wide_producer_clamped_to_negotiated(runtime):
    tp, rt, sock = runtime
    c = ProducerClient(sock, {"app_name": "wide", "channels": 8})
    slot = c.connect()
    assert slot is not None and c.channels == 2 and c.max_channels == 2
    try:
        pcm = np.tile(np.asarray([[0.1, 0.2, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9]], np.float32), (BLOCK * 4, 1))
        c.send_pcm(pcm, 0)
        batch, _, _, _ = assemble_when_buffered(tp, slot, BLOCK * 4)
        got = np.asarray(batch)[slot]
        assert np.all(got[:, 0] == np.float32(0.1)) and np.all(got[:, 1] == np.float32(0.2))
    finally:
        c.close()


def test_rate_switch_between_heterogeneous_width_buckets(tmp_path):
    tp2 = Transport(n_streams=2, channels=2, block_frames=BLOCK, sample_rate=RATE)
    tp6 = Transport(n_streams=2, channels=6, block_frames=BLOCK, sample_rate=44_100.0)
    sock = str(tmp_path / "hetero.sock")
    rt = SessionRuntime({RATE: tp2, 44_100.0: tp6}, sock)
    try:
        c = ProducerClient(sock, {"app_name": "roam", "channels": 6, "sample_rate": 44_100.0})
        slot = c.connect()
        assert slot is not None and c.max_channels == 6 and c.channels == 6
        pcm = np.tile(np.asarray([[0.25, -0.25]], np.float32), (BLOCK * 4, 1))
        c.send_pcm(pcm, 0)  # padded to the 6 negotiated channels
        got = np.asarray(assemble_when_buffered(tp6, slot, BLOCK * 4)[0])[slot]
        assert np.all(got[:, 0] == 0.25) and np.all(got[:, 1] == -0.25) and np.all(got[:, 2:] == 0.0)

        c.send_format(2, sample_rate=RATE)  # a narrowing re-route the new bucket carries
        assert c.channels == 2
        c.send_pcm(pcm, int(BLOCK * 4 / 44_100.0 * 1e9))
        filled, _ = drain_until(tp2, lambda f, r: f.max() >= BLOCK)
        assert filled.max() >= BLOCK
        c.close()

        # a re-route the new bucket cannot carry drops the link
        c2 = ProducerClient(sock, {"app_name": "wide6", "channels": 6, "sample_rate": 44_100.0})
        assert c2.connect() is not None and c2.channels == 6
        c2.send_format(6, sample_rate=RATE)
        assert wait_for(lambda: "app.name:wide6" not in rt.view()["active"])
        c2.close()
    finally:
        rt.shutdown()


def test_surround_producer_six_channels(tmp_path):
    tp = Transport(n_streams=2, channels=6, block_frames=BLOCK, sample_rate=RATE)
    sock = str(tmp_path / "om6.sock")
    layouts = []
    rt = SessionRuntime(tp, sock, on_layout=lambda *a: layouts.append(a))
    try:
        c = ProducerClient(sock, {"app_name": "cinema", "channels": 6,
                                  "positions": ["FL", "FR", "FC", "LFE", "RL", "RR"]})
        slot = c.connect()
        assert slot is not None and c.channels == 6
        try:
            vals = np.asarray([0.1, 0.2, 0.3, 0.4, 0.5, 0.6], np.float32)
            c.send_pcm(np.tile(vals[None, :], (BLOCK * 4, 1)), 0)
            batch, reset, _, _ = assemble_when_buffered(tp, slot, BLOCK * 4)
            assert reset[slot]
            got = np.asarray(batch)[slot]
            assert all(np.all(got[:, ch] == vals[ch]) for ch in range(6))
        finally:
            c.close()
        rate, lslot, channels, positions = layouts[0]
        assert (rate, lslot, channels) == (RATE, slot, 6)
        assert [p.value for p in positions[:6]] == ["FL", "FR", "FC", "LFE", "RL", "RR"]
    finally:
        rt.shutdown()


def test_mid_stream_channel_switch_resets_cleanly(runtime):
    tp, rt, sock = runtime
    c = ProducerClient(sock, {"app_name": "switcher", "channels": 2})
    slot = c.connect()
    try:
        c.send_pcm(np.tile(np.asarray([[0.5, -0.5]], np.float32), (BLOCK * 2, 1)), 0)
        c.send_format(1)
        assert c.channels == 1
        c.send_pcm(0.125 * np.ones((BLOCK * 2, 1), np.float32), int(BLOCK * 2 / RATE * 1e9))
        filled, resets = drain_until(tp, lambda f, r: f[slot] >= BLOCK * 4 and r[slot] >= 2)
        assert filled[slot] >= BLOCK * 4  # both formats' audio, intact
        assert resets[slot] >= 2  # the connect and the renegotiation
    finally:
        c.close()


def test_duplicate_identity_refused_while_live(runtime):
    tp, rt, sock = runtime
    c1 = ProducerClient(sock, {"app_name": "dup"})
    slot = c1.connect()
    assert slot is not None
    c2 = ProducerClient(sock, {"app_name": "dup"}, timeout=5.0)
    assert c2.connect() is None and c2.refusal.get("busy")
    c1.close()
    got = []

    def reconnect():
        c3 = ProducerClient(sock, {"app_name": "dup"}, timeout=5.0)
        s = c3.connect()
        c3.close()
        if s is not None:
            got.append(s)
        return s is not None

    assert wait_for(reconnect, step=0.05)
    assert got == [slot]


def test_kill_churn_releases_and_recovers(runtime, spawn):
    tp, rt, sock = runtime
    p = spawn(sock, "--app-name", "alpha", "--seconds", "120", "--realtime")
    slot = slot_of(p)
    assert wait_for(lambda: rt.view()["links"]["app.name:alpha"]["pcm_messages"] > 0)
    os.kill(p.pid, signal.SIGKILL)
    p.communicate(timeout=30)
    assert wait_for(lambda: "app.name:alpha" not in rt.view()["active"])
    assert "app.name:alpha" in rt.view()["remembered"]
    p2 = spawn(sock, "--app-name", "alpha", "--seconds", "0.1")
    out2, _ = p2.communicate(timeout=60)
    assert int(out2.split()[1]) == slot


# -- the wire protocol across the packages ----------------------------------------------

PAIRS = {
    "jax_client_port_runtime": (JProducerClient, Transport, SessionRuntime),
    "port_client_jax_runtime": (ProducerClient, JTransport, JSessionRuntime),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_wire_protocol_across_packages(tmp_path, pair):
    """HELLO with positions, PCM, a LAYOUT renegotiation, SILENCE, FORMAT
    and a rate re-route, then FAULT and EOF: the same replies, batches,
    layouts and view from either package's runtime, whichever package's
    client speaks."""
    client_cls, transport_cls, runtime_cls = PAIRS[pair]
    tp48 = transport_cls(n_streams=2, channels=4, block_frames=BLOCK, sample_rate=RATE)
    tp44 = transport_cls(n_streams=2, channels=4, block_frames=235, sample_rate=44_100.0)
    sock = str(tmp_path / "wire.sock")
    layouts = []
    rt = runtime_cls({RATE: tp48, 44_100.0: tp44}, sock, on_layout=lambda *a: layouts.append(a))
    try:
        c = client_cls(sock, {"app_name": "wire", "media_name": "m", "channels": 3,
                              "positions": ["FR", "FL", "bogus"]})
        slot = c.connect()
        assert slot is not None
        assert (c.channels, c.sample_rate, c.max_channels, c.positions) == (3, RATE, 4, ["FR", "FL", "FC"])
        rng = np.random.default_rng(5)
        pcm = rng.uniform(-1, 1, (BLOCK * 2, 3)).astype(np.float32)
        c.send_pcm(pcm, 0)
        batch, reset, _, _ = assemble_when_buffered(tp48, slot, BLOCK * 2)
        got = np.asarray(batch)[slot]
        assert reset[slot] and np.array_equal(got[:, :3], pcm[:BLOCK]) and np.all(got[:, 3] == 0.0)
        batch, _, _, _ = tp48.assemble()
        assert np.array_equal(np.asarray(batch)[slot, :, :3], pcm[BLOCK:])

        c.send_layout(2, positions=["FL", "FR"])
        c.send_silence(BLOCK, int(2 * BLOCK / RATE * 1e9))
        stereo = rng.uniform(-1, 1, (BLOCK, 2)).astype(np.float32)
        c.send_pcm(stereo, int(3 * BLOCK / RATE * 1e9))
        assert wait_for(lambda: len(layouts) >= 2 and tp48.buffered_frames(slot) >= BLOCK)
        filled, resets = drain_until(tp48, lambda f, r: f[slot] >= BLOCK)
        assert resets[slot] >= 1 and filled[slot] >= BLOCK

        c.send_format(1, sample_rate=44_100.0)  # re-routed to the 44.1 kHz bucket
        mono = rng.uniform(-1, 1, (470, 1)).astype(np.float32)
        c.send_pcm(mono, 0)
        assert wait_for(lambda: len(layouts) >= 3)
        slot44 = layouts[2][1]
        batch, reset, _, _ = assemble_when_buffered(tp44, slot44, 470)
        assert reset[slot44] and np.array_equal(np.asarray(batch)[slot44, :, 0], mono[:235, 0])
        c.send_fault()
        c.close()
        assert wait_for(lambda: "app.name:wire" not in rt.view()["active"])
        view = rt.view()
        assert view["links"]["app.name:wire"]["slot"] == slot44
        assert view["links"]["app.name:wire"]["sample_rate"] == 44_100.0
        assert view["links"]["app.name:wire"]["pcm_messages"] == 3
        assert [(r, n, [p.value for p in pos[:n]]) for r, _, n, pos in layouts] == [
            (RATE, 3, ["FR", "FL", "FC"]), (RATE, 2, ["FL", "FR"]), (44_100.0, 1, ["MONO"])]
        refused = client_cls(sock, {"app_name": "odd", "sample_rate": 96_000.0})
        assert refused.connect() is None and refused.refusal == {"slot": None, "unsupported_rate": 96_000.0}
    finally:
        rt.shutdown()


def test_wire_bytes_match(tmp_path):
    """Both packages' clients put the same bytes on the socket for the same
    calls."""
    import socket

    wires = []
    for client_cls in (JProducerClient, ProducerClient):
        path = str(tmp_path / f"{len(wires)}.sock")
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(path)
        listener.listen(1)
        got = bytearray()

        def serve():
            conn, _ = listener.accept()
            with conn:
                line = b""
                while not line.endswith(b"\n"):
                    line += conn.recv(1)
                got.extend(line)
                reply = {"slot": 1, "generation": 1, "channels": 2, "sample_rate": 48000.0,
                         "positions": ["FL", "FR"], "max_channels": 2}
                conn.sendall(json.dumps(reply).encode() + b"\n")
                while chunk := conn.recv(65536):
                    got.extend(chunk)

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        c = client_cls(path, {"app_name": "bytes", "channels": 2, "sample_rate": 48_000.0})
        assert c.connect() == 1
        c.send_pcm(np.arange(8, dtype=np.float32).reshape(4, 2), 123)
        c.send_pcm(np.arange(3, dtype=np.float32), 456)  # mono, padded to 2 columns
        c.send_silence(64, 789)
        c.send_format(1, sample_rate=44_100.0)
        c.send_layout(2, positions=["FL", "FR"], sample_rate=48_000.0)
        c.send_fault()
        c.close()
        t.join(timeout=30)
        listener.close()
        assert not t.is_alive()
        wires.append(bytes(got))
    assert wires[0] == wires[1]
