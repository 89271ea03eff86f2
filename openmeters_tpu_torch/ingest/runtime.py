"""Session runtime: live producers → identity routing → transport (port of
``ingest/runtime.py``: the same wire protocol byte for byte, so a producer
of either package is served by the runtime of the other; it routes through
the port's ctypes :class:`~openmeters_tpu_torch.ingest.Transport`).

Reference parity: the PipeWire session loop (``src/infra/pipewire/
runtime.rs``), graph mirror (``graph.rs``) and routing planner
(``policy.rs``), re-targeted at this framework's capture boundary.  The
reference mirrors a PipeWire graph and passively taps routed playback nodes;
here the "graph" is a set of external producer connections on a Unix
socket — any process (a PipeWire bridge, a file streamer, a network relay)
can be a producer.  What carries over is the *semantics*:

- **Identity routing** (graph.rs ``StreamIdentity`` precedence): each
  producer announces properties in a HELLO; the :class:`StreamDirectory`
  assigns a batch slot, remembers identities across disconnects so a
  returning producer re-acquires its old slot, and flags truncation when
  the batch is full (policy.rs ``Plan::truncated``).
- **Format negotiation** (stream.rs:24-264): the HELLO reply echoes the
  *negotiated* channel count and sample rate; the producer must honor them
  (``ProducerClient`` adapts its payload).  FORMAT messages renegotiate
  channels (and optionally rate) mid-stream, routed through
  ``Transport.set_channels`` so the native ring never reinterprets payload
  bytes under the wrong layout.
- **Format generations** (stream.rs ``set_format``): every (re)connect and
  every FORMAT message bumps the slot's generation, which the transport
  converts into exactly one engine reset at the boundary.
- **Multi-rate routing** (meter.rs:20-25): streams are routed to the
  transport bucket matching their announced sample rate — one engine
  instance per rate, exactly how the reference scales ``DspBatcher`` and
  keys its FFT plans by rate.  A mid-stream rate change re-routes the
  producer to the new rate's bucket (reset-on-rate-change).
- **Per-link failure listeners** (runtime.rs:392-413): a socket error or
  EOF releases the slot, pushes a fault epoch, and the directory remembers
  the identity; clients reconnect with the session :class:`Backoff`.
  Slot ownership is per-connection: a duplicate identity HELLO while the
  first link is alive is refused (``busy``), and a stale connection's
  teardown can never release a slot a newer connection owns.

Wire protocol (little-endian):

- HELLO: one JSON line terminated by ``\\n`` — identity properties plus
  ``channels``/``sample_rate``.  Reply: ``{"slot", "generation",
  "channels", "sample_rate"}`` with the negotiated values, or
  ``{"slot": null, ...}`` on refusal (``truncated``, ``busy`` or
  ``unsupported_rate``).
- then framed messages: header ``<u32 kind, u32 frames, u64 timestamp_ns>``
  (16 bytes) followed by ``frames * channels`` f32 samples for PCM.
  Kinds: 0 = PCM, 1 = SILENCE (no payload), 2 = FAULT (no payload),
  3 = FORMAT (``frames`` carries the new channel count; ``timestamp_ns``
  carries the new sample rate in Hz, 0 = unchanged; bumps the generation
  like a renegotiation), 4 = LAYOUT (``frames`` = payload byte length;
  payload = one JSON object ``{"channels", "sample_rate"?, "positions"?}``
  — FORMAT plus a channel-position list, the full renegotiation of
  reference ``stream.rs:24-264``).

Channel positions (reference ``AudioFormat.positions``, dsp.rs:79-106)
ride the HELLO (optional ``"positions": ["FL","FR","FC","LFE",...]``) and
LAYOUT messages; the runtime normalizes them (dedup + fallback fill,
dsp.rs:49-76), echoes the result in the HELLO reply, and surfaces every
(re)negotiated layout through the ``on_layout`` callback so the serving
layer can derive per-stream fold matrices and BS.1770 weights
(dsp.rs:135-176, loudness/processor.rs:174-183).
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import threading
import time
from collections import OrderedDict

import numpy as np

from openmeters_tpu_torch.ingest.backoff import Backoff
from openmeters_tpu_torch.ingest.directory import StreamDirectory, StreamIdentity

MSG_PCM = 0
MSG_SILENCE = 1
MSG_FAULT = 2
MSG_FORMAT = 3
MSG_LAYOUT = 4
_HEADER = struct.Struct("<IIQ")


def _parse_positions(channels: int, raw) -> list:
    """Decode a wire position list (``["FL", "FR", ...]``) into normalized
    :class:`ChannelPosition`s; unknown tokens become UNKNOWN and fall back
    (reference dsp.rs:49-76).  ``raw=None`` yields the count fallback."""
    from openmeters_tpu_torch.utils.channels import (
        ChannelPosition,
        channel_fallback,
        normalize_positions,
    )

    if not raw:
        return channel_fallback(channels)
    decoded = []
    for token in list(raw)[:channels]:
        try:
            decoded.append(ChannelPosition(str(token)))
        except ValueError:
            decoded.append(ChannelPosition.UNKNOWN)
    return normalize_positions(channels, decoded)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class SessionRuntime:
    """Accepts producer connections and pumps them into transport buckets.

    ``transport`` is either a single Transport (single-rate session) or a
    ``{sample_rate: Transport}`` dict (multi-rate serving: one engine +
    transport per rate bucket, meter.rs:20-25).  One acceptor thread plus
    one pump thread per live producer; the hot path into each transport
    stays lock-free SPSC per stream slot.
    """

    def __init__(
        self,
        transport,
        socket_path: str,
        max_channels: int | None = None,
        default_rate: float | None = None,
        on_layout=None,
    ):
        """``on_layout(rate, slot, channels, positions)`` fires (from pump
        threads) on every negotiated layout: HELLO, FORMAT, LAYOUT, and rate
        re-routes — the hook the serving layer uses to maintain per-stream
        fold/weight rows (reference ``AudioFormat`` propagation)."""
        self._on_layout = on_layout
        if isinstance(transport, dict):
            buckets = {float(r): tp for r, tp in transport.items()}
        else:
            buckets = {float(transport.sample_rate): transport}
        self._buckets = {
            rate: (tp, StreamDirectory(tp.n_streams)) for rate, tp in buckets.items()
        }
        self._default_rate = (
            float(default_rate)
            if default_rate is not None
            else (48_000.0 if 48_000.0 in self._buckets else next(iter(self._buckets)))
        )
        self._path = socket_path
        self._max_channels = (
            max_channels
            if max_channels is not None
            else max(tp.channels for tp, _ in self._buckets.values())
        )
        self._lock = threading.Lock()  # directories + stats only, not PCM
        self._stats: OrderedDict[str, dict] = OrderedDict()
        self._stats_limit = 4 * sum(tp.n_streams for tp, _ in self._buckets.values()) + 64
        self._generation: dict[tuple[float, int], int] = {}
        self._owner: dict[str, int] = {}  # identity key -> owning conn id
        self._conn_ids = itertools.count(1)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(socket_path)
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()

    @property
    def directory(self) -> StreamDirectory:
        """The default rate bucket's directory (single-rate back-compat)."""
        return self._buckets[self._default_rate][1]

    # -- accept / pump -------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            # reap finished pump threads so a long-lived session with
            # reconnect churn doesn't accumulate handles (under the lock:
            # shutdown() snapshots this list concurrently)
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _note_stats(self, key: str, **updates):
        """Bounded per-identity link stats (locked by caller)."""
        entry = self._stats.pop(key, None) or {"connects": 0, "pcm_messages": 0}
        entry.update(updates)
        self._stats[key] = entry  # re-insert: LRU order
        while len(self._stats) > self._stats_limit:
            for old in self._stats:
                if old not in self._owner:  # never evict a live link
                    del self._stats[old]
                    break
            else:
                break

    def _next_generation(self, rate: float, slot: int) -> int:
        gen = self._generation.get((rate, slot), 0) + 1
        self._generation[(rate, slot)] = gen
        return gen

    def _serve(self, conn: socket.socket):
        conn_id = next(self._conn_ids)
        key = None
        slot = None
        tp = directory = None
        try:
            conn.settimeout(5.0)
            hello = bytearray()
            while not hello.endswith(b"\n"):
                chunk = conn.recv(1)
                if not chunk:
                    return
                hello.extend(chunk)
                if len(hello) > 65536:
                    return
            props = json.loads(hello.decode())
            identity = StreamIdentity(
                app_id=props.get("app_id"),
                app_name=props.get("app_name"),
                media_name=props.get("media_name"),
                node_name=props.get("node_name"),
            )
            key = identity.key
            rate = float(props.get("sample_rate", self._default_rate))
            bucket = self._buckets.get(rate)
            if bucket is None:
                conn.sendall(
                    json.dumps({"slot": None, "unsupported_rate": rate}).encode()
                    + b"\n"
                )
                return
            tp, directory = bucket
            # the clamp bound is fixed at HELLO time (the client mirrors it
            # for the whole link); a FORMAT rate re-route to a bucket too
            # narrow for the negotiated width drops the link instead of
            # desyncing — the client reconnects and renegotiates at HELLO
            wire_max = min(self._max_channels, tp.channels)
            channels = min(max(int(props.get("channels", 2)), 1), wire_max)
            positions = _parse_positions(channels, props.get("positions"))

            with self._lock:
                if key in self._owner:
                    # duplicate identity while the first link is alive: the
                    # slot has a single producer; refuse the newcomer
                    slot = None
                    conn.sendall(b'{"slot": null, "busy": true}\n')
                    return
                slot = directory.acquire(identity)
                if slot is None:  # batch full: refuse (Plan::truncated)
                    conn.sendall(b'{"slot": null, "truncated": true}\n')
                    return
                self._owner[key] = conn_id
                gen = self._next_generation(rate, slot)
                self._note_stats(
                    key,
                    slot=slot,
                    channels=channels,
                    sample_rate=rate,
                    connects=self._stats.get(key, {}).get("connects", 0) + 1,
                )
            tp.set_channels(slot, channels)
            tp.set_generation(slot, gen)
            if self._on_layout is not None:
                self._on_layout(rate, slot, channels, positions)
            conn.sendall(
                json.dumps(
                    {
                        "slot": slot,
                        "generation": gen,
                        "channels": channels,
                        "sample_rate": rate,
                        # the normalized layout (dedup + fallback fill) the
                        # engine will fold/weight with
                        "positions": [p.value for p in positions[:channels]],
                        # the clamp bound, so the client can mirror the
                        # server's FORMAT negotiation exactly for the whole
                        # link (rate re-routes that can't honor it drop the
                        # link rather than desync)
                        "max_channels": wire_max,
                    }
                ).encode()
                + b"\n"
            )

            while not self._stop.is_set():
                head = _recv_exact(conn, _HEADER.size)
                if head is None:
                    break
                kind, frames, ts_ns = _HEADER.unpack(head)
                if kind == MSG_PCM:
                    payload = _recv_exact(conn, frames * channels * 4)
                    if payload is None:
                        break
                    pcm = np.frombuffer(payload, np.float32).reshape(
                        frames, channels
                    )
                    tp.push_pcm(slot, pcm, ts_ns)
                    with self._lock:
                        self._stats[key]["pcm_messages"] += 1
                elif kind == MSG_SILENCE:
                    tp.push_silence(slot, frames, ts_ns)
                elif kind == MSG_FAULT:
                    tp.push_fault(slot)
                elif kind in (MSG_FORMAT, MSG_LAYOUT):
                    if kind == MSG_LAYOUT:
                        payload = _recv_exact(conn, frames)
                        if payload is None:
                            break
                        spec = json.loads(payload.decode())
                        new_channels = int(spec.get("channels", channels))
                        new_rate = float(spec.get("sample_rate") or rate)
                        raw_positions = spec.get("positions")
                    else:
                        new_channels = int(frames)
                        new_rate = float(ts_ns) if ts_ns > 0 else rate
                        raw_positions = None
                    channels = min(max(new_channels, 1), wire_max)
                    if new_rate != rate:
                        # rate change re-routes to the new rate's bucket
                        # (reset-on-rate-change, meter.rs:20-25)
                        nb = self._buckets.get(new_rate)
                        if nb is None:
                            break  # unsupported: drop the link (fault below)
                        tp.push_fault(slot)
                        with self._lock:
                            if self._owner.get(key) == conn_id:
                                directory.release(key)
                            tp, directory = nb
                            new_slot = directory.acquire(identity)
                            if new_slot is None:
                                del self._owner[key]
                                slot = None
                                break
                            slot = new_slot
                            rate = new_rate
                            self._note_stats(key, slot=slot, sample_rate=rate)
                        if channels > tp.channels:
                            # the new bucket is too narrow for the width the
                            # client negotiated at HELLO: drop the link (the
                            # client's backoff reconnect renegotiates fresh)
                            break
                    positions = _parse_positions(channels, raw_positions)
                    with self._lock:
                        gen = self._next_generation(rate, slot)
                        self._note_stats(key, channels=channels)
                    tp.set_channels(slot, channels)
                    tp.set_generation(slot, gen)
                    if self._on_layout is not None:
                        self._on_layout(rate, slot, channels, positions)
                else:
                    break
        except (OSError, ValueError, json.JSONDecodeError):
            pass  # per-link failure listener: fall through to release
        finally:
            conn.close()
            if slot is not None:
                # link failure/closure: fault epoch -> one engine reset,
                # identity remembered for re-acquisition (runtime.rs:392-413)
                tp.push_fault(slot)
                with self._lock:
                    # release only if this connection still owns the key (a
                    # newer connection may have preempted after our refusal)
                    if self._owner.get(key) == conn_id:
                        del self._owner[key]
                        directory.release(key)

    # -- observability (CaptureView analogue, pipewire.rs:96-149) ------------

    def view(self) -> dict:
        with self._lock:
            merged = {
                "active": {},
                "remembered": [],
                "free_slots": 0,
                "truncated": False,
                "rates": {},
                "timestamp": time.time(),
            }
            for rate, (_, directory) in sorted(self._buckets.items()):
                v = directory.view()
                merged["active"].update(v["active"])
                merged["remembered"].extend(v["remembered"])
                merged["free_slots"] += v["free_slots"]
                merged["truncated"] |= v["truncated"]
                merged["rates"][rate] = {
                    "active": len(v["active"]),
                    "free_slots": v["free_slots"],
                }
            merged["links"] = {k: dict(s) for k, s in self._stats.items()}
        return merged

    def shutdown(self):
        self._stop.set()
        try:
            self._listener.close()
        finally:
            # the acceptor exits on listener close/stop; joining it FIRST
            # guarantees no new pump thread appears after the snapshot below
            self._acceptor.join(timeout=2.0)
            with self._lock:
                threads = list(self._threads)
            for t in threads:
                if t.is_alive():
                    t.join(timeout=2.0)
            if os.path.exists(self._path):
                os.unlink(self._path)


class ProducerClient:
    """Client side: connect (with session backoff), announce, stream PCM.

    After :meth:`connect`, ``channels``/``sample_rate`` hold the *negotiated*
    format from the HELLO reply; :meth:`send_pcm` adapts its payload to the
    negotiated channel count (truncating or zero-padding columns) so the
    framed protocol can never desync on a format disagreement.

    Used by external producer processes (see ``producer.py``) and by the
    hermetic integration tests.
    """

    def __init__(self, socket_path: str, props: dict, timeout: float = 10.0):
        self._path = socket_path
        self._props = dict(props)
        self._timeout = timeout
        self.sock: socket.socket | None = None
        self.slot: int | None = None
        self.channels: int | None = None
        self.sample_rate: float | None = None
        self.max_channels: int | None = None
        self.positions: list | None = None
        self.refusal: dict | None = None

    def connect(self) -> int | None:
        """Connect with exponential backoff; returns the assigned slot, or
        None if the runtime refused (truncated/busy/unsupported rate — see
        ``refusal`` for the reply)."""
        backoff = Backoff.session()
        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline:
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(5.0)
                s.connect(self._path)
                s.sendall(json.dumps(self._props).encode() + b"\n")
                reply = bytearray()
                while not reply.endswith(b"\n"):
                    chunk = s.recv(1)
                    if not chunk:
                        raise OSError("runtime closed during hello")
                    reply.extend(chunk)
                r = json.loads(reply.decode())
                if r.get("slot") is None:
                    s.close()
                    self.refusal = r
                    return None
                backoff.success()
                self.sock = s
                self.slot = int(r["slot"])
                self.channels = int(r.get("channels", self._props.get("channels", 2)))
                self.sample_rate = float(r.get("sample_rate", 48_000.0))
                self.max_channels = int(r.get("max_channels", self.channels))
                self.positions = r.get("positions")  # normalized by the runtime
                return self.slot
            except OSError:
                time.sleep(min(backoff.failure(), max(deadline - time.monotonic(), 0)))
        raise TimeoutError(f"could not reach session runtime at {self._path}")

    def send_pcm(self, samples: np.ndarray, timestamp_ns: int):
        pcm = np.ascontiguousarray(samples, np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if self.channels is not None and pcm.shape[1] != self.channels:
            # honor the negotiated layout: truncate or zero-pad columns
            if pcm.shape[1] > self.channels:
                pcm = np.ascontiguousarray(pcm[:, : self.channels])
            else:
                pcm = np.concatenate(
                    [pcm, np.zeros((pcm.shape[0], self.channels - pcm.shape[1]), np.float32)],
                    axis=1,
                )
        head = _HEADER.pack(MSG_PCM, pcm.shape[0], timestamp_ns)
        self.sock.sendall(head + pcm.tobytes())

    def send_silence(self, frames: int, timestamp_ns: int):
        self.sock.sendall(_HEADER.pack(MSG_SILENCE, frames, timestamp_ns))

    def send_fault(self):
        self.sock.sendall(_HEADER.pack(MSG_FAULT, 0, 0))

    def send_layout(
        self, channels: int, positions=None, sample_rate: float | None = None
    ):
        """Full mid-stream renegotiation including channel positions
        (MSG_LAYOUT; reference ``stream.rs`` set_format semantics)."""
        spec = {"channels": int(channels)}
        if sample_rate:
            spec["sample_rate"] = float(sample_rate)
        if positions is not None:
            spec["positions"] = [
                p.value if hasattr(p, "value") else str(p) for p in positions
            ]
        payload = json.dumps(spec).encode()
        self.sock.sendall(_HEADER.pack(MSG_LAYOUT, len(payload), 0) + payload)
        negotiated = max(int(channels), 1)
        if self.max_channels is not None:
            negotiated = min(negotiated, self.max_channels)
        self.channels = negotiated
        if sample_rate:
            self.sample_rate = float(sample_rate)

    def send_format(self, channels: int, sample_rate: float | None = None):
        """Renegotiate channels (and optionally rate) mid-stream.  FORMAT
        has no reply, so the client mirrors the server's clamp rule
        (min(max(ch,1), max_channels from the HELLO reply)) to keep the
        framed payload width in lockstep."""
        rate_field = int(sample_rate) if sample_rate else 0
        self.sock.sendall(_HEADER.pack(MSG_FORMAT, channels, rate_field))
        negotiated = max(int(channels), 1)
        if self.max_channels is not None:
            negotiated = min(negotiated, self.max_channels)
        self.channels = negotiated
        if sample_rate:
            self.sample_rate = float(sample_rate)

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None
