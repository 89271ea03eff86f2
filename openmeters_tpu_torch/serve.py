"""The serving loop: transport -> card -> meter drain (port of ``serve.py``).

One advance of :class:`MeterServer`:

- the C++ transport assembles a fixed ``[S, B, C]`` batch into one of two
  sets of pinned host buffers (idle watchdog, activity epochs and
  generation resets live in the transport);
- a copy stream sends the set to its own device buffer with a
  ``non_blocking`` copy and records an event, and the compute stream waits
  on that event, so the copy of hop N overlaps the assembly of hop N+1.
  Before the assembler writes into a set again it waits on the event of
  that set's last copy, and before a copy overwrites a device buffer the
  copy stream waits on the event of the step that read it;
- the engine steps the live carry, which it updates in place;
- every ``fetch_every``-th hop the meter leaves go into one ``torch.cat``,
  copied to a pinned host vector with an event; the drain waits on that
  event alone, so issuing never blocks on a fetch, and the latency from
  assembly to drained meters is kept per drained hop.

A backlog runs up to ``coalesce_blocks`` hops in one advance; pause stops
consuming; a cadenced spectrum (hop = R engine blocks) copies its blocks
into one device buffer ``[R, S, B, C]`` and steps every R hops, holding
its snapshot between.  ``scan_hops = K > 1`` runs K engine steps an
advance and keeps only the last snapshot.

Reconfiguration: :meth:`MeterServer.apply_settings_async` builds and warms
the new engine (two zero hops on its own CUDA stream, which fills the
host-built tables and plans and gives the meter layout) on a background
thread while the old one serves; the next advance adopts it, carrying the
live state over with :meth:`MeterEngine.migrate_carry`.  The warm-up
touches no tensor of the live carry.

Runs on the card unless given ``device="cpu"``; where no card is present
``"cuda"`` raises.  Not ported yet: ``declare_view`` and the view
histories, the settings watcher, the socket runtime (ROADMAP A11d), and a
mesh (A12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.utils._pytree as pytree

from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta
from openmeters_tpu_torch.ingest import Transport
from openmeters_tpu_torch.tracing import EngineStats


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_streams: int = 64
    channels: int = 2
    engine: EngineConfig | None = None
    realtime: bool = True  # pace to the hop cadence vs flat out
    coalesce_blocks: int = 4  # extra hops an advance may run on a backlog
    drain_depth: int = 0  # fetches in flight before a forced drain
    fetch: str = "meters"  # meters | full | none
    fetch_every: int = 6  # hops between host fetches (~30 Hz display rate)
    scan_hops: int = 1  # >1: K engine steps an advance, the last snapshot kept
    assembler_shards: int = 1  # host assembler threads
    ring_seconds: float = 4.0 / 3.0
    max_backlog_seconds: float = 1.0
    max_silence_seconds: float = 2.0


def _snapshot_leaves(snaps: dict) -> list[tuple[str, torch.Tensor]]:
    """``[(name, leaf)]`` of an engine hop's snapshots in the JAX package's
    order (analyzers sorted by name, fields in order), each named by its
    path as ``jax.tree_util.keystr`` prints it: ``['loudness'].momentary_lufs``."""
    ordered = {name: snaps[name] for name in sorted(snaps)}
    return [(pytree.keystr(path), leaf) for path, leaf in pytree.tree_flatten_with_path(ordered)[0]]


def _to_numpy(snap):
    return type(snap)(*(t.cpu().numpy() for t in snap))


@dataclasses.dataclass
class _Pipeline:
    """One engine config, warmed, and its meter layout."""

    engine: MeterEngine
    cadence: int
    picked: list  # per snapshot leaf: fetched (the meters, or all with fetch="full")
    packed_layout: list  # [(name, shape)] of the fetched leaves, in order


def _prepare_pipeline(engine: MeterEngine, config: ServeConfig, device: torch.device,
                      meta: StreamMeta) -> _Pipeline:
    """Warm ``engine``: two zero hops on a fresh carry (and two spectrum
    hops where the spectrum runs at its own cadence) on a CUDA stream of
    its own, which builds the kernels and fills the host-built caches (the
    update tiles, the block-FFT twiddle tables, the lifted matrices, the
    cuFFT plans); the warm snapshots give the meter layout.  Touches
    nothing of a server, so it may run on another thread while one serves."""
    cadence = engine.spectrum_cadence
    if config.scan_hops > 1 and cadence > 1 and config.scan_hops % cadence:
        raise ValueError(
            f"scan_hops ({config.scan_hops}) must be a multiple of the spectrum cadence ({cadence})"
        )
    s, b, c = config.n_streams, engine.config.block_frames, config.channels
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        carry = engine.init(s, device=device)
        zeros = torch.zeros((s, b, c), device=device)
        for _ in range(2):
            carry, snaps = engine.step(carry, zeros, meta)
        if cadence > 1:
            blocks = torch.zeros((cadence, s, b, c), device=device)
            sp = carry["spectrum"]
            for _ in range(2):
                sp, sp_snap = engine.spectrum_step(sp, blocks, meta)
            snaps = dict(snaps, spectrum=sp_snap)
        leaves = _snapshot_leaves(snaps)
        # a meter is a per-stream leaf of at most 16 values a stream; the
        # bulk leaves (columns, points) are read at the display's clock
        picked = [config.fetch == "full" or leaf.numel() <= 16 * s for _, leaf in leaves]
        _pack([leaf for (_, leaf), m in zip(leaves, picked) if m])
        del carry, snaps
    if stream is not None:
        stream.synchronize()
    layout = [(name, tuple(leaf.shape)) for (name, leaf), m in zip(leaves, picked) if m]
    return _Pipeline(engine, cadence, picked, layout)


def _pack(leaves: list) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """One f32 vector of ``leaves`` on the host: a ``torch.cat`` on the
    device copied to a pinned vector, and the event that says the copy is
    done (``None`` on the CPU, where it is done already)."""
    packed = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class MeterServer:
    """Owns the transport, the engine and the serving loop."""

    def __init__(self, config: ServeConfig, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("serving over a mesh of cards is not ported yet (ROADMAP A12)")
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("MeterServer: no CUDA device; pass device='cpu' to serve on the CPU")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.config = config
        engine_cfg = config.engine or EngineConfig()
        if engine_cfg.channels != config.channels:
            # serve at the transport's channel count
            engine_cfg = dataclasses.replace(engine_cfg, channels=config.channels)
        self.engine = MeterEngine(engine_cfg)
        ecfg = self.engine.config
        self.transport = Transport(
            n_streams=config.n_streams,
            channels=config.channels,
            block_frames=ecfg.block_frames,
            sample_rate=ecfg.sample_rate,
            ring_seconds=config.ring_seconds,
            max_backlog_seconds=config.max_backlog_seconds,
            max_silence_seconds=config.max_silence_seconds,
        )
        k, s, b, c = config.scan_hops, config.n_streams, ecfg.block_frames, config.channels
        host_meta = StreamMeta.default(s, channels=c, pad_channels=c)
        # per-stream layout rows: set_stream_layout edits the host rows, and
        # the next advance puts them on the device
        self._meta_lock = threading.Lock()
        self._meta_fold = host_meta.fold.numpy().copy()
        self._meta_weights = host_meta.weights.numpy().copy()
        self._meta_dirty = False
        self.meta = StreamMeta(*(t.to(device) for t in host_meta))
        cuda = device.type == "cuda"
        # two sets of K host buffer triples, and each set's device blocks
        self._buffers = [[self.transport.make_buffers(pin_memory=cuda) for _ in range(k)] for _ in range(2)]
        self._host_resets = [torch.zeros((k, s), dtype=torch.bool, pin_memory=cuda) for _ in range(2)]
        self._dev_blocks = [torch.zeros((k, s, b, c), device=device) for _ in range(2)]
        self._dev_resets = [torch.zeros((k, s), dtype=torch.bool, device=device) for _ in range(2)]
        self._copy_stream = torch.cuda.Stream(device) if cuda else None
        self._copied: list = [None, None]  # event: the set's last copy to the device is done
        self._consumed: list = [None, None]  # event: the steps reading the set's device blocks are done
        self._pool = ThreadPoolExecutor(config.assembler_shards) if config.assembler_shards > 1 else None
        self.paused = False
        self._stop = False
        self._resume_mask = None  # set by restore(): each stream's next reset is the resumption itself
        self.stats = EngineStats()
        self.latencies_ms: list[float] = []
        # host seconds spent assembling, issuing the copies, issuing the
        # steps, and draining fetches
        self.host_seconds = {"assemble": 0.0, "h2d": 0.0, "step": 0.0, "drain": 0.0}
        self.last_snapshot = None
        self._last_layout = None
        self.on_drain = None  # optional display-rate callback, once a drained fetch
        self.on_tick = None  # optional callback once a loop iteration, paused or not
        self._inflight: list = []
        self._buf_i = 0
        self._swap_thread = None
        self._pending_swap = None
        self._swap_error = None
        self._adopt_pipeline(
            _prepare_pipeline(self.engine, config, device, self.meta),
            self.engine.init(s, device=device),
            engine_cfg,
        )

    def _adopt_pipeline(self, pipe: _Pipeline, carry: dict, engine_cfg: EngineConfig) -> None:
        """The hop-boundary handoff: fetches in flight drain first (they
        were packed under the old layout), then the engine, layout and carry
        are swapped."""
        while self._inflight:
            self._drain_one()
        self.engine = pipe.engine
        self.config = dataclasses.replace(self.config, engine=engine_cfg)
        self._cadence = pipe.cadence
        self._picked = pipe.picked
        self._packed_layout = pipe.packed_layout
        self.carry = carry
        self._dev_meters = None  # the next advance's
        if self._cadence > 1:
            # the new cadence starts on a hop boundary, with a snapshot of
            # the carried averaging state held until its first hop
            s, b, c = self.config.n_streams, self.engine.config.block_frames, self.config.channels
            self._spec_blocks = torch.zeros((self._cadence, s, b, c), device=self.device)
            self._spec_resets = torch.zeros((self._cadence, s), dtype=torch.bool, device=self.device)
            self._spec_has_reset = False
            self._n_pending = 0
            self._dev_spectrum_snap = self.engine.analyzers["spectrum"].emit(self.carry["spectrum"])
        else:
            self._dev_spectrum_snap = None

    # -- control ------------------------------------------------------------

    def apply_settings(self, engine_cfg: EngineConfig) -> None:
        """Reconfigure the running server now: warm the new engine and carry
        the live state over (:meth:`MeterEngine.migrate_carry`), so a
        spectrum floor change keeps the loudness window, the trigger lock and
        the spectrum's PCM window.  ``sample_rate``, ``block_frames`` and
        ``channels`` belong to the transport and cannot change; a partly
        gathered spectrum hop is dropped."""
        engine_cfg, new_engine = self._validated_engine(engine_cfg)
        pipe = _prepare_pipeline(new_engine, self.config, self.device, self.meta)
        carry = new_engine.migrate_carry(self.engine, self.carry, self.config.n_streams)
        self._adopt_pipeline(pipe, carry, engine_cfg)

    def apply_settings_async(self, engine_cfg: EngineConfig) -> threading.Thread:
        """Reconfigure without stalling the hop cadence: the new engine is
        built and warmed on a background thread (and its own CUDA stream)
        while the old one serves, and the next :meth:`advance` adopts it.
        Validation errors raise here; a failure of the warm-up raises from
        the next ``advance()``.  Returns the thread (``join()`` it to wait
        until the swap is staged)."""
        engine_cfg, new_engine = self._validated_engine(engine_cfg)
        if self.reconfig_pending:
            raise RuntimeError(
                "a reconfiguration is already in flight; wait for it to be adopted before applying another"
            )
        cfg, device, meta = self.config, self.device, self.meta

        def work():
            try:
                self._pending_swap = (engine_cfg, _prepare_pipeline(new_engine, cfg, device, meta))
            except Exception as exc:  # raised from the serving loop
                self._swap_error = exc
            finally:
                self._swap_thread = None

        t = threading.Thread(target=work, name="openmeters-reconfig", daemon=True)
        self._swap_thread = t
        t.start()
        return t

    @property
    def reconfig_pending(self) -> bool:
        """True while an asynchronous reconfiguration is warming or staged."""
        return self._swap_thread is not None or self._pending_swap is not None

    def _maybe_adopt_pending(self) -> None:
        """Hop-boundary handoff for :meth:`apply_settings_async`."""
        err = self._swap_error
        if err is not None:
            self._swap_error = None
            raise RuntimeError("background reconfiguration failed") from err
        pending = self._pending_swap
        if pending is None:
            return
        self._pending_swap = None
        engine_cfg, pipe = pending
        carry = pipe.engine.migrate_carry(self.engine, self.carry, self.config.n_streams)
        self._adopt_pipeline(pipe, carry, engine_cfg)

    def _validated_engine(self, engine_cfg: EngineConfig):
        """Clamp ``channels`` to the transport's and refuse a change of the
        geometry the transport owns (``sample_rate``, ``block_frames``)."""
        if engine_cfg.channels != self.config.channels:
            engine_cfg = dataclasses.replace(engine_cfg, channels=self.config.channels)
        new_engine = MeterEngine(engine_cfg)
        ecfg, old_ecfg = new_engine.config, self.engine.config
        if (ecfg.sample_rate, ecfg.block_frames) != (old_ecfg.sample_rate, old_ecfg.block_frames):
            raise ValueError(
                "apply_settings cannot change sample_rate/block_frames of a running server (the "
                f"transport owns them); build a new MeterServer: {(ecfg.sample_rate, ecfg.block_frames)} "
                f"!= {(old_ecfg.sample_rate, old_ecfg.block_frames)}"
            )
        k, r = self.config.scan_hops, new_engine.spectrum_cadence
        if k > 1 and r > 1 and k % r:
            raise ValueError(f"scan_hops ({k}) must be a multiple of the new spectrum cadence ({r})")
        return engine_cfg, new_engine

    def set_paused(self, paused: bool) -> None:
        """Global pause: stop consuming."""
        self.paused = paused

    def stop(self) -> None:
        """Ask a running :meth:`run` loop to return after the current hop."""
        self._stop = True

    # -- checkpoint/restore ---------------------------------------------------

    def checkpoint(self, path: str) -> None:
        """Save the live carry (filter states, loudness windows, rings,
        trigger locks) to ``path``, so a restarted server resumes mid-window."""
        from openmeters_tpu_torch.checkpoint import save_state

        save_state(path, self.engine, self.carry)

    def restore(self, path: str) -> None:
        """Load a carry checkpoint into the live server (its engine config
        must match the fingerprint, its stream count the serving config's)."""
        from openmeters_tpu_torch.checkpoint import _flatten, _infer_streams, load_state

        carry = load_state(path, self.engine, device=self.device)
        n = _infer_streams(self.engine, dict(_flatten(carry)))
        if n != self.config.n_streams:
            raise ValueError(
                f"checkpoint holds {n} streams; server is configured for {self.config.n_streams}"
            )
        self.carry = carry
        if self._cadence > 1:
            # a partly gathered spectrum hop is dropped, and the held
            # snapshot is the restored averaging state's
            self._n_pending = 0
            self._spec_has_reset = False
            self._dev_spectrum_snap = self.engine.analyzers["spectrum"].emit(self.carry["spectrum"])
        # a restarted transport flags each stream's first data as a reset;
        # that reset is the resumption itself, so the first one per stream
        # is consumed and cannot wipe the restored carry
        self._resume_mask = np.ones((self.config.n_streams,), bool)

    def set_active(self, stream: int, active: bool) -> None:
        self.transport.set_active(stream, active)

    def set_stream_layout(self, stream: int, channels: int, positions=None) -> None:
        """Apply a producer's channel layout to one stream: its stereo fold
        row and its BS.1770 weight row (LFE x0, surround x1.41).  Safe from
        another thread; takes effect on the next hop."""
        from openmeters_tpu_torch.utils.channels import (
            channel_fallback,
            channel_weights,
            normalize_positions,
            stereo_matrix,
        )

        pad = self.config.channels
        channels = min(max(int(channels), 1), pad)
        positions = normalize_positions(channels, positions) if positions else channel_fallback(channels)
        fold = stereo_matrix(channels, positions)[:pad]
        weights = channel_weights(positions)[:pad].copy()
        weights[channels:] = 0.0  # frames past the producer's width are mute
        with self._meta_lock:
            self._meta_fold[stream] = fold
            self._meta_weights[stream] = weights
            self._meta_dirty = True

    # -- the loop -----------------------------------------------------------

    def _advance_one(self) -> None:
        cfg = self.config
        ecfg = self.engine.config
        k = cfg.scan_hops
        i = self._buf_i
        self._buf_i ^= 1
        if self._meta_dirty:
            with self._meta_lock:
                fold, weights = self._meta_fold.copy(), self._meta_weights.copy()
                self._meta_dirty = False
            self.meta = StreamMeta(torch.from_numpy(fold).to(self.device),
                                   torch.from_numpy(weights).to(self.device))
        t0 = time.perf_counter()
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # this set's last copy has left the buffers
        resets = []
        for j, out in enumerate(self._buffers[i]):
            _, rst, und, _ = self.transport.assemble(
                pool=self._pool, shards=cfg.assembler_shards, out=out, buf_id=i if k == 1 else None,
            )
            if self._resume_mask is not None:
                consumed = rst & self._resume_mask
                rst = rst & ~self._resume_mask
                self._resume_mask &= ~consumed
                if not self._resume_mask.any():
                    self._resume_mask = None
            resets.append(rst)
            self.stats.record(cfg.n_streams, ecfg.block_frames, ecfg.sample_rate,
                              resets=int(rst.sum()), underruns=int(und.sum()))
        t1 = time.perf_counter()
        blocks, dev_resets = self._dev_blocks[i], self._dev_resets[i]
        has_reset = [bool(r.any()) for r in resets]
        copy = self._copy_stream
        with torch.cuda.stream(copy) if copy is not None else contextlib.nullcontext():
            if copy is not None and self._consumed[i] is not None:
                copy.wait_event(self._consumed[i])  # the steps that read these blocks are done
            for j, (batch, _, _) in enumerate(self._buffers[i]):
                blocks[j].copy_(torch.from_numpy(batch), non_blocking=True)
                if has_reset[j]:
                    self._host_resets[i][j].numpy()[:] = resets[j]
                    dev_resets[j].copy_(self._host_resets[i][j], non_blocking=True)
            if copy is not None:
                self._copied[i] = torch.cuda.Event()
                self._copied[i].record(copy)
        if copy is not None:
            torch.cuda.current_stream(self.device).wait_event(self._copied[i])
        t2 = time.perf_counter()
        for j in range(k):
            # no mask on a hop without a reset: the analyzers read a mask
            # back to the host
            rst = dev_resets[j] if has_reset[j] else None
            self.carry, snaps = self.engine.step(self.carry, blocks[j], self.meta, rst)
            if self._cadence > 1:
                self._spectrum_block(blocks[j], rst)
        if copy is not None:
            self._consumed[i] = torch.cuda.Event()
            self._consumed[i].record()
        if self._cadence > 1:
            snaps = dict(snaps, spectrum=self._dev_spectrum_snap)
        leaves = _snapshot_leaves(snaps)
        # only the small meter leaves are kept for fetch_meters_now
        self._dev_meters = [leaf for (_, leaf), m in zip(leaves, self._picked) if m]
        fetch_now = cfg.fetch != "none" and (self.stats.hops // k) % max(cfg.fetch_every // k, 1) == 0
        if fetch_now:
            self._inflight.append((t0, *_pack(self._dev_meters), self._packed_layout))
        t3 = time.perf_counter()
        while len(self._inflight) > cfg.drain_depth:
            self._drain_one()
        h = self.host_seconds
        h["assemble"] += t1 - t0
        h["h2d"] += t2 - t1
        h["step"] += t3 - t2

    def _spectrum_block(self, block: torch.Tensor, reset) -> None:
        """Gather one engine block of the spectrum hop; step the spectrum on
        the R-th, with the per-block resets where the hop had any (blocks
        before a stream's reset are zeroed)."""
        n = self._n_pending
        self._spec_blocks[n].copy_(block)
        if reset is not None:
            if not self._spec_has_reset:
                self._spec_resets.zero_()
                self._spec_has_reset = True
            self._spec_resets[n].copy_(reset)
        self._n_pending = n + 1
        if self._n_pending == self._cadence:
            self.carry["spectrum"], self._dev_spectrum_snap = self.engine.spectrum_step(
                self.carry["spectrum"], self._spec_blocks, self.meta,
                self._spec_resets if self._spec_has_reset else None,
            )
            self._n_pending = 0
            self._spec_has_reset = False

    def _drain_one(self) -> None:
        if not self._inflight:
            return
        t = time.perf_counter()
        t0, host, done, layout = self._inflight.pop(0)
        if done is not None:
            done.synchronize()
        self.last_snapshot = host.numpy()
        self._last_layout = layout
        now = time.perf_counter()
        self.latencies_ms.append((now - t0) * 1e3)
        self.host_seconds["drain"] += now - t
        if self.on_drain is not None:
            self.on_drain(self)

    def advance(self) -> None:
        """One engine advance: a hop plus backlog catch-up (coalescing)."""
        self._maybe_adopt_pending()
        if self.paused:
            return
        self._advance_one()
        if self.config.scan_hops == 1:
            extra = min(self.transport.backlog_blocks(), self.config.coalesce_blocks - 1)
            for _ in range(extra):
                self._advance_one()

    def run(self, duration_s: float) -> dict:
        """Serve for ``duration_s`` wall seconds; returns the stats report."""
        ecfg = self.engine.config
        advance_s = ecfg.block_frames * self.config.scan_hops / ecfg.sample_rate
        t_start = time.perf_counter()
        deadline = t_start + advance_s
        end = t_start + duration_s
        self._stop = False
        while time.perf_counter() < end and not self._stop:
            if self.config.realtime:
                now = time.perf_counter()
                if now < deadline:
                    time.sleep(deadline - now)
                deadline += advance_s
                if deadline < now:  # fell behind: drop the missed ticks
                    deadline = now + advance_s
            if self.on_tick is not None:
                self.on_tick(self)
            self.advance()
        while self._inflight:
            self._drain_one()
        self.stats.wall_seconds = time.perf_counter() - t_start
        return self.report()

    def fetch_meters_now(self) -> dict[str, np.ndarray] | None:
        """The newest hop's meter leaves, fetched now (past the display-rate
        drain cadence)."""
        if self._dev_meters is None:
            return None
        host, done = _pack(self._dev_meters)
        if done is not None:
            done.synchronize()
        self.last_snapshot = host.numpy()
        self._last_layout = self._packed_layout
        return self.last_meters()

    def fetch_osc_traces(self, as_numpy: bool = True):
        """The oscilloscope's capture windows read from the live carry (the
        display's clock, not the hop's); ``None`` without an oscilloscope."""
        if "oscilloscope" not in self.engine.analyzers:
            return None
        snap = self.engine.extract_oscilloscope(self.carry)
        return _to_numpy(snap) if as_numpy else snap

    def fetch_spectrum(self, as_numpy: bool = True):
        """The newest spectrum snapshot at the display's clock: the one held
        from the last spectrum hop of a cadenced spectrum, else emitted from
        the live carry's averaging state (no transform); ``None`` without a
        spectrum."""
        if "spectrum" not in self.engine.analyzers:
            return None
        snap = self._dev_spectrum_snap
        if snap is None:
            snap = self.engine.analyzers["spectrum"].emit(self.carry["spectrum"])
        return _to_numpy(snap) if as_numpy else snap

    def last_meters(self) -> dict[str, np.ndarray] | None:
        """The newest drained fetch as named arrays (key: the leaf's path as
        the JAX package names it, e.g. ``['loudness'].momentary_lufs``)."""
        if self.last_snapshot is None:
            return None
        out = {}
        off = 0
        for name, shape in self._last_layout or self._packed_layout:
            size = int(np.prod(shape))
            out[name] = self.last_snapshot[off : off + size].reshape(shape)
            off += size
        return out

    def report(self) -> dict:
        lat = np.asarray(self.latencies_ms, np.float64)
        ecfg = self.engine.config
        hop_s = ecfg.block_frames / ecfg.sample_rate
        realtime_streams = self.config.n_streams * (self.stats.hops * hop_s) / max(self.stats.wall_seconds, 1e-9)
        return {
            "streams": self.config.n_streams,
            "hops": self.stats.hops,
            "resets": self.stats.resets,
            "underruns": self.stats.underruns,
            "audio_seconds": round(self.stats.audio_seconds, 3),
            "wall_seconds": round(self.stats.wall_seconds, 3),
            "realtime_factor": round(self.stats.realtime_factor, 2),
            "realtime_streams": int(realtime_streams),
            "latency_ms_p50": round(float(np.percentile(lat, 50)), 3) if lat.size else None,
            "latency_ms_p95": round(float(np.percentile(lat, 95)), 3) if lat.size else None,
            "latency_ms_max": round(float(lat.max()), 3) if lat.size else None,
        }

    def close(self) -> None:
        while self._inflight:
            self._drain_one()
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
        if self._pool:
            self._pool.shutdown()


class MultiRateMeterServer:
    """Serve streams of several sample rates at once: one
    :class:`MeterServer` a rate, its engine at :meth:`EngineConfig.at_rate`.
    Rate-scaled blocks hold equal wall time (256 at 48 kHz, 235 at 44.1 kHz),
    so one clock advances every bucket.  Producers reach a bucket through
    its ``transport``; the socket runtime is not ported yet (ROADMAP A11d)."""

    def __init__(self, config: ServeConfig, rates: tuple[float, ...] = (48_000.0,),
                 socket_path: str | None = None, mesh=None, device="cuda"):
        if socket_path is not None:
            raise NotImplementedError("the socket runtime is not ported yet (ROADMAP A11d)")
        self.servers: dict[float, MeterServer] = {}
        for r in sorted(float(r) for r in rates):
            self.servers[r] = MeterServer(
                dataclasses.replace(config, engine=self._at_rate(config.engine or EngineConfig(), r)),
                mesh=mesh, device=device,
            )

    @staticmethod
    def _at_rate(engine_cfg: EngineConfig, rate: float) -> EngineConfig:
        kw = {f.name: getattr(engine_cfg, f.name) for f in dataclasses.fields(engine_cfg)
              if f.name not in ("sample_rate", "block_frames")}
        return EngineConfig.at_rate(rate, **kw)

    def advance(self) -> None:
        for s in self.servers.values():
            s.advance()

    def apply_settings(self, engine_cfg: EngineConfig) -> None:
        """One settings config across every rate bucket, each keeping its
        own ``sample_rate`` and ``block_frames``."""
        for t in self.apply_settings_async(engine_cfg):
            t.join()
        for s in self.servers.values():
            s._maybe_adopt_pending()  # noqa: SLF001

    def apply_settings_async(self, engine_cfg: EngineConfig) -> list:
        """:meth:`MeterServer.apply_settings_async` per bucket; each adopts at
        its next hop boundary.  Returns the threads."""
        return [s.apply_settings_async(self._at_rate(engine_cfg, r)) for r, s in self.servers.items()]

    def run(self, duration_s: float) -> dict:
        cadence = min(
            s.engine.config.block_frames * s.config.scan_hops / s.engine.config.sample_rate
            for s in self.servers.values()
        )
        t_start = time.perf_counter()
        deadline = t_start + cadence
        end = t_start + duration_s
        while time.perf_counter() < end:
            if self.config.realtime:
                now = time.perf_counter()
                if now < deadline:
                    time.sleep(deadline - now)
                deadline += cadence
                if deadline < now:
                    deadline = now + cadence
            self.advance()
        wall = time.perf_counter() - t_start
        for s in self.servers.values():
            while s._inflight:  # noqa: SLF001
                s._drain_one()  # noqa: SLF001
            s.stats.wall_seconds = wall
        return self.report()

    @property
    def config(self) -> ServeConfig:
        return next(iter(self.servers.values())).config

    def report(self) -> dict:
        return {rate: s.report() for rate, s in self.servers.items()}

    def close(self) -> None:
        for s in self.servers.values():
            s.close()


def ingest_benchmark(
    n_streams: int, duration_s: float = 3.0, block_frames: int = 256,
    channels: int = 2, sample_rate: float = 48_000.0, feeder_threads: int = 4,
    assembler_shards: int = 1, realtime: bool = False,
) -> dict:
    """Host-only ingest throughput: native feeders push flat out (with
    backpressure) while the assembler drains; the C++ path's sustainable
    streams without any device work."""
    from openmeters_tpu_torch.ingest import Feeder

    tp = Transport(
        n_streams=n_streams, channels=channels, block_frames=block_frames,
        sample_rate=sample_rate, ring_seconds=4.0 / 3.0,
    )
    ring_frames = int(4.0 / 3.0 * sample_rate)
    feeder = Feeder(
        tp, realtime=realtime, n_threads=feeder_threads,
        max_buffered_frames=0 if realtime else ring_frames // 2,
    )
    pool = ThreadPoolExecutor(assembler_shards) if assembler_shards > 1 else None
    bufs = tp.make_buffers()
    t0 = time.perf_counter()
    hops = 0
    frames_out = 0
    while time.perf_counter() - t0 < duration_s:
        _, _, _, live = tp.assemble(pool=pool, shards=assembler_shards, out=bufs)
        hops += 1
        frames_out += block_frames * live
    wall = time.perf_counter() - t0
    ok, failed = feeder.stop()
    if pool:
        pool.shutdown()
    audio_s = frames_out / sample_rate
    return {
        "streams": n_streams,
        "hops": hops,
        "pushes_ok": ok,
        "pushes_failed": failed,
        "push_rate_per_s": int(ok / wall),
        "assembled_audio_seconds": round(audio_s, 2),
        "ingest_realtime_streams": int(audio_s / wall),
        "wall_seconds": round(wall, 3),
        "faults": sum(tp.fault_count(s) for s in range(min(n_streams, 64))),
    }
