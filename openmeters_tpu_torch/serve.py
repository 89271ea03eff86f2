"""The serving loop: transport -> card -> meter drain (port of ``serve.py``).

One advance of :class:`MeterServer`:

- the C++ transport's descriptor pass writes, into one of two sets of
  pinned host buffers, a descriptor for each row of a fixed ``[S, B, C]``
  batch: where in its ring the row's samples lie (idle watchdog, activity
  epochs and generation resets live in the transport; the rare row that no
  descriptor can name is copied into the set's staging batch);
- on a copy stream, a gather kernel (``ops/ring_gather.py``) reads the
  rows straight from the rings, mapped pinned host memory, into the set's
  device buffer and records an event, and the compute stream waits on that
  event, so the gather of hop N overlaps the assembly of hop N+1.  Before
  the assembler writes into a set again it waits on the event of that
  set's last gather (its first pass into the set then gives the ring space
  that gather read back to the producers), and before a gather overwrites
  a device buffer the copy stream waits on the event of the step that read
  it (on the CPU the gather is an index gather of the arena, done at
  once);
- the engine steps the live carry, which it updates in place;
- every ``fetch_every``-th hop the meter leaves go into one ``torch.cat``,
  copied to a pinned host vector with an event; the drain waits on that
  event alone, so issuing never blocks on a fetch, and the latency from
  assembly to drained meters is kept for the last ``LATENCY_WINDOW``
  drained hops.

Each stretch of a hop is a :class:`~openmeters_tpu_torch.tracing.span`
(the tree is in ``tracing.py``); four of them add their seconds to
``MeterServer.host_seconds``.

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

View histories: :meth:`MeterServer.declare_view` sizes host rings of
spectrogram columns and waveform columns that the display-rate drain feeds
(``fetch="full"``); :func:`attach_settings_watcher` hot-reloads a server
from its settings file; :class:`MultiRateMeterServer` with a
``socket_path`` serves external producers through the session runtime
(``ingest/runtime.py``).

Runs on the card unless given ``device="cpu"``; where no card is present
``"cuda"`` raises.  Over a mesh (``mesh=``, a
:class:`~openmeters_tpu_torch.engine.sharding.StreamMesh`) the streams
are cut into one run a shard: each shard has its own device buffers, copy
stream and events, carry and meter vector; an advance gathers each shard's
rows onto its device and issues every shard's step from
this thread, and the drain joins the shards' meter vectors leaf by leaf
along each leaf's stream dim, so ``last_meters()`` reads as an unsharded
server's.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.utils._pytree as pytree

from openmeters_tpu_torch.analyzers.spectrogram import history_columns
from openmeters_tpu_torch.engine import EngineConfig, MeterEngine, StreamMeta
from openmeters_tpu_torch.engine.sharding import (
    ShardedCarry,
    gather_snapshots,
    on_device,
    place_carry,
    snapshot_stream_dims,
)
from openmeters_tpu_torch.ingest import Transport
from openmeters_tpu_torch.ingest.transport import ROW_KINDS
from openmeters_tpu_torch.ops.ring_gather import mapped_addresses, ring_gather
from openmeters_tpu_torch.tracing import EngineStats, span
from openmeters_tpu_torch.views import SpectrogramHistory, WaveformHistory, waveform_columns_from_meters

LATENCY_WINDOW = 4096  # drained fetches whose latencies report() reads


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


def _rows(snap, stream: int | None):
    """``snap`` whole, or only the rows of ``stream`` (a leading axis of 1)."""
    return snap if stream is None else type(snap)(*(t[stream : stream + 1] for t in snap))


@dataclasses.dataclass
class _Pipeline:
    """One engine config, warmed, and its meter layout."""

    engine: MeterEngine
    cadence: int
    picked: list  # per snapshot leaf: fetched (the meters, or all with fetch="full")
    packed_layout: list  # [(name, shape)] of the fetched leaves, in order, all streams
    shard_dims: list | None  # over a mesh: each fetched leaf's stream dim (None: shard 0's)
    snapshot_dims: dict | None  # over a mesh: every snapshot leaf's stream dim, by analyzer


@dataclasses.dataclass
class _Shard:
    """A device's run of streams ``[lo, hi)`` and its state: the device
    blocks and reset masks of both buffer sets, the copy stream and its
    events, the carry, a cadenced spectrum's gathered blocks and held
    snapshot, and the newest hop's meter leaves.  An unsharded server is
    one shard of every stream."""

    device: torch.device
    lo: int
    hi: int
    meta: StreamMeta
    blocks: list  # per buffer set: [K, n, B, C]
    resets: list  # per buffer set: [K, n] bool
    copy_stream: torch.cuda.Stream | None
    mapped: list | None = None  # per buffer set and hop: the card's addresses of the gather's sources
    carry: dict | None = None
    copied: list = dataclasses.field(default_factory=lambda: [None, None])  # the set's last gather is done
    consumed: list = dataclasses.field(default_factory=lambda: [None, None])  # the steps reading it are done
    spec_blocks: torch.Tensor | None = None
    spec_resets: torch.Tensor | None = None
    spec_has_reset: bool = False
    spectrum_snap: object = None
    meters: list | None = None

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def on(self):
        return on_device(self.device)


def _prepare_pipeline(engine: MeterEngine, config: ServeConfig, shards: list) -> _Pipeline:
    """Warm ``engine`` on each shard's device: two zero hops on a fresh
    carry (and two spectrum hops where the spectrum runs at its own
    cadence) on a CUDA stream of its own, which builds the kernels, records
    the loudness step's CUDA graphs (a set a shard) and fills the
    host-built caches (the update tiles, the block-FFT twiddle tables, the
    lifted matrices, the cuFFT plans); the warm snapshots give
    the meter layout (over a mesh, with each leaf's stream dim).  Touches
    nothing of a server, so it may run on another thread while one serves."""
    cadence = engine.spectrum_cadence
    if config.scan_hops > 1 and cadence > 1 and config.scan_hops % cadence:
        raise ValueError(
            f"scan_hops ({config.scan_hops}) must be a multiple of the spectrum cadence ({cadence})"
        )
    b, c = engine.config.block_frames, config.channels
    warm = []  # each shard's warm carry, held until every shard is warm: the
    # first step of each records a loudness graph set of its own
    for sh in shards:
        s, device = sh.n, sh.device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        with sh.on(), torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            carry = engine.init(s, device=device)
            zeros = torch.zeros((s, b, c), device=device)
            for _ in range(2):
                carry, snaps = engine.step(carry, zeros, sh.meta)
            warm.append(carry)
            if cadence > 1:
                blocks = torch.zeros((cadence, s, b, c), device=device)
                sp = carry["spectrum"]
                for _ in range(2):
                    sp, sp_snap = engine.spectrum_step(sp, blocks, sh.meta)
                snaps = dict(snaps, spectrum=sp_snap)
            leaves = _snapshot_leaves(snaps)
            # a meter is a per-stream leaf of at most 16 values a stream; the
            # bulk leaves (columns, points) are read at the display's clock
            picked = [config.fetch == "full" or leaf.numel() <= 16 * s for _, leaf in leaves]
            _pack([leaf for (_, leaf), m in zip(leaves, picked) if m])
            del carry, snaps
        if stream is not None:
            stream.synchronize()
    del warm
    layout = [(name, tuple(leaf.shape)) for (name, leaf), m in zip(leaves, picked) if m]
    dims = shard_dims = None
    if len(shards) > 1:
        dims = snapshot_stream_dims(engine)
        if cadence > 1:
            dims = dict(dims, spectrum=snapshot_stream_dims(engine, "spectrum"))
        # -1 for no stream dim: a None is no leaf to every pytree
        flat = _snapshot_leaves(pytree.tree_map(lambda d: -1 if d is None else d, dims, is_leaf=lambda d: d is None))
        shard_dims = [None if d < 0 else d for (_, d), m in zip(flat, picked) if m]
        layout = [
            (name, shape if d is None else (*shape[:d], shape[d] * len(shards), *shape[d + 1 :]))
            for (name, shape), d in zip(layout, shard_dims)
        ]
    return _Pipeline(engine, cadence, picked, layout, shard_dims, dims)


def _pack(leaves: list) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """One f32 vector of ``leaves`` on the host: a ``torch.cat`` on the
    device copied to a pinned vector, and the event on the device's current
    stream that says the copy is done (``None`` on the CPU, where it is
    done already)."""
    packed = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(packed.device))
    return host, done


def _join_meters(hosts: list, layout: list, shard_dims: list | None) -> np.ndarray:
    """One meter vector of every stream from the shards' vectors (each
    leaf-major over its own streams, never to be concatenated whole): leaf
    by leaf, the shards' pieces joined along the leaf's stream dim; a leaf
    without one is shard 0's."""
    if shard_dims is None:
        return hosts[0].numpy()
    n = len(hosts)
    vecs = [h.numpy() for h in hosts]
    out, off = [], 0
    for (_, shape), d in zip(layout, shard_dims):
        local = shape if d is None else (*shape[:d], shape[d] // n, *shape[d + 1 :])
        size = int(np.prod(local))
        pieces = [v[off : off + size].reshape(local) for v in vecs]
        out.append((pieces[0] if d is None else np.concatenate(pieces, axis=d)).reshape(-1))
        off += size
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


class MeterServer:
    """Owns the transport, the engine and the serving loop.

    ``mesh`` (a :class:`~openmeters_tpu_torch.engine.sharding.StreamMesh`
    whose devices are of ``device``'s type) cuts the streams over its
    devices; ``n_streams`` must divide by its size."""

    def __init__(self, config: ServeConfig, mesh=None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("MeterServer: no CUDA device; pass device='cpu' to serve on the CPU")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        devices = (device,) if mesh is None else mesh.shard_devices()
        if any(d.type != device.type for d in devices):
            raise ValueError(f"a mesh of {sorted({str(d) for d in devices})} for a server on {device.type}")
        if config.n_streams % len(devices):
            raise ValueError(f"{config.n_streams} streams do not divide over {len(devices)} shards")
        self.mesh = mesh
        self.device = devices[0]
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
        cuda = device.type == "cuda"
        # two sets of K host buffers (staging batch, masks, descriptors);
        # each shard has its rows of both sets on its device
        self._buffers = [[self.transport.make_desc_buffers(pin_memory=cuda) for _ in range(k)] for _ in range(2)]
        self._gather_src = [[(torch.from_numpy(st), torch.from_numpy(d)) for st, _, _, d in bufs]
                            for bufs in self._buffers]
        self._arena = self.transport.arena_tensor()
        if cuda:
            self.transport.pin_arena(devices)
        self._host_resets = [torch.zeros((k, s), dtype=torch.bool, pin_memory=cuda) for _ in range(2)]
        per = s // len(devices)
        self._shards = []
        for i, dev in enumerate(devices):
            lo, hi = i * per, (i + 1) * per
            self._shards.append(_Shard(
                dev, lo, hi, StreamMeta(*(t[lo:hi].to(dev) for t in host_meta)),
                [torch.zeros((k, per, b, c), device=dev) for _ in range(2)],
                [torch.zeros((k, per), dtype=torch.bool, device=dev) for _ in range(2)],
                torch.cuda.Stream(dev) if cuda else None,
            ))
            if cuda:
                with on_device(dev):
                    self._shards[-1].mapped = [[mapped_addresses(self._arena, st, d) for st, d in src]
                                               for src in self._gather_src]
        self._pool = ThreadPoolExecutor(config.assembler_shards) if config.assembler_shards > 1 else None
        self.paused = False
        self._stop = False
        self._resume_mask = None  # set by restore(): each stream's next reset is the resumption itself
        self.stats = EngineStats()
        self.latencies_ms: collections.deque[float] = collections.deque(maxlen=LATENCY_WINDOW)
        # host seconds spent assembling, issuing the gathers, issuing the
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
        self._view_histories: dict = {}  # declare_view's host rings
        self._view_stream = 0
        pipe = _prepare_pipeline(self.engine, config, self._shards)  # before the carries: its peak is transient
        carries = []
        for sh in self._shards:
            with sh.on():
                carries.append(self.engine.init(sh.n, device=sh.device))
        self._adopt_pipeline(pipe, carries, engine_cfg)

    @property
    def carry(self):
        """The live carry: an engine carry, or over a mesh a
        :class:`~openmeters_tpu_torch.engine.sharding.ShardedCarry`."""
        if self.mesh is None:
            return self._shards[0].carry
        return ShardedCarry(sh.carry for sh in self._shards)

    def _placed(self, carry: dict) -> list:
        """An engine carry of every stream as one carry a shard."""
        if self.mesh is None:
            return [carry]
        return place_carry(self.engine, self.mesh, carry)

    def _adopt_pipeline(self, pipe: _Pipeline, carries: list, engine_cfg: EngineConfig) -> None:
        """The hop-boundary handoff: fetches in flight drain first (they
        were packed under the old layout), then the engine, layout and
        carries (one a shard) are swapped."""
        while self._inflight:
            self._drain_one()
        self.engine = pipe.engine
        self.config = dataclasses.replace(self.config, engine=engine_cfg)
        self._cadence = pipe.cadence
        self._picked = pipe.picked
        self._packed_layout = pipe.packed_layout
        self._shard_dims = pipe.shard_dims
        self._snapshot_dims = pipe.snapshot_dims
        self._n_pending = 0
        b, c = self.engine.config.block_frames, self.config.channels
        for sh, carry in zip(self._shards, carries):
            sh.carry = carry
            sh.meters = None
            if self._cadence > 1:
                # the new cadence starts on a hop boundary, with a snapshot
                # of the carried averaging state held until its first hop
                with sh.on():
                    sh.spec_blocks = torch.zeros((self._cadence, sh.n, b, c), device=sh.device)
                    sh.spec_resets = torch.zeros((self._cadence, sh.n), dtype=torch.bool, device=sh.device)
                    sh.spec_has_reset = False
                    sh.spectrum_snap = self.engine.analyzers["spectrum"].emit(carry["spectrum"])
            else:
                sh.spectrum_snap = None
        self._revalidate_view_histories()

    def _revalidate_view_histories(self) -> None:
        """Re-fit the declared rings after a reconfiguration: a changed FFT
        geometry changes the spectrogram column width; a removed analyzer
        drops its ring."""
        hist = self._view_histories.get("spectrogram")
        if hist is None:
            return
        sg = self.engine.analyzers.get("spectrogram")
        if sg is None:
            del self._view_histories["spectrogram"]
            return
        bins = sg.padded_fft // 2 + 1
        if bins != hist.bins:
            self._view_histories["spectrogram"] = SpectrogramHistory(
                bins, history_columns(sg.config.use_reassignment, bins, hist.columns)
            )

    # -- control ------------------------------------------------------------

    def apply_settings(self, engine_cfg: EngineConfig) -> None:
        """Reconfigure the running server now: warm the new engine and carry
        the live state over (:meth:`MeterEngine.migrate_carry`), so a
        spectrum floor change keeps the loudness window, the trigger lock and
        the spectrum's PCM window.  ``sample_rate``, ``block_frames`` and
        ``channels`` belong to the transport and cannot change; a partly
        gathered spectrum hop is dropped."""
        engine_cfg, new_engine = self._validated_engine(engine_cfg)
        pipe = _prepare_pipeline(new_engine, self.config, self._shards)
        self._adopt_pipeline(pipe, self._migrated(new_engine), engine_cfg)

    def _migrated(self, new_engine: MeterEngine) -> list:
        """Each shard's carry carried over to ``new_engine``
        (:meth:`MeterEngine.migrate_carry`), on the shard's device."""
        out = []
        for sh in self._shards:
            with sh.on():
                out.append(new_engine.migrate_carry(self.engine, sh.carry, sh.n))
        return out

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
        cfg, shards = self.config, list(self._shards)

        def work():
            try:
                self._pending_swap = (engine_cfg, _prepare_pipeline(new_engine, cfg, shards))
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
        self._adopt_pipeline(pipe, self._migrated(pipe.engine), engine_cfg)

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
        trigger locks) to ``path``, so a restarted server resumes mid-window
        (over a mesh the shards are gathered: it restores onto a mesh of
        any size, or onto one device)."""
        from openmeters_tpu_torch.checkpoint import save_state

        save_state(path, self.engine, self.carry)

    def restore(self, path: str) -> None:
        """Load a carry checkpoint into the live server (its engine config
        must match the fingerprint, its stream count the serving config's)."""
        from openmeters_tpu_torch.checkpoint import _flatten, _infer_streams, load_state

        carry = load_state(path, self.engine, device=self.device if self.mesh is None else "cpu")
        n = _infer_streams(self.engine, dict(_flatten(carry)))
        if n != self.config.n_streams:
            raise ValueError(
                f"checkpoint holds {n} streams; server is configured for {self.config.n_streams}"
            )
        self._n_pending = 0
        for sh, c in zip(self._shards, self._placed(carry)):
            sh.carry = c
            if self._cadence > 1:
                # a partly gathered spectrum hop is dropped, and the held
                # snapshot is the restored averaging state's
                sh.spec_has_reset = False
                with sh.on():
                    sh.spectrum_snap = self.engine.analyzers["spectrum"].emit(c["spectrum"])
        # a restarted transport flags each stream's first data as a reset;
        # that reset is the resumption itself, so the first one per stream
        # is consumed and cannot wipe the restored carry
        self._resume_mask = np.ones((self.config.n_streams,), bool)

    def set_active(self, stream: int, active: bool) -> None:
        self.transport.set_active(stream, active)

    def declare_view(self, stream: int = 0, spectrogram_columns: int | None = None,
                     waveform_columns: int | None = None) -> dict:
        """A display declares, before ingest, how much history of one stream
        it shows; the server keeps host rings of that size, clamped by the
        history budget (:func:`history_columns`: 128 MiB, 8192 columns;
        the waveform's ``MAX_COLUMN_CAPACITY``), and the display-rate drain
        feeds them (``fetch="full"``: meter mode fetches no bulk leaves).
        Returns the granted retention."""
        granted = {}
        sg = self.engine.analyzers.get("spectrogram")
        if spectrogram_columns is not None and sg is not None:
            bins = sg.padded_fft // 2 + 1
            cols = history_columns(sg.config.use_reassignment, bins, spectrogram_columns)
            hist = self._view_histories.get("spectrogram")
            if hist is None or hist.bins != bins:
                self._view_histories["spectrogram"] = SpectrogramHistory(bins, cols)
            else:
                hist.resize(cols)
            granted["spectrogram_columns"] = cols
        if waveform_columns is not None and "waveform" in self.engine.analyzers:
            hist = self._view_histories.get("waveform")
            if hist is None:
                self._view_histories["waveform"] = WaveformHistory(max_columns=waveform_columns)
            else:
                hist.resize(waveform_columns)
            granted["waveform_columns"] = self._view_histories["waveform"].max_columns
        self._view_stream = stream
        return granted

    def _feed_histories(self) -> None:
        """Push the drained bulk leaves of the declared stream into its
        rings."""
        if not self._view_histories:
            return
        meters = self.last_meters()
        if not meters:
            return
        st = self._view_stream
        sg_hist = self._view_histories.get("spectrogram")
        if sg_hist is not None:
            codes_key = next((k for k in meters if "spectrogram" in k and "codes" in k), None)
            valid_key = next((k for k in meters if "spectrogram" in k and "valid" in k), None)
            if codes_key and valid_key:
                codes = meters[codes_key][st]
                valid = meters[valid_key][st].astype(bool)
                if valid.any():
                    sg_hist.push(codes[valid].astype(np.uint16))
        wf_hist = self._view_histories.get("waveform")
        if wf_hist is not None:
            cols = waveform_columns_from_meters(meters, st)
            if cols:
                wf_hist.push_columns(cols)

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
        with span("serve.hop"):
            self._hop()

    def _hop(self) -> None:
        cfg = self.config
        ecfg = self.engine.config
        k = cfg.scan_hops
        i = self._buf_i
        self._buf_i ^= 1
        h = self.host_seconds
        if self._meta_dirty:
            with self._meta_lock:
                fold, weights = self._meta_fold.copy(), self._meta_weights.copy()
                self._meta_dirty = False
            for sh in self._shards:
                sh.meta = StreamMeta(torch.from_numpy(fold[sh.lo : sh.hi]).to(sh.device),
                                     torch.from_numpy(weights[sh.lo : sh.hi]).to(sh.device))
        t0 = time.perf_counter()
        with span("serve.assemble", h, "assemble"):
            with span("serve.copy_wait"):
                for sh in self._shards:
                    if sh.copied[i] is not None:
                        sh.copied[i].synchronize()  # this set's last gather has left the buffers and rings
            resets = []
            for j, out in enumerate(self._buffers[i]):
                # the first pass gives back the ring space this set's last gather read
                rst, und, _ = self.transport.assemble_desc(out, i, pool=self._pool, shards=cfg.assembler_shards,
                                                           release=j == 0)
                if self._resume_mask is not None:
                    consumed = rst & self._resume_mask
                    rst = rst & ~self._resume_mask
                    self._resume_mask &= ~consumed
                    if not self._resume_mask.any():
                        self._resume_mask = None
                resets.append(rst)
                self.stats.record(cfg.n_streams, ecfg.block_frames, ecfg.sample_rate,
                                  resets=int(rst.sum()), underruns=int(und.sum()))
        with span("serve.h2d", h, "h2d"):
            for j, rst in enumerate(resets):
                if rst.any():
                    self._host_resets[i][j].numpy()[:] = rst
            # per shard and hop: whether its streams had a reset (a shard
            # without one steps with no mask: the analyzers read a mask back
            # to the host)
            has_reset = [[bool(r[sh.lo : sh.hi].any()) for r in resets] for sh in self._shards]
            any_reset = [bool(r.any()) for r in resets]
            for sh, has in zip(self._shards, has_reset):
                copy = sh.copy_stream
                with sh.on(), torch.cuda.stream(copy) if copy is not None else contextlib.nullcontext():
                    if copy is not None and sh.consumed[i] is not None:
                        copy.wait_event(sh.consumed[i])  # the steps that read these blocks are done
                    for j, (staging, desc) in enumerate(self._gather_src[i]):
                        ring_gather(self._arena, staging, desc, sh.blocks[i][j], row0=sh.lo,
                                    mapped=sh.mapped and sh.mapped[i][j])
                        if has[j]:
                            sh.resets[i][j].copy_(self._host_resets[i][j][sh.lo : sh.hi], non_blocking=True)
                    if copy is not None:
                        sh.copied[i] = torch.cuda.Event()
                        sh.copied[i].record(copy)
                if copy is not None:
                    torch.cuda.current_stream(sh.device).wait_event(sh.copied[i])
        with span("serve.step", h, "step"):
            n0 = self._n_pending
            for sh, has in zip(self._shards, has_reset):
                with sh.on():
                    blocks = sh.blocks[i]
                    for j in range(k):
                        rst = sh.resets[i][j] if has[j] else None
                        # the batch's reset, not the shard's: the held
                        # spectrum's slide advances a host scalar every shard
                        # must share
                        sh.carry, snaps = self.engine.step(sh.carry, blocks[j], sh.meta, rst, any_reset[j])
                        if self._cadence > 1:
                            self._spectrum_block(sh, (n0 + j) % self._cadence, blocks[j], rst)
                    if sh.copy_stream is not None:
                        sh.consumed[i] = torch.cuda.Event()
                        sh.consumed[i].record(torch.cuda.current_stream(sh.device))
                    if self._cadence > 1:
                        snaps = dict(snaps, spectrum=sh.spectrum_snap)
                    leaves = _snapshot_leaves(snaps)
                    # only the small meter leaves are kept for fetch_meters_now
                    sh.meters = [leaf for (_, leaf), m in zip(leaves, self._picked) if m]
            if self._cadence > 1:
                self._n_pending = (n0 + k) % self._cadence
            fetch_now = cfg.fetch != "none" and (self.stats.hops // k) % max(cfg.fetch_every // k, 1) == 0
            if fetch_now:
                with span("serve.pack"):
                    packs = self._pack_shards()
                self._inflight.append((t0, packs, self._packed_layout, self._shard_dims))
        while len(self._inflight) > cfg.drain_depth:
            self._drain_one()

    def _spectrum_block(self, sh: _Shard, n: int, block: torch.Tensor, reset) -> None:
        """Gather engine block ``n`` of a shard's spectrum hop; step its
        spectrum on the R-th, with the per-block resets where the hop had
        any (blocks before a stream's reset are zeroed)."""
        sh.spec_blocks[n].copy_(block)
        if reset is not None:
            if not sh.spec_has_reset:
                sh.spec_resets.zero_()
                sh.spec_has_reset = True
            sh.spec_resets[n].copy_(reset)
        if n + 1 == self._cadence:
            sh.carry["spectrum"], sh.spectrum_snap = self.engine.spectrum_step(
                sh.carry["spectrum"], sh.spec_blocks, sh.meta,
                sh.spec_resets if sh.spec_has_reset else None,
            )
            sh.spec_has_reset = False

    def _pack_shards(self) -> list:
        """Each shard's meter leaves packed to a host vector on its device,
        with the copy's event: ``[(host, event)]``."""
        out = []
        for sh in self._shards:
            with sh.on():
                out.append(_pack(sh.meters))
        return out

    def _drain_one(self) -> None:
        if not self._inflight:
            return
        with span("serve.drain", self.host_seconds, "drain"):
            t0, packs, layout, shard_dims = self._inflight.pop(0)
            with span("serve.drain_wait"):
                for _, done in packs:
                    if done is not None:
                        done.synchronize()
            self.last_snapshot = _join_meters([host for host, _ in packs], layout, shard_dims)
            self._last_layout = layout
            self.latencies_ms.append((time.perf_counter() - t0) * 1e3)
            self._feed_histories()
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
        if self._shards[0].meters is None:
            return None
        packs = self._pack_shards()
        for _, done in packs:
            if done is not None:
                done.synchronize()
        self.last_snapshot = _join_meters([host for host, _ in packs], self._packed_layout, self._shard_dims)
        self._last_layout = self._packed_layout
        return self.last_meters()

    def _display_snapshot(self, name: str, make, stream: int | None, as_numpy: bool):
        """``make(shard)``'s snapshot of analyzer ``name``: of the shard
        that holds ``stream`` only, its rows (a leading axis of 1), or of
        every shard, joined on the host along each leaf's stream dim."""
        if stream is not None:
            sh = self._shards[stream // self._shards[0].n]
            with sh.on():
                snap = _rows(make(sh), stream - sh.lo)
        elif len(self._shards) == 1:
            snap = make(self._shards[0])
        else:
            parts = []
            for sh in self._shards:
                with sh.on():
                    parts.append(make(sh))
            snap = gather_snapshots(parts, self._snapshot_dims[name])
        return _to_numpy(snap) if as_numpy else snap

    def fetch_osc_traces(self, as_numpy: bool = True, stream: int | None = None):
        """The oscilloscope's capture windows read from the live carry (the
        display's clock, not the hop's); ``None`` without an oscilloscope.
        With ``stream``, only that stream's rows are copied (a leading axis
        of 1): what a display of one stream reads.  Over a mesh, all
        streams' windows come back on the host."""
        if "oscilloscope" not in self.engine.analyzers:
            return None
        return self._display_snapshot(
            "oscilloscope", lambda sh: self.engine.extract_oscilloscope(sh.carry), stream, as_numpy
        )

    def fetch_spectrum(self, as_numpy: bool = True, stream: int | None = None):
        """The newest spectrum snapshot at the display's clock: the one held
        from the last spectrum hop of a cadenced spectrum, else emitted from
        the live carry's averaging state (no transform); ``None`` without a
        spectrum.  ``stream`` as for :meth:`fetch_osc_traces`."""
        if "spectrum" not in self.engine.analyzers:
            return None

        def make(sh):
            snap = sh.spectrum_snap
            return snap if snap is not None else self.engine.analyzers["spectrum"].emit(sh.carry["spectrum"])

        return self._display_snapshot("spectrum", make, stream, as_numpy)

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
        """The serving counters since the start; the latency percentiles
        are over the last ``LATENCY_WINDOW`` drained fetches."""
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
            # the loudness step's CUDA graphs (the current engine's): replays,
            # eager steps, graphs recorded, rebinds
            "loudness_graphs": dict(self.engine.loudness_graphs.counts),
            # the assembled rows by how they reach the device: gathered from
            # one ring segment or two, staged on the host, or all zeros
            "ingest_rows": dict(zip(ROW_KINDS, map(int, self.transport.ingest_rows))),
        }

    def close(self) -> None:
        """Drain the fetches in flight, wait for the copy streams and
        unregister the ring arena: the server advances no more."""
        while self._inflight:
            self._drain_one()
        for sh in self._shards:
            if sh.copy_stream is not None:
                sh.copy_stream.synchronize()
        self.transport.unpin_arena()
        if self._pool:
            self._pool.shutdown()


class MultiRateMeterServer:
    """Serve streams of several sample rates at once: one
    :class:`MeterServer` a rate, its engine at :meth:`EngineConfig.at_rate`.
    Rate-scaled blocks hold equal wall time (256 at 48 kHz, 235 at 44.1 kHz),
    so one clock advances every bucket.  Producers reach a bucket through
    its ``transport``, or, given a ``socket_path``, connect over a Unix
    socket to a :class:`~openmeters_tpu_torch.ingest.runtime.SessionRuntime`
    that routes each by its announced rate and identity; each negotiated
    channel layout becomes its stream's fold and weight rows."""

    def __init__(self, config: ServeConfig, rates: tuple[float, ...] = (48_000.0,),
                 socket_path: str | None = None, mesh=None, device="cuda"):
        self.servers: dict[float, MeterServer] = {}
        for r in sorted(float(r) for r in rates):
            self.servers[r] = MeterServer(
                dataclasses.replace(config, engine=self._at_rate(config.engine or EngineConfig(), r)),
                mesh=mesh, device=device,
            )
        self.runtime = None
        if socket_path is not None:
            from openmeters_tpu_torch.ingest.runtime import SessionRuntime

            def on_layout(rate, slot, channels, positions):
                self.servers[rate].set_stream_layout(slot, channels, positions)

            self.runtime = SessionRuntime(
                {r: s.transport for r, s in self.servers.items()}, socket_path,
                max_channels=config.channels, on_layout=on_layout,
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
        if self.runtime is not None:
            self.runtime.shutdown()
        for s in self.servers.values():
            s.close()


def attach_settings_watcher(server: MeterServer, path: str, min_interval: float = 0.5):
    """Hot-reload a running server from its settings file.

    Rides the display-rate drain callback (``on_drain``, after any consumer
    already there): at most every ``min_interval`` seconds it stats the
    file, and on a change of mtime or size loads it (the lossy schema of
    :mod:`~openmeters_tpu_torch.persistence`) and stages it with
    :meth:`MeterServer.apply_settings_async`, so the old configuration
    serves while the new engine warms.  ``sample_rate`` and
    ``block_frames`` are pinned to the live server's (a bucket of
    :class:`MultiRateMeterServer` runs at :meth:`EngineConfig.at_rate`'s
    geometry), so a rate edit in the file is ignored; a file the server
    refuses is logged and the old configuration kept.  Returns the
    callback."""
    import logging
    import os

    from openmeters_tpu_torch.persistence import SettingsHandle

    log = logging.getLogger("openmeters_tpu_torch.serve")

    def _sig():
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)

    state = {"sig": _sig() if os.path.exists(path) else None, "next": 0.0}
    prev = server.on_drain

    def on_drain(s):
        if prev is not None:
            prev(s)
        now = time.monotonic()
        if now < state["next"] or s.reconfig_pending:
            return
        state["next"] = now + min_interval
        try:
            sig = _sig()
        except OSError:
            return  # mid-rename (the saver writes tmp + rename) or deleted
        if sig == state["sig"]:
            return
        state["sig"] = sig
        try:
            ecfg = s.engine.config
            cfg = dataclasses.replace(
                SettingsHandle.load_or_default(path),
                sample_rate=ecfg.sample_rate, block_frames=ecfg.block_frames,
            )
            s.apply_settings_async(cfg)
            log.info("settings change detected (%s): warming the new engine", path)
        except (ValueError, RuntimeError) as exc:
            log.warning("settings change rejected: %s", exc)

    server.on_drain = on_drain
    return on_drain


def ingest_benchmark(
    n_streams: int, duration_s: float = 3.0, block_frames: int = 256,
    channels: int = 2, sample_rate: float = 48_000.0, feeder_threads: int = 4,
    assembler_shards: int = 1, realtime: bool = False,
) -> dict:
    """Host-only ingest throughput: native feeders push flat out (with
    backpressure) while the descriptor pass drains, alternating two buffer
    sets as the serving loop does (each pass releases its set's space, as
    nothing gathers the rows); the C++ path's sustainable streams without
    any device work."""
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
    bufs = [tp.make_desc_buffers() for _ in range(2)]
    t0 = time.perf_counter()
    hops = 0
    frames_out = 0
    while time.perf_counter() - t0 < duration_s:
        _, _, live = tp.assemble_desc(bufs[hops % 2], hops % 2, pool=pool, shards=assembler_shards)
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
