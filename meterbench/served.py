"""The ``served`` traffic: ``MeterServer.advance()`` back to back, fed by
the benchmark's producer flat out under backpressure (a closed loop against
the ring: the server sets the pace).

One run: the pool and the streams' sources from the seed; the server; the
producer, which fills every stream's ring before the first hop; warm-up
advances; then the window, ``advance()`` until ``seconds`` have passed and
a device synchronise after the last, so the window holds all the work it
issued.  A fetched hop's latency runs from the start of the ``advance()``
that steps it to the benchmark's ``on_drain`` holding its meters.  After
the window, one more ``advance()`` keeps every snapshot leaf of its hop
(``capture``): the bulk leaves that a meter fetch leaves on the card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from meterbench import manifest, pool as poolmod, stats
from meterbench.producer import Producer

SPANS = ("assemble", "h2d", "step", "drain")


@dataclasses.dataclass
class ServedRun:
    n_streams: int
    hop_s: float  # seconds of audio a hop
    setup_s: float
    window_s: float
    hops: int  # stepped in the window
    fetches: int  # drained in the window
    latencies_ms: list
    spans: dict  # host seconds in the window, by MeterServer.host_seconds key
    resets: int
    underruns: int
    pushes_refused: int
    memory_peak_bytes: int
    sampled: np.ndarray  # the checked streams
    clip_of: np.ndarray
    offset_of: np.ndarray
    pool: np.ndarray
    drained_hops: list  # hop index of each drained fetch in the window
    drained: dict  # meter leaf -> [fetches, k, ...] of the sampled streams
    final_hop: int
    final: dict  # snapshot leaf -> [k, ...] of the capture hop
    profile: dict | None  # trace file and hops of the profiled stretch


class _Capture:
    """The engine with its last step's snapshots kept."""

    def __init__(self, engine):
        self._engine = engine
        self.snaps = None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self, *args, **kw):
        carry, snaps = self._engine.step(*args, **kw)
        self.snaps = snaps
        return carry, snaps


def _rows(tree, idx) -> dict:
    """``{leaf path: rows idx on the host}`` of a snapshot tree."""
    import torch.utils._pytree as pytree

    ordered = {name: tree[name] for name in sorted(tree)}
    out = {}
    for path, leaf in pytree.tree_flatten_with_path(ordered)[0]:
        out[pytree.keystr(path)] = leaf.cpu()[idx].numpy()  # CUDA indexes no uint16
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, started: float,
        trace_path=None, wrap_engine=None) -> ServedRun:
    """One run of a served cell.  ``started`` is the process's start on
    ``time.perf_counter``'s clock; ``wrap_engine`` (tests) wraps the
    server's engine before the first hop."""
    from openmeters_tpu_torch.serve import MeterServer, ServeConfig

    t = cell.traffic
    s = int(t["n_streams"])
    ecfg = manifest.engine_config(cell.config["engine"])
    serve_cfg = ServeConfig(
        n_streams=s, channels=int(t["channels"]), engine=ecfg, realtime=False,
        fetch=t["fetch"], fetch_every=int(t["fetch_every"]), coalesce_blocks=int(t["coalesce_blocks"]),
    )
    pool_cfg = t["pool"]
    pool = poolmod.make_pool(seed, int(pool_cfg["clips"]), float(pool_cfg["clip_seconds"]), device)
    clip_of, offset_of = poolmod.stream_sources(seed, s, pool.shape[0], pool.shape[1])
    sampled = poolmod.sample_streams(seed, s, int(t["sample_streams"]))
    idx = torch.as_tensor(sampled)

    server = MeterServer(serve_cfg, device=device)
    if wrap_engine is not None:
        server.engine = wrap_engine(server.engine)
    prod = t["producer"]
    producer = None
    try:
        producer = Producer(server.transport, pool, clip_of, offset_of, int(prod["frames_per_push"]),
                            int(prod["max_buffered_frames"]), int(prod["threads"]), ecfg.sample_rate)
        deadline = time.perf_counter() + 120.0
        while producer.min_buffered() < int(prod["prefill_frames"]):
            if time.perf_counter() > deadline:
                raise RuntimeError(f"the producer filled {producer.min_buffered()} frames in 120 s")
            time.sleep(0.01)

        state = {"start": 0.0, "window": False}
        latencies, drained_hops, drained = [], [], []

        def on_drain(srv):
            if not state["window"]:
                srv.last_meters()
                return
            latencies.append((time.perf_counter() - state["start"]) * 1e3)
            drained_hops.append(srv.stats.hops - 1)  # drain_depth 0: this advance's hop
            drained.append({k: v[sampled] for k, v in srv.last_meters().items() if v.shape[:1] == (s,)})

        server.on_drain = on_drain
        for _ in range(int(t["warmup_hops"])):
            state["start"] = time.perf_counter()
            server.advance()
        _sync(device)

        hops0, spans0 = server.stats.hops, dict(server.host_seconds)
        resets0, under0 = server.stats.resets, server.stats.underruns
        profile = None
        prof_at = seconds / 2  # the profiled stretch starts halfway
        state["window"] = True
        t_start = time.perf_counter()
        setup_s = t_start - started
        end = t_start + seconds
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if trace and profile is None and now - t_start >= prof_at:
                profile = _profile(server, state, int(t["profile_hops"]), device, trace_path)
                continue
            state["start"] = now
            server.advance()
        _sync(device)
        window_s = time.perf_counter() - t_start
        state["window"] = False
        hops = server.stats.hops - hops0
        spans = {k: server.host_seconds[k] - spans0[k] for k in SPANS}
        resets, underruns = server.stats.resets - resets0, server.stats.underruns - under0
        fetches = len(latencies)
        if profile is not None:
            profile.pop("profiler").export_chrome_trace(profile["path"])

        # the capture hop, after the window and its counts
        real = server.engine
        cap = _Capture(real)
        server.engine = cap
        try:
            server.advance()
        finally:
            server.engine = real
        _sync(device)
        final_hop = server.stats.hops - 1
        final = _rows(cap.snaps, idx) if cap.snaps else {}
        _, refused = producer.stop()
        peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    finally:
        if producer is not None:
            producer.close()
        server.close()
    del server
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    keys = drained[0].keys() if drained else []
    return ServedRun(
        n_streams=s, hop_s=ecfg.block_frames / ecfg.sample_rate, setup_s=setup_s, window_s=window_s,
        hops=hops, fetches=fetches, latencies_ms=latencies, spans=spans, resets=resets, underruns=underruns,
        pushes_refused=refused, memory_peak_bytes=int(peak), sampled=sampled, clip_of=clip_of,
        offset_of=offset_of, pool=pool, drained_hops=drained_hops,
        drained={k: np.stack([d[k] for d in drained]) for k in keys},
        final_hop=final_hop, final=final, profile=profile,
    )



def _profile(server, state, n_hops: int, device, trace_path) -> dict:
    """``n_hops`` advances under ``torch.profiler``, between two device
    synchronises, in one span ``meterbench.profiled``.  The trace is
    written to ``trace_path`` after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    prof = profile(activities=acts)
    prof.start()
    with record_function("meterbench.profiled"):
        for _ in range(n_hops):
            state["start"] = time.perf_counter()
            with record_function("meterbench.advance"):
                server.advance()
        _sync(device)
    prof.stop()
    return {"profiler": prof, "path": str(trace_path), "hops": n_hops}


def end_to_end(run_: ServedRun) -> dict:
    """The served cell's end-to-end metrics: all the work over all the
    window, and the latency of every fetched hop."""
    return {
        "streams_realtime": run_.hops * run_.n_streams * run_.hop_s / run_.window_s,
        "latency_p50_ms": stats.percentile(run_.latencies_ms, 50),
        "latency_p95_ms": stats.percentile(run_.latencies_ms, 95),
        "setup_s": run_.setup_s,
    }


def samples(run_: ServedRun, k: int, frames: int) -> np.ndarray:
    """``[frames, 2]`` float32: what the producer pushed to the ``k``-th
    sampled stream."""
    st = int(run_.sampled[k])
    return poolmod.stream_samples(run_.pool, run_.clip_of[st], run_.offset_of[st], frames)

