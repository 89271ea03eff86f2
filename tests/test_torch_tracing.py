"""PyTorch port, the host spans (``tracing.span``) of the serving loop,
the transport and the engine: under ``torch.profiler`` every span of the
tree in ``tracing.py`` is a range, nested as stated; with no profiler
running none is, and ``MeterServer.host_seconds`` still counts its four
stretches."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from openmeters_tpu_torch.analyzers.loudness import LoudnessConfig  # noqa: E402
from openmeters_tpu_torch.engine import EngineConfig  # noqa: E402
from openmeters_tpu_torch.serve import MeterServer, ServeConfig  # noqa: E402
from openmeters_tpu_torch.tracing import span  # noqa: E402

S, B, HOPS, FETCH_EVERY = 4, 256, 12, 6
OFF = dict(spectrogram=None, spectrum=None, oscilloscope=None, stereometer=None, waveform=None)
# span -> the span it opens in
PARENT = {
    "serve.assemble": "serve.hop",
    "serve.copy_wait": "serve.assemble",
    "ingest.assemble": "serve.assemble",
    "serve.h2d": "serve.hop",
    "serve.step": "serve.hop",
    "engine.step": "serve.step",
    "analyzers.loudness": "engine.step",
    "serve.pack": "serve.step",
    "serve.drain": "serve.hop",
    "serve.drain_wait": "serve.drain",
}


def fed_server(hops: int) -> MeterServer:
    """S=4 loudness alone on the CPU, ``hops`` blocks pushed to each stream."""
    cfg = ServeConfig(n_streams=S, engine=EngineConfig(channels=2, loudness=LoudnessConfig(), **OFF),
                      realtime=False, fetch="meters", fetch_every=FETCH_EVERY, coalesce_blocks=1)
    server = MeterServer(cfg, device="cpu")
    rng = np.random.default_rng(7)
    for st in range(S):
        pcm = (0.1 * rng.standard_normal((hops * B, 2))).astype(np.float32)
        server.transport.push_pcm(st, pcm, 0)
    return server


def traced_spans(tmp_path) -> list:
    """``[(start, end, name)]`` µs of the program's spans over ``HOPS``
    advances under the profiler, by start."""
    server = fed_server(HOPS)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(HOPS):
                server.advance()
        assert server.stats.hops == HOPS
    finally:
        server.close()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = set(PARENT) | {"serve.hop"}
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") in names)


def inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_spans_nest_as_the_tree_states(tmp_path):
    spans = traced_spans(tmp_path)
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp[2], []).append(sp)
    assert set(by_name) == set(PARENT) | {"serve.hop"}
    hops = by_name["serve.hop"]
    assert len(hops) == HOPS
    for name in ("serve.assemble", "serve.copy_wait", "ingest.assemble", "serve.h2d", "serve.step",
                 "engine.step", "analyzers.loudness"):
        assert len(by_name[name]) == HOPS, name  # one a hop: one engine.step, one assembled batch
    for sp in spans:
        if sp[2] == "serve.hop":
            continue
        parents = [p for p in by_name[PARENT[sp[2]]] if inside(sp, p)]
        assert len(parents) == 1, sp
    # the fetch hops alone pack and drain: every FETCH_EVERY-th
    fetch_hops = [k for k, hop in enumerate(hops) if any(inside(sp, hop) for sp in by_name["serve.pack"])]
    assert fetch_hops == [k for k in range(HOPS) if (k + 1) % FETCH_EVERY == 0]
    for name in ("serve.drain", "serve.drain_wait"):
        assert [k for k, hop in enumerate(hops) if any(inside(sp, hop) for sp in by_name[name])] == fetch_hops
    # the children's time never exceeds the parent's
    for parent in spans:
        children = [sp for sp in spans if sp is not parent and PARENT.get(sp[2]) == parent[2] and inside(sp, parent)]
        assert sum(e - s for s, e, _ in children) <= parent[1] - parent[0], parent


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("serve.hop"):
            pass
    assert entered == ["serve.hop"]  # the patch sees the helper's ranges
    entered.clear()

    server = fed_server(2 * FETCH_EVERY)
    try:
        before = []
        for _ in range(2):
            before.append(dict(server.host_seconds))
            for _ in range(FETCH_EVERY):
                server.advance()
        after = dict(server.host_seconds)
    finally:
        server.close()
    assert entered == []
    assert set(after) == {"assemble", "h2d", "step", "drain"}
    for earlier in before:
        assert all(after[k] > earlier[k] for k in after), (earlier, after)
