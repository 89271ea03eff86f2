"""The readers of the program's own spans (``ingest.assemble``,
``serve.copy_wait``, ``engine.step``, ``analyzers.loudness``,
``serve.pack``, ``serve.drain_wait``): their clipping to the profiled
stretch and their divisors on a synthetic trace, nothing where a program
lacks the spans, and a reading over 0 on a served run on the CPU."""

from __future__ import annotations

import pytest
import torch

from meterbench import manifest, readings, trace as tracemod
from meterbench.tests._cpu_cell import run_small, small_cell

SEED = 2**31 + 4317
SPAN_METRICS = ("ingest.assemble_call_ms", "serve.copy_wait_ms", "engine.step_ms", "analyzers.loudness_ms",
                "serve.pack_ms", "serve.drain_wait_ms")
DEVICE = [(0.0, 100.0, "k1"), (50.0, 300.0, "other"), (600.0, 700.0, "x")]
HARNESS = [(300.0, 600.0, "aten::copy_"), (0.0, 1000.0, "meterbench.advance")]
# the program's spans, two of them past the stretch's ends and one outside it
PROGRAM = [(100.0, 700.0, "serve.hop"), (300.0, 400.0, "ingest.assemble"), (950.0, 1100.0, "ingest.assemble"),
           (-50.0, 20.0, "serve.copy_wait"), (700.0, 730.0, "serve.copy_wait"), (100.0, 300.0, "engine.step"),
           (1200.0, 1300.0, "engine.step"), (150.0, 250.0, "analyzers.loudness"), (310.0, 330.0, "serve.pack"),
           (800.0, 840.0, "serve.pack"), (500.0, 520.0, "serve.drain"), (900.0, 960.0, "serve.drain"),
           (505.0, 515.0, "serve.drain_wait"), (905.0, 925.0, "serve.drain_wait")]


def _read(host):
    cell = manifest.cell("loudness.served")
    ctx = readings.Context(cell, 8192, 10, 2, {"assemble": 0.02, "h2d": 0.01, "step": 0.03, "drain": 0.004},
                           tracemod.Trace(0.0, 1000.0, 10, DEVICE, host))
    return {m["name"]: manifest.metric_reader(m["name"]).read(ctx) for m in cell.per_layer}


def test_span_readers_on_a_synthetic_trace():
    assert _read(HARNESS + PROGRAM) == {
        "ingest.assemble_ms": pytest.approx(2.0), "serve.issue_ms": pytest.approx(4.0),
        "serve.drain_ms": pytest.approx(2.0), "device.idle_share": pytest.approx(60.0),
        "ingest.assemble_call_ms": pytest.approx(0.015), "serve.copy_wait_ms": pytest.approx(0.005),
        "engine.step_ms": pytest.approx(0.02), "analyzers.loudness_ms": pytest.approx(0.01),
        "serve.pack_ms": pytest.approx(0.03), "serve.drain_wait_ms": pytest.approx(0.015),
    }


def test_span_readers_read_nothing_without_the_spans():
    """A program without the spans (the harness's own ranges only) leaves
    each of these metrics out of the line instead of failing."""
    read = _read(HARNESS)
    assert {k: read[k] for k in SPAN_METRICS} == dict.fromkeys(SPAN_METRICS)
    assert read["serve.issue_ms"] == pytest.approx(4.0)


def test_span_readers_on_a_served_run(tmp_path):
    torch.set_num_threads(2)
    run_ = run_small(SEED, seconds=1.0, trace=True, trace_path=tmp_path / "trace.json")
    tr = tracemod.load(run_.profile["path"], run_.profile["hops"])
    ctx = readings.Context(small_cell(), 4, run_.hops, run_.fetches, run_.spans, tr)
    read = {name: manifest.metric_reader(name).read(ctx) for name in SPAN_METRICS}
    assert all(v is not None and v > 0 for v in read.values()), read
