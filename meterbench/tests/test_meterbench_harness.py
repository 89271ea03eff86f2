"""The harness's pieces on the CPU at S=4: a served run, its check, the
control, the faults the check must catch, the readers and the refusals of
the entry point.  The entry point itself never runs on the CPU."""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from meterbench import check, manifest, readings, served, trace as tracemod
from meterbench.tests._cpu_cell import run_small, small_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    torch.set_num_threads(2)
    return run_small(SEED, seconds=1.0, trace=True, trace_path=tmp_path_factory.mktemp("t") / "trace.json")


def judged(run_, precision=None):
    cell = small_cell()
    found = check.numbers(cell, run_, lambda k, n: served.samples(run_, k, n), precision)
    return found, check.verdict(found, cell.config["limits"])


def test_sound_run_is_correct(sound):
    assert sound.hops > 0 and sound.fetches > 0 and len(sound.latencies_ms) == sound.fetches
    assert sound.resets == sound.underruns == sound.pushes_refused == 0
    assert sound.final_hop > max(sound.drained_hops)
    assert sound.drained["['loudness'].momentary_lufs"].shape == (sound.fetches, 4)
    assert sound.final["['loudness'].rms_fast_db"].shape == (4, 2)
    found, ok = judged(sound)
    assert ok, found
    e2e = served.end_to_end(sound)
    assert set(e2e) == {"streams_realtime", "latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert all(v > 0 for v in e2e.values())


def test_control_is_not_correct(sound):
    found, ok = judged(sound, "tf32")
    assert not ok, found


def test_readers_on_the_sound_run(sound):
    tr = tracemod.load(sound.profile["path"], sound.profile["hops"])
    assert tr.window_s > 0 and tr.hops == 6
    ctx = readings.Context(small_cell(), 4, sound.hops, sound.fetches, sound.spans, tr)
    for m in small_cell().per_layer:
        value = manifest.metric_reader(m["name"]).read(ctx)
        if m["source"] == "device_trace":
            assert value is None  # no device activity on the CPU: nothing to read
        else:
            assert value is not None and value > 0, m["name"]


def test_readers_on_a_synthetic_trace():
    ctx_trace = tracemod.Trace(0.0, 1000.0, 10, [(0.0, 100.0, "k1"), (50.0, 300.0, "other"), (600.0, 700.0, "x")],
                               [(300.0, 600.0, "aten::copy_"), (0.0, 1000.0, "meterbench.advance")])
    assert ctx_trace.busy_s == pytest.approx(400e-6)
    assert ctx_trace.idle_gaps()[0] == ["aten::copy_", pytest.approx(300e-6)]
    assert ctx_trace.top_ops()[0] == ["other", pytest.approx(250e-6)]
    cell = manifest.cell("loudness.served")
    ctx = readings.Context(cell, 8192, 10, 2, {"assemble": 0.02, "h2d": 0.01, "step": 0.03, "drain": 0.004},
                           ctx_trace)
    read = {m["name"]: manifest.metric_reader(m["name"]).read(ctx) for m in cell.per_layer}
    assert read == {
        "ingest.assemble_ms": pytest.approx(2.0), "serve.issue_ms": pytest.approx(4.0),
        "serve.drain_ms": pytest.approx(2.0), "device.idle_share": pytest.approx(60.0),
    }


class _Stale:
    """A step that returns its state unchanged (and its first meters)."""

    def __init__(self, engine):
        self._engine, self._first = engine, None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self, carry, *args, **kw):
        if self._first is None:
            self._first = self._engine.step(carry, *args, **kw)
            return self._first
        return carry, self._first[1]


class _Half:
    """The second half of the batch left out: its streams step on silence."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self, carry, block, *args, **kw):
        block = block.clone()
        block[block.shape[0] // 2:] = 0.0
        return self._engine.step(carry, block, *args, **kw)


class _Altered:
    """An answer altered where it is produced: momentary loudness 0.05 LU
    high."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self, *args, **kw):
        carry, snaps = self._engine.step(*args, **kw)
        lo = snaps["loudness"]
        snaps = dict(snaps, loudness=lo._replace(momentary_lufs=lo.momentary_lufs + 0.05))
        return carry, snaps


@pytest.mark.parametrize("fault", [_Stale, _Half, _Altered], ids=["state_unchanged", "half_batch", "altered"])
def test_faults_are_not_correct(fault):
    torch.set_num_threads(2)
    run_ = run_small(SEED + 1, seconds=0.5, wrap_engine=fault)
    found, ok = judged(run_)
    assert not ok, found


def _run_cli(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "meterbench/run.py", "--workload", "loudness.served", "--seed", "1",
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env,
    )


def test_entry_point_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_cli(ROOT, env=env)
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr
    assert not proc.stdout.strip()


def test_entry_point_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "meterbench", tmp_path / "meterbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_stream_samples_are_what_the_producer_pushed(sound):
    """The producer's clips and offsets, read back through the reference's
    view, equal the pool's samples (the reference gets exactly them)."""
    x = served.samples(sound, 0, 1000)
    st = int(sound.sampled[0])
    clip, off = int(sound.clip_of[st]), int(sound.offset_of[st])
    n = sound.pool.shape[1]
    assert np.array_equal(x[:10], sound.pool[clip, [(off + i) % n for i in range(10)]])
