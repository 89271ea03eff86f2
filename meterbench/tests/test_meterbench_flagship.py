"""The ``flagship.served`` cell on the CPU at S=4: a served run passes its
check; the control (the reference at TF32) and two planted faults in the
spectrogram (its first columns served again, every code off by one more
than the limit) are refused; and the cell's two readers on synthetic
traces."""

from __future__ import annotations

import time

import pytest
import torch

from meterbench import check, manifest, readings, roofline, served, trace as tracemod
from meterbench.roofline_classic import classic_columns_cost
from meterbench.tests._cpu_cell import small_cell

CELL = "flagship.served"
SEED = 2**31 + 5119


def run_small(seed: int, seconds: float, wrap_engine=None):
    return served.run(small_cell(CELL), seed, seconds, False, "cpu", time.perf_counter(), wrap_engine=wrap_engine)


def judged(run_, precision=None):
    cell = small_cell(CELL)
    found = check.numbers(cell, run_, lambda k, n: served.samples(run_, k, n), precision)
    return found, check.verdict(found, cell.config["limits"])


@pytest.fixture(scope="module")
def sound():
    torch.set_num_threads(2)
    return run_small(SEED, 1.0)


def test_sound_run_is_correct(sound):
    assert sound.hops > 0 and sound.fetches > 0
    assert sound.final["['spectrogram'].codes"].shape == (4, 4, 1025)
    found, ok = judged(sound)
    assert ok, found
    assert "spectrogram_code_gap" in found


def test_control_is_not_correct(sound):
    found, ok = judged(sound, "tf32")
    assert not ok, found
    assert found["spectrogram_code_gap"] > small_cell(CELL).config["limits"]["spectrogram_code_gap"]


class _StaleColumns:
    """The spectrogram's first columns served on every later hop."""

    def __init__(self, engine):
        self._engine, self._first = engine, None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self, *args, **kw):
        carry, snaps = self._engine.step(*args, **kw)
        if self._first is None and bool(snaps["spectrogram"].valid.all()):
            self._first = snaps["spectrogram"].codes.clone()
        if self._first is not None:
            snaps = dict(snaps, spectrogram=snaps["spectrogram"]._replace(codes=self._first))
        return carry, snaps


class _OffByMore:
    """Every code one more than the limit above the program's."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self, *args, **kw):
        carry, snaps = self._engine.step(*args, **kw)
        step = small_cell(CELL).config["limits"]["spectrogram_code_gap"] + 1
        sg = snaps["spectrogram"]
        codes = (sg.codes.to(torch.int32) + step).clamp_max(65535).to(torch.uint16)
        return carry, dict(snaps, spectrogram=sg._replace(codes=codes))


@pytest.mark.parametrize("fault", [_StaleColumns, _OffByMore], ids=["stale_columns", "off_by_more"])
def test_spectrogram_faults_are_not_correct(fault):
    torch.set_num_threads(2)
    run_ = run_small(SEED + 1, 0.5, wrap_engine=fault)
    found, ok = judged(run_)
    assert not ok, found
    assert found["spectrogram_code_gap"] > small_cell(CELL).config["limits"]["spectrogram_code_gap"]


def _read(host, device, n_streams=8192):
    cell = manifest.cell(CELL)
    ctx = readings.Context(cell, n_streams, 10, 2, {"assemble": 0.0, "h2d": 0.0, "step": 0.0, "drain": 0.0},
                           tracemod.Trace(0.0, 1000.0, 10, device, host))
    return {name: manifest.metric_reader(name).read(ctx)
            for name in ("analyzers.spectrogram_ms", "kernel.classic_columns_roofline")}


KERNEL = "void (anonymous namespace)::classic_columns_kernel((anonymous namespace)::Params)"


def test_readers_on_a_synthetic_trace():
    """Spectrogram spans clipped to the stretch over its hops; the kernel's
    least time at S=8192 over the mean of its launches."""
    host = [(100.0, 300.0, "analyzers.spectrogram"), (950.0, 1050.0, "analyzers.spectrogram"),
            (1200.0, 1300.0, "analyzers.spectrogram"), (0.0, 1000.0, "meterbench.advance")]
    device = [(10.0, 110.0, KERNEL), (500.0, 700.0, KERNEL), (200.0, 260.0, "other_kernel")]
    got = _read(host, device)
    least = roofline.least_ms(*classic_columns_cost(8192, 2048, 64, 256))
    assert got["analyzers.spectrogram_ms"] == pytest.approx(0.025)
    assert got["kernel.classic_columns_roofline"] == pytest.approx(least / 0.15 * 100.0)
    assert 0.0 < got["kernel.classic_columns_roofline"] < 100.0


def test_readers_read_nothing_without_the_spans_or_the_kernel():
    """A program without the kernel (it slides the columns) or the span
    leaves each metric out of the line."""
    got = _read([(0.0, 1000.0, "meterbench.advance")], [(0.0, 100.0, "sliding_hop_deltas_kernel")])
    assert got == {"analyzers.spectrogram_ms": None, "kernel.classic_columns_roofline": None}


def test_the_kernels_counts():
    """At the flagship shape: each stream's 2240 ring samples in, 4 x 1025
    codes out, the window and the normalization; four 1024-point
    transforms a stream."""
    moved, ops = classic_columns_cost(8192, 2048, 64, 256)
    assert moved == 8192 * 2240 * 4 + 8192 * 4 * 1025 * 2 + 2048 * 4 + 1025 * 4
    assert ops == 5.0 * 1024 * 10 * 8192 * 4
