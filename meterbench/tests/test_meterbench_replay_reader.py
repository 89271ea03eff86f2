"""The reader of ``analyzers.loudness_replay_share`` on synthetic traces:
replay spans in none, some and all of the profiled hops' loudness steps,
spans outside the stretch left out, and nothing read from a program
without the replay route."""

from __future__ import annotations

import pytest

from meterbench import manifest, readings, trace as tracemod

NAME = "analyzers.loudness_replay_share"


def _trace(replayed: list[bool]):
    """One ``analyzers.loudness`` span a hop, 100 µs apart in a 1000 µs
    stretch, holding a replay or an eager span; and one of each outside."""
    host = [(-50.0, -40.0, "analyzers.loudness"), (-48.0, -42.0, "analyzers.loudness.replay"),
            (1100.0, 1110.0, "analyzers.loudness"), (1102.0, 1108.0, "analyzers.loudness.eager")]
    for i, r in enumerate(replayed):
        t = 100.0 * i + 10.0
        host += [(t, t + 40.0, "analyzers.loudness"),
                 (t + 5.0, t + 35.0, "analyzers.loudness.replay" if r else "analyzers.loudness.eager")]
    return tracemod.Trace(0.0, 1000.0, len(replayed), [(0.0, 500.0, "k")], host)


def _read(tr):
    cell = manifest.cell("loudness.served")
    ctx = readings.Context(cell, 8192, 10, 2, {"assemble": 0.0, "h2d": 0.0, "step": 0.0, "drain": 0.0}, tr)
    return manifest.metric_reader(NAME).read(ctx)


@pytest.mark.parametrize("replayed,share", [([False] * 10, 0.0), ([True, False] * 5, 50.0),
                                            ([True] * 3 + [False] * 7, 30.0), ([True] * 10, 100.0)])
def test_replay_share_on_a_synthetic_trace(replayed, share):
    assert _read(_trace(replayed)) == pytest.approx(share)


def test_replay_share_reads_nothing_without_the_route():
    """The loudness spans without replay or eager spans inside (a program
    before the graphs), or no loudness spans at all: nothing."""
    bare = tracemod.Trace(0.0, 1000.0, 10, [(0.0, 500.0, "k")],
                          [(100.0 * i, 100.0 * i + 40.0, "analyzers.loudness") for i in range(10)])
    assert _read(bare) is None
    assert _read(tracemod.Trace(0.0, 1000.0, 10, [], [])) is None


def test_replay_share_is_in_the_manifest():
    (entry,) = [m for m in manifest.load_manifest()["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_span", "layer": "analyzers",
                     "moves": "streams_realtime", "workloads": ["loudness.served"]}
