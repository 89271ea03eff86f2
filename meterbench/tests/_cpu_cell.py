"""A served cell cut to run on the CPU in a test: four streams, two short
clips, a short warm-up."""

from __future__ import annotations

import dataclasses
import time

from meterbench import manifest


def small_cell(name: str = "loudness.served") -> manifest.Cell:
    cell = manifest.cell(name)
    t = cell.traffic
    traffic = dict(t, n_streams=4, pool={"clips": 2, "clip_seconds": 3.0}, warmup_hops=30, sample_streams=4,
                   producer=dict(t["producer"], threads=1, prefill_frames=20000), profile_hops=6)
    return dataclasses.replace(cell, traffic=traffic)


def run_small(seed: int, seconds: float = 1.0, trace: bool = False, trace_path=None, wrap_engine=None):
    from meterbench import served

    return served.run(small_cell(), seed, seconds, trace, "cpu", time.perf_counter(),
                      trace_path=trace_path, wrap_engine=wrap_engine)
