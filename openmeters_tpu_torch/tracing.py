"""Logging, hop counters and device traces (port of ``tracing.py``).

Logging follows the reference's env-filter convention: ``OPENMETERS_LOG``
holds ``debug``, or ``openmeters_tpu_torch.engine=debug`` style
directives, read by :func:`init_tracing`.  :class:`EngineStats` counts the
serving loop's hops, resets and underruns; :func:`scope` times a block of
host code; :func:`device_trace` records a ``torch.profiler`` trace (host
and, where there is a card, device activity) of a block and writes it in
Chrome's trace format.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

ROOT = "openmeters_tpu_torch"


def init_tracing(default_level: str = "info") -> None:
    """Install the env-filtered log config; call once."""
    spec = os.environ.get("OPENMETERS_LOG", default_level)
    logging.basicConfig(
        format="%(asctime)s %(levelname).1s [%(name)s] %(message)s",
        datefmt="%H:%M:%S",
    )
    for directive in spec.split(","):
        directive = directive.strip()
        if not directive:
            continue
        if "=" in directive:
            target, _, level = directive.partition("=")
        else:
            target, level = ROOT, directive
        logging.getLogger(target).setLevel(level.upper())


@dataclasses.dataclass
class EngineStats:
    """Hop-rate counters: hops, resets, underruns, audio and wall time."""

    hops: int = 0
    resets: int = 0
    underruns: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0

    def record(self, n_streams: int, block_frames: int, sample_rate: float,
               resets: int = 0, underruns: int = 0, wall_dt: float = 0.0) -> None:
        self.hops += 1
        self.resets += int(resets)
        self.underruns += int(underruns)
        self.audio_seconds += n_streams * block_frames / sample_rate
        self.wall_seconds += wall_dt

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def log_summary(self, log: logging.Logger | None = None) -> None:
        (log or logging.getLogger(f"{ROOT}.engine")).info(
            "[engine] hops=%d resets=%d underruns=%d audio=%.1fs rt=%.1fx",
            self.hops, self.resets, self.underruns,
            self.audio_seconds, self.realtime_factor,
        )


@contextlib.contextmanager
def scope(log: logging.Logger, name: str, level: int = logging.DEBUG):
    """Timed structured scope: ``[name] ... done in X ms``."""
    t0 = time.perf_counter()
    log.log(level, "[%s] start", name)
    try:
        yield
    finally:
        log.log(level, "[%s] done in %.2f ms", name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def device_trace(out_dir: str | None = None):
    """Profile the block under ``torch.profiler`` and write its trace to
    ``out_dir`` (``trace-<pid>-<ns>.json``); yields the profiler, or
    ``None`` and traces nothing when ``out_dir`` is not given."""
    if not out_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
