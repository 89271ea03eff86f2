"""Logging, hop counters and host spans (port of ``tracing.py``).

Logging follows the reference's env-filter convention: ``OPENMETERS_LOG``
holds ``debug``, or ``openmeters_tpu_torch.engine=debug`` style
directives, read by :func:`init_tracing`.  :class:`EngineStats` counts the
serving loop's hops, resets and underruns.  :class:`span` names a stretch
of host code: under a running ``torch.profiler`` it is a range on the
profiler's clock, beside the device activity it launched, and it can add
its seconds to a counter such as ``MeterServer.host_seconds``.

The spans the program opens (the serving loop's, the transport's and the
engine's), each inside the one above it:

- ``serve.hop``: one hop of ``MeterServer.advance``;
  - ``serve.assemble``: ``host_seconds["assemble"]``;
    - ``serve.copy_wait``: the wait for the last gather out of the buffer
      set;
    - ``ingest.assemble``: one ``Transport.assemble_desc`` (the native
      descriptor pass);
  - ``serve.h2d``: ``host_seconds["h2d"]``, the gathers onto the device;
  - ``serve.step``: ``host_seconds["step"]``;
    - ``engine.step``: one ``MeterEngine.step`` (its own time is the fold);
      - ``analyzers.<name>``: each analyzer stepped (``analyzers.spectrum``
        also in ``MeterEngine.spectrum_step``);
        - ``analyzers.loudness.replay``: the loudness step replayed from a
          CUDA graph (``analyzers.loudness.eager``: stepped eagerly, off a
          card);
    - ``serve.pack``: the meter leaves packed for a fetch;
  - ``serve.drain``: ``host_seconds["drain"]``, a fetch drained (also
    outside ``serve.hop`` where ``run()``, ``close()`` or a
    reconfiguration drains);
    - ``serve.drain_wait``: the wait for the fetch's copy (the rest is the
      join and the view histories).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

import torch

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


_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter
_NOTHING = contextlib.nullcontext()


def span(name: str, into: dict | None = None, key: str | None = None):
    """``with span(name):`` a stretch of host code.  A profiler range
    (``torch.profiler.record_function``) only while a profiler runs, so a
    span costs a check when none does; with ``into``, the stretch's
    seconds are added to ``into[key]``."""
    if _profiler_enabled():
        return _Span(name, into, key)
    return _NOTHING if into is None else _Timer(into, key)


class _Timer:
    """A span's seconds added to ``into[key]``, with no profiler running."""

    __slots__ = ("_into", "_key", "_t0")

    def __init__(self, into: dict, key: str):
        self._into, self._key = into, key

    def __enter__(self):
        self._t0 = _clock()
        return self

    def __exit__(self, typ, value, tb):
        self._into[self._key] += _clock() - self._t0


class _Span:
    """A span under a running profiler: a range, and with ``into`` its
    seconds."""

    __slots__ = ("_name", "_into", "_key", "_range", "_t0")

    def __init__(self, name: str, into: dict | None, key: str | None):
        self._name, self._into, self._key = name, into, key

    def __enter__(self):
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, typ, value, tb):
        if self._into is not None:
            self._into[self._key] += _clock() - self._t0
        self._range.__exit__(typ, value, tb)
