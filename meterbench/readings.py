"""What a per-layer reader (``metrics/<name>.py``) is given: the window's
counts and host spans, the profiled stretch's trace, and the cell.

A reader's ``read(ctx)`` returns the metric's value, or ``None`` where it
finds nothing to read; the harness then leaves the metric out."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Context:
    cell: object  # manifest.Cell
    n_streams: int
    hops: int  # stepped in the window
    fetches: int  # drained in the window
    spans: dict  # host seconds in the window, by the program's span name
    trace: object | None  # trace.Trace of the profiled stretch
