"""``ingest.assemble_call_ms``: host milliseconds a hop in
``Transport.assemble`` (the C++ assembler and its ctypes call): the
program's ``ingest.assemble`` spans in the profiled stretch over its hops."""

SPAN = "ingest.assemble"


def _clipped(tr, name):
    return [min(e, tr.end) - max(s, tr.start) for s, e, n in tr.host if n == name and e > tr.start and s < tr.end]


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us = _clipped(tr, SPAN)
    return sum(us) / tr.hops * 1e-3 if us else None
