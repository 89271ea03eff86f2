"""``analyzers.loudness_ms``: host milliseconds a hop issuing the loudness
analyzer's step: the program's ``analyzers.loudness`` spans in the
profiled stretch over its hops."""

SPAN = "analyzers.loudness"


def _clipped(tr, name):
    return [min(e, tr.end) - max(s, tr.start) for s, e, n in tr.host if n == name and e > tr.start and s < tr.end]


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us = _clipped(tr, SPAN)
    return sum(us) / tr.hops * 1e-3 if us else None
