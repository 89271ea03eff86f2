"""``serve.drain_wait_ms``: host milliseconds a fetch waiting for its
meters' copy to the host (the drain less the join and the view
histories): the program's ``serve.drain_wait`` spans in the profiled
stretch over the ``serve.drain`` spans in it."""

SPAN, PER = "serve.drain_wait", "serve.drain"


def _clipped(tr, name):
    return [min(e, tr.end) - max(s, tr.start) for s, e, n in tr.host if n == name and e > tr.start and s < tr.end]


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us, fetches = _clipped(tr, SPAN), _clipped(tr, PER)
    return sum(us) / len(fetches) * 1e-3 if us and fetches else None
