"""``serve.pack_ms``: host milliseconds a fetch packing the meter leaves
for the host (one ``torch.cat``, the copy to a pinned vector, its event):
the program's ``serve.pack`` spans in the profiled stretch over the
``serve.drain`` spans in it."""

SPAN, PER = "serve.pack", "serve.drain"


def _clipped(tr, name):
    return [min(e, tr.end) - max(s, tr.start) for s, e, n in tr.host if n == name and e > tr.start and s < tr.end]


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us, fetches = _clipped(tr, SPAN), _clipped(tr, PER)
    return sum(us) / len(fetches) * 1e-3 if us and fetches else None
