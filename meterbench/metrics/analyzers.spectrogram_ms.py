"""``analyzers.spectrogram_ms``: host milliseconds a hop issuing the
spectrogram analyzer's step: the program's ``analyzers.spectrogram`` spans
in the profiled stretch over its hops."""

SPAN = "analyzers.spectrogram"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us = [min(e, tr.end) - max(s, tr.start) for s, e, n in tr.host if n == SPAN and e > tr.start and s < tr.end]
    return sum(us) / tr.hops * 1e-3 if us else None
