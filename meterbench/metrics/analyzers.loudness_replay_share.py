"""``analyzers.loudness_replay_share``: the share of the profiled stretch's
loudness steps replayed from a CUDA graph: its ``analyzers.loudness.replay``
spans over its ``analyzers.loudness`` spans, x100.  A program that opens
neither a replay nor an eager span (``analyzers.loudness.eager``) has no
such route, and reads nothing."""

STEP, REPLAY, EAGER = "analyzers.loudness", "analyzers.loudness.replay", "analyzers.loudness.eager"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    count = dict.fromkeys((STEP, REPLAY, EAGER), 0)
    for s, e, n in tr.host:
        if n in count and e > tr.start and s < tr.end:
            count[n] += 1
    if not count[STEP] or not (count[REPLAY] or count[EAGER]):
        return None
    return count[REPLAY] / count[STEP] * 100.0
