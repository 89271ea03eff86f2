"""``serve.issue_ms``: host milliseconds a hop issuing the copies to the
card and the engine step: the window's change of
``MeterServer.host_seconds["h2d"]`` plus ``host_seconds["step"]`` over the
hops stepped in it."""


def read(ctx):
    if not ctx.hops or "step" not in ctx.spans:
        return None
    return (ctx.spans["h2d"] + ctx.spans["step"]) / ctx.hops * 1e3
