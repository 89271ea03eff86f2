"""``serve.drain_ms``: host milliseconds a fetch waiting for and joining
the meters on the host: the window's change of
``MeterServer.host_seconds["drain"]`` over the fetches drained in it."""


def read(ctx):
    if not ctx.fetches or "drain" not in ctx.spans:
        return None
    return ctx.spans["drain"] / ctx.fetches * 1e3
