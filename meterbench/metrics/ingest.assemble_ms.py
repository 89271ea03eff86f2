"""``ingest.assemble_ms``: host milliseconds a hop in batch assembly (the
C++ assembler behind ``Transport.assemble``): the window's change of
``MeterServer.host_seconds["assemble"]`` over the hops stepped in it."""


def read(ctx):
    if not ctx.hops or "assemble" not in ctx.spans:
        return None
    return ctx.spans["assemble"] / ctx.hops * 1e3
