"""``device.idle_share``: the share of the profiled stretch in which no
kernel, copy or memset ran on the card: one less the union of the device
activity intervals over the stretch's wall time."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
