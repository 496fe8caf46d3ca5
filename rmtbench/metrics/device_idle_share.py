"""The share of the profiled sweep's wall in which no operation ran on
the device: 1 - (union of the device's intervals) / (the sweep's wall)."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
