"""The share of its roofline that layer 'ns' reaches in the profiled
sweep: the least time of the Newton-Schulz preconditioner steps that the
sweep needed (roofline.ns_seconds, from the shapes and EnsembleStats)
over the device time of the kernels that layers/ns/*.json list. None
where none of them ran."""

from rmtbench import roofline


def read(ctx):
    t = ctx.trace.layer_seconds(ctx.layer_kernels("ns"))
    if t <= 0:
        return None
    work = roofline.ns_seconds(ctx.stats, ctx.config, ctx.opts)
    return 100.0 * work / t
