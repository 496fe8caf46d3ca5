"""The share of its roofline that layer 'rhs' reaches in the profiled
sweep: the least time of the RHS evaluations (stage residuals, the new
state's derivative) that the sweep needed (roofline.rhs_seconds, from the
shapes and EnsembleStats) over the device time of the kernels that
layers/rhs/*.json list. None where none of them ran."""

from rmtbench import roofline


def read(ctx):
    t = ctx.trace.layer_seconds(ctx.layer_kernels("rhs"))
    if t <= 0:
        return None
    work = roofline.rhs_seconds(ctx.stats, ctx.config, ctx.opts)
    return 100.0 * work / t
