"""The share of its roofline that layer 'block_solve' reaches in the
profiled sweep: the least time of the exact block-bidiagonal stage and
error solves that the sweep needed (roofline.block_solve_seconds, from
the shapes and EnsembleStats) over the device time of the kernels that
layers/block_solve/*.json list. None where none of them ran."""

from rmtbench import roofline


def read(ctx):
    t = ctx.trace.layer_seconds(ctx.layer_kernels("block_solve"))
    if t <= 0:
        return None
    work = roofline.block_solve_seconds(ctx.stats, ctx.config, ctx.opts)
    return 100.0 * work / t
