"""Kernel launches an attempt of the lockstep: the kernels the device ran
in the profiled sweep over the attempts the lockstep ran for every member
(its chunks, n_jev - 1, times j_every). Counted from the device's kernel
events, so a launch replayed from a CUDA graph still counts."""


def read(ctx):
    attempts = (ctx.stats["n_jev"] - 1) * int(ctx.opts["j_every"])
    if not ctx.trace.kernels or attempts <= 0:
        return None
    return len(ctx.trace.kernels) / attempts
