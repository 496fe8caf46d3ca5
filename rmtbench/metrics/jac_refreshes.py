"""Jacobian evaluations of the profiled sweep (EnsembleStats n_jev: the
one at the start and one a chunk)."""


def read(ctx):
    return int(ctx.stats["n_jev"])
