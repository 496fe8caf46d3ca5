"""The most step attempts of any member of the profiled sweep
(EnsembleStats n_accepted + n_rejected): the lockstep runs as long as its
slowest member."""


def read(ctx):
    att = ctx.stats["n_accepted"] + ctx.stats["n_rejected"]
    return int(att.max()) if len(att) else None
