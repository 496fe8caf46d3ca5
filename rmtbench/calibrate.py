#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process on the
card: one sweep of the timed call on each seed, its sample held to the
reference, for the program as the cell runs it and, with --control, for
the cell's control (the "control" of limits/<cell>.json: lockstep
options laid over the mix's, or TF32 switched on).

    python3 rmtbench/calibrate.py --workload <name> --seeds S [S ...]
                                  [--control]

Prints one JSON line a seed: the seed, max_rel_err and the members it
covers, members that did not finish, states that are not finite, the
sweep's seconds, and its attempts and rejections by cause (rej_conv:
Newton did not converge). The benchmark's own runs do not run this.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from rmtbench import run as entry

    entry.pin_caches()
    from rmtbench import harness, traffic

    import torch

    cell = harness.load_cell(args.workload, ROOT)
    control = (cell.limits or {}).get("control", {}) if args.control else {}
    over = control.get("options")
    run = harness.Run(cell, args.seeds[0], "cuda:0", over)
    harness.set_tf32(bool(control.get("tf32")))
    t0 = time.perf_counter()
    run.warm_up()
    print(json.dumps(dict(warm_up_s=time.perf_counter() - t0)), flush=True)
    for seed in args.seeds:
        run.seed = seed
        run.sweeps = traffic.Sweeps(seed, cell.mix, cell.config)
        t0 = time.perf_counter()
        run.window(0.0)
        sweep_s = time.perf_counter() - t0
        err, n = run.compare()
        print(json.dumps(dict(
            workload=args.workload, control=args.control, seed=seed,
            max_rel_err=err, members=n, unfinished=run.unfinished,
            nonfinite=run.nonfinite, sweep_s=sweep_s, **run.counts,
            tf32=torch.backends.cuda.matmul.allow_tf32)), flush=True)


if __name__ == "__main__":
    main()
