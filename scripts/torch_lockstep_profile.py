#!/usr/bin/env python3
"""Where the time of the port's lockstep sweeps goes, on one CUDA card.

    python3 scripts/torch_lockstep_profile.py [--leg f32x|f32|n1] [--b B]
        [--z-no Z]

Runs one of chip_smoke.py's sweeps at B members (default its 4096):
bench.py's f32x leg (the default) or its f32 leg, through
rmt_tpu_torch.parallel.run_n2_ensemble_lockstep, or the N1 sweep of
scripts/bench_torch_n1.py (dense output, the default Jacobian), and
prints (--z-no: the N2 legs on a grid of Z axial nodes, through
chip_smoke.z_no_of; Z = 30 with --leg f32 --b 256 is chip_smoke's
f32_wide leg, whose n = 210 takes ns_fused_step's wide route):
  - the wall of a first run (CUDA set-up and kernel builds) and of two
    warm runs, with the integrator's attempts and Jacobian refreshes, and
    the second warm run's kernel launch counts and peak device memory;
  - a warm run with the Jacobian evaluation (the blocks for f32x, the
    dense matrix for f32 and n1) timed on its own (the card synchronised
    around each call);
  - a torch.profiler window of two chunks (16 attempts, two refreshes):
    its wall, the device time of every kernel in it, the busy share and
    the number of kernel launches, then the kernels by device time, and
    each of the port's own kernels with its calls and device time a
    call.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", choices=("f32x", "f32", "n1"), default="f32x")
    ap.add_argument("--b", type=int, default=None,
                    help="members (default: chip_smoke.py's B)")
    ap.add_argument("--z-no", type=int, default=None,
                    help="axial nodes of the N2 grid (default: HomoSpec's)")
    args = ap.parse_args()
    if args.z_no is not None and args.leg == "n1":
        raise SystemExit("torch_lockstep_profile: --z-no sets the N2 grid")
    leg = args.leg

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_lockstep_profile: no CUDA device")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import bench_torch_n1
    import chip_smoke
    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.models import homo
    from rmt_tpu_torch.ops import _build, cuda_block, cuda_ns, cuda_rhs
    from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep
    from rmt_tpu_torch.solvers import stiff_ensemble

    dev = torch.device("cuda:0")
    card = chip_smoke.header(torch)
    B = args.b or chip_smoke.B
    if args.z_no is not None:
        # every N2 spec of this process gets the grid (the process ends
        # with the patch in place)
        chip_smoke.z_no_of(homo, args.z_no).__enter__()
        print(f"grid: zNo {args.z_no}", flush=True)
    if leg == "n1":
        mi = make_model_input(model="N1")
        offs = bench_torch_n1.probe_layout(B)[0]
        opts = bench_torch_n1.OPTS
    else:
        mi = make_model_input(model="N2")
        sweep = {"T0": 523.0 + np.linspace(-5.0, 5.0, B)}
        opts = chip_smoke.F32X if leg == "f32x" else chip_smoke.F32
    jac_arg = "jac_blocks" if leg == "f32x" else "jac"
    counts = (cuda_block.LAUNCHES, cuda_rhs.LAUNCHES, cuda_ns.LAUNCHES)

    def integrate(**over):
        if leg == "n1":
            return bench_torch_n1.run(mi, offs, dev, **over)
        return run_n2_ensemble_lockstep(mi, sweep, device=dev,
                                        **dict(opts, **over))

    def run(label, **over):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, stats = integrate(**over)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        att = (stats.n_accepted + stats.n_rejected).cpu().numpy()
        print(f"{label} ({leg}): B {B}, wall {wall:.3f} s, members/s "
              f"{B / wall:.1f}, refreshes {stats.n_jev - 1}, rescues "
              f"{stats.n_rescue}, attempts mean {att.mean():.1f} max "
              f"{int(att.max())}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB",
              flush=True)
        return wall

    run("first run")
    run("warm run 1")
    for table in counts:
        for k in table:
            table[k] = 0
    run("warm run 2")
    print("warm run 2: launches " + ", ".join(
        f"{k} {v}" for table in counts for k, v in table.items()), flush=True)

    # the Jacobian evaluation alone: wrap the callable the entry point
    # hands to the integrator (n1: the integrator's default Jacobian)
    odeint = stiff_ensemble.odeint_ensemble
    default_jac = stiff_ensemble.batched_jacobian
    spent = {"s": 0.0, "n": 0}

    def timed(jac):
        def jac_timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = jac(*a)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["n"] += 1
            return out
        return jac_timed

    def timed_odeint(f, y0, ts, **kw):
        return odeint(f, y0, ts, **{jac_arg: timed(kw.pop(jac_arg))}, **kw)

    if leg == "n1":
        stiff_ensemble.batched_jacobian = timed(default_jac)
    else:
        stiff_ensemble.odeint_ensemble = timed_odeint
    try:
        wall = run("split run")
    finally:
        stiff_ensemble.odeint_ensemble = odeint
        stiff_ensemble.batched_jacobian = default_jac
    print(f"split run: {jac_arg} {spent['s']:.3f} s of {wall:.3f} s over "
          f"{spent['n']} calls ({spent['s'] / spent['n'] * 1e3:.1f} ms "
          f"each)", flush=True)

    # a profiled window of two chunks (j_every = 8 attempts each)
    window = dict(max_steps=2 * opts["j_every"])
    run("window warm-up", **window)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run("profiled window", **window)
    ka = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == cuda) / 1e3
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    print(f"profiled window: device time {dev_ms:.2f} ms in {wall:.3f} s "
          f"wall (busy share {dev_ms / 1e3 / wall:.4f}), kernel launches "
          f"{launches}", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=15,
                   max_name_column_width=50))
    for e in sorted(ka, key=lambda e: -e.self_device_time_total):
        if e.device_type == cuda and any(k in e.key for k in _build._KERNELS):
            print(f"port kernel {e.key[:60]}: {e.count} calls, "
                  f"{e.self_device_time_total / e.count:.3f} us a call",
                  flush=True)
    print(card)


if __name__ == "__main__":
    main()
