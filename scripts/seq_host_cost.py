#!/usr/bin/env python3
"""Host cost of the sequential path's pieces for one DME reactor.

    python3 scripts/seq_host_cost.py [--device cuda|cpu] [--reps 10]

For one reactor (B = 1) in float64 on --device (default: the CUDA card;
without one it exits nonzero): N1, and N2 at zNo 5 and 20, the
milliseconds of one dense Jacobian by forward mode
(stiff_ensemble.batched_jacobian, the lockstep integrator's default) and
by reverse mode (radau.reverse_jacobian, the sequential integrator's
default), the mean of --reps synchronised calls after one warm-up, and
the largest difference of the two over the largest entry; then the
PyTorch operations one attempt of rmtExe N2 at zNo 5 issues
(torch.profiler's aten:: events over a run of period 0.02, over its
attempts), and how many of them are multiplications. Prints one line
each and one JSON line.
"""

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jacobian_ms(torch, model, z_no, device, reps):
    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.models import homo
    from rmt_tpu_torch.solvers.radau import reverse_jacobian
    from rmt_tpu_torch.solvers.stiff_ensemble import batched_jacobian

    mi = make_model_input(model=model)
    spec = homo.build_spec(mi, z_no=z_no)
    p = homo.build_params(mi, dtype=torch.float64, device=device)
    d = homo.feed_state(spec, p)
    if model == "N1":
        rhs, y0 = homo.make_n1_rhs(spec), homo.n1_initial_state(spec, p, d)
    else:
        rhs, y0 = homo.make_n2_rhs(spec), homo.n2_initial_state(spec, p, d)
    t = torch.zeros(1, dtype=torch.float64, device=device)

    def f(tt, y):
        return rhs(tt[0], y[0], p, d)[None]

    out = {}
    for name, jac in (("forward", batched_jacobian),
                      ("reverse", reverse_jacobian)):
        J = jac(f, t, y0[None])
        sync(torch, device)
        t0 = time.perf_counter()
        for _ in range(reps):
            jac(f, t, y0[None])
        sync(torch, device)
        out[name] = ((time.perf_counter() - t0) / reps * 1e3, J)
    diff = float((out["forward"][1] - out["reverse"][1]).abs().max()
                 / out["forward"][1].abs().max())
    return dict(model=model, n=int(y0.shape[0]), forward_ms=out["forward"][0],
                reverse_ms=out["reverse"][0], max_rel_diff=diff)


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ops_per_attempt(torch, device):
    import rmt_tpu_torch
    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.models import homo

    build = homo.build_spec
    homo.build_spec = functools.partial(build, z_no=5)
    try:
        mi = make_model_input(model="N2", op_period=0.02)
        rmt_tpu_torch.rmtExe(mi, device=device)
        with torch.profiler.profile() as prof:
            res = rmt_tpu_torch.rmtExe(mi, device=device)
    finally:
        homo.build_spec = build
    st = res["resModel"]["solverStats"]
    att = st["n_accepted"] + st["n_rejected"]
    events = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    return dict(attempts=att,
                aten_ops_per_attempt=sum(e.count for e in events) / att,
                aten_mul_per_attempt=sum(e.count for e in events
                                         if e.key == "aten::mul") / att)


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from rmt_tpu_torch import config

    device = config.resolve_device(args.device)
    where = (torch.cuda.get_device_name(0) if device.type == "cuda"
             else "the CPU")
    rows = [jacobian_ms(torch, m, z, device, args.reps)
            for m, z in (("N1", 20), ("N2", 5), ("N2", 20))]
    for r in rows:
        print(f"{r['model']} n = {r['n']}: Jacobian forward mode "
              f"{r['forward_ms']:.2f} ms, reverse mode {r['reverse_ms']:.2f} "
              f"ms, max relative difference {r['max_rel_diff']:.2e}, on "
              f"{where}", flush=True)
    ops = ops_per_attempt(torch, device)
    print(f"rmtExe N2 zNo 5: {ops['aten_ops_per_attempt']:.0f} aten "
          f"operations an attempt ({ops['aten_mul_per_attempt']:.0f} "
          f"multiplications) over {ops['attempts']} attempts, on {where}",
          flush=True)
    print(json.dumps(dict(device=where, jacobians=rows, **ops)), flush=True)


if __name__ == "__main__":
    main()
