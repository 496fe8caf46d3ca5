#!/usr/bin/env python3
"""The port's adjoint-gradient estimation step on one CUDA card (BASELINE
config #5): one SGD step over the log kinetic constants K1-K3, forward
the IFT-differentiable fixed-step Radau
(rmt_tpu_torch.solvers.implicit_diff.radau_fixed_batched) over the real
0.5 s DME period, backward its implicit-function-theorem adjoints.

    python3 scripts/bench_torch_estimation.py [B ...] [--z-no Z] [--n-steps S]

The configuration is scripts/bench_estimation.py's: the DME case, N2,
period 0.5 s, zNo 8 (n = 56), tNo 1, 12 fixed steps, T0 = 523 +
linspace(-4, 4, B), theta_0 the constants at 523 K, uniform target mole
fractions, lr 1e-3, integrator "radau". It stays in float64 (the JAX
bench forces float32 only because a TPU has no float64). B defaults to
512 and 4096; --z-no 20 --n-steps 64 is N2's production grid (n = 140, a
420 x 420 stage system).

For each B: a first step (CUDA and cuSOLVER set-up included), a warm step
(its wall and members/s, forward and adjoint), the loss, the peak device
memory of the warm step, and an instrumented step whose Jacobians, LU
factorisations and solves, residual evaluations and backward pass are
each closed by a device synchronisation (the split). Prints the card's
name and power limit and one JSON line per B. Exits nonzero without a
CUDA card or when the loss or a gradient is not finite.
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PERIOD = 0.5
Z_NO = 8
N_STEPS = 12
LR = 1e-3
T_BASE, T_HALF = 523.0, 4.0
RT = 8.314472 * 523.0
# the log kinetic constants at 523 K (scripts/bench_estimation.py:37-42)
THETA0 = {
    "K1": math.log(35.45 * math.exp(-1.7069e4 / RT)),
    "K2": math.log(7.3976 * math.exp(-2.0436e4 / RT)),
    "K3": math.log(8.2894e4 * math.exp(-5.2940e4 / RT)),
}


def inlet_temperatures(b):
    return T_BASE + np.linspace(-T_HALF, T_HALF, b)


def build(b, device, z_no=Z_NO, n_steps=N_STEPS):
    """(step, theta0 {name: 0-d tensor}, params, spec) of the estimation
    step at b members (T0 = inlet_temperatures(b)) on device, in
    float64."""
    import torch

    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.models import homo
    from rmt_tpu_torch.parallel import batch_params, make_estimation_step

    mi = make_model_input(model="N2", op_period=PERIOD)
    spec = homo.build_spec(mi, z_no=z_no, t_no=1)
    base = homo.build_params(mi, dtype=torch.float64, device=device)
    params, axes = batch_params(base, {"T0": inlet_temperatures(b)})
    target = np.full((b, spec.n_comp), 1.0 / spec.n_comp)
    step = make_estimation_step(spec, axes, target, n_steps=n_steps, lr=LR,
                                integrator="radau", device=device)
    theta0 = {k: torch.tensor(v, dtype=torch.float64, device=device)
              for k, v in THETA0.items()}
    return step, theta0, params, spec


def finite(loss, grads):
    return math.isfinite(float(loss)) and all(
        math.isfinite(float(g)) for g in grads.values())


def run(torch, b, device, z_no, n_steps):
    """The first, warm and instrumented steps at b members."""
    step, theta0, params, spec = build(b, device, z_no, n_steps)

    def call(timings=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step.value_and_grad(theta0, params, timings=timings)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    first, _ = call()
    torch.cuda.reset_peak_memory_stats()
    warm, (loss, grads, _) = call()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = {}
    split_wall, _ = call(split)
    ok = finite(loss, grads)
    return dict(
        part="estimation step", B=b, z_no=z_no,
        n=spec.var_no_n2 * spec.z_no, n_steps=n_steps, first_s=first,
        warm_s=warm, members_per_sec=b / warm, loss=float(loss),
        grads={k: float(v) for k, v in grads.items()}, peak_gib=peak,
        split_wall_s=split_wall, split_s={k: split[k] for k in sorted(split)},
        finite=ok, ok=ok)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_estimation: no CUDA device; this "
                         "script measures the card")
    ap = argparse.ArgumentParser()
    ap.add_argument("b", type=int, nargs="*", default=[512, 4096])
    ap.add_argument("--z-no", type=int, default=Z_NO)
    ap.add_argument("--n-steps", type=int, default=N_STEPS)
    args = ap.parse_args()
    sys.path[:0] = [ROOT]
    import rmt_tpu_torch  # noqa: F401 (its import turns TF32 off: header)
    from chip_smoke import header

    card = header(torch)
    device = torch.device("cuda:0")
    parts = []
    for b in args.b:
        r = run(torch, b, device, args.z_no, args.n_steps)
        r.update(card=card, device=torch.cuda.get_device_name(0))
        print(" ".join(f"{k}={v}" for k, v in r.items()), flush=True)
        print(json.dumps(r), flush=True)
        parts.append(r)
    if not all(r["ok"] for r in parts):
        raise SystemExit("bench_torch_estimation: FAILED (a non-finite loss "
                         "or gradient)")


if __name__ == "__main__":
    main()
