#!/usr/bin/env python3
"""The float32 libm's accuracy on one CUDA card, over the kinetics DSL's
argument ranges: the measurement behind the default of the port's
accurate-f32 switch (RMT_TORCH_ACCURATE_F32, kinetics/dsl.py).

    python3 scripts/libm_f32_error.py [--points N]

For torch.exp, torch.log, torch.log10 and torch.pow on float32 tensors
of the card, and for rmt_tpu_torch.ops.accurate_math's versions of them,
prints the largest relative error against float64 on the card evaluated
at the same (float32-rounded) arguments, so the error of representing an
argument in float32 is not counted:

  exp   x in [-30, 30] (the Arrhenius and equilibrium exponents);
  log   x in [1e-30, 1e30] and [0.9, 1.1] (absolute error where |log x| <
        0.25, as tests/test_accurate_math.py measures it);
  log10 x in [1e-10, 1e10], the same way;
  pow   x in [1e-3, 50] bar (partial pressures) with y in [-3, 3], x**y
        at |y ln x| <= 30 (x in [1e-6, 1e6], y in [-4, 4]), and 10**z for
        z = 3066/T - 10.92, T in [450, 700] K.

rmt_tpu turns its switch on by default because a TPU's float32 libm is
accurate to about 1e-5; the targets of the accurate versions are 5e-7
(exp, log) and 1e-6 (pow). Prints one JSON line with every error and
the card's name and power limit; exits nonzero without a card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=2_000_001,
                    help="points of each one-dimensional range")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("libm_f32_error: no CUDA device; this script "
                         "measures the card")
    from rmt_tpu_torch.ops import accurate_math as am

    dev = torch.device("cuda:0")
    f32, f64 = torch.float32, torch.float64
    n = args.points

    def rel(got, x64, want_fn, floor=None):
        want = want_fn(x64)
        d = (got.to(f64) - want).abs()
        den = want.abs() if floor is None else want.abs().clamp(min=floor)
        ok = torch.isfinite(want)
        return float((d / den)[ok].max())

    def grid(lo, hi, log=False):
        g = (torch.logspace(lo, hi, n, dtype=f64, device=dev) if log
             else torch.linspace(lo, hi, n, dtype=f64, device=dev))
        x = g.to(f32)
        return x, x.to(f64)

    out = {}
    x, x64 = grid(-30.0, 30.0)
    out["exp"] = {"native": rel(torch.exp(x), x64, torch.exp),
                  "accurate": rel(am.exp(x), x64, torch.exp)}
    x, x64 = grid(-30.0, 30.0, log=True)
    xc, xc64 = grid(0.9, 1.1)
    x, x64 = torch.cat([x, xc]), torch.cat([x64, xc64])
    out["log"] = {"native": rel(torch.log(x), x64, torch.log, 0.25),
                  "accurate": rel(am.log(x), x64, torch.log, 0.25)}
    x, x64 = grid(-10.0, 10.0, log=True)
    out["log10"] = {"native": rel(torch.log10(x), x64, torch.log10, 0.25),
                    "accurate": rel(am.log10(x), x64, torch.log10, 0.25)}

    m = int(n ** 0.5)
    pw = {}
    for label, (xs, ys) in {
        "partial_pressures": (
            torch.logspace(-3.0, 1.7, m, dtype=f64, device=dev),
            torch.linspace(-3.0, 3.0, m, dtype=f64, device=dev)),
        "abs_y_ln_x_le_30": (
            torch.logspace(-6.0, 6.0, m, dtype=f64, device=dev),
            torch.linspace(-4.0, 4.0, m, dtype=f64, device=dev)),
    }.items():
        X, Y = torch.meshgrid(xs.to(f32), ys.to(f32), indexing="ij")
        keep = (Y.to(f64) * torch.log(X.to(f64))).abs() <= 30.0
        X, Y = X[keep], Y[keep]
        X64, Y64 = X.to(f64), Y.to(f64)
        pw[label] = {
            "native": rel(torch.pow(X, Y), (X64, Y64),
                          lambda a: torch.pow(*a)),
            "accurate": rel(am.pow(X, Y), (X64, Y64),
                            lambda a: torch.pow(*a))}
    T = torch.linspace(450.0, 700.0, n, dtype=f64, device=dev)
    z = (3066.0 / T - 10.92).to(f32)
    pw["ten_to_z"] = {
        "native": rel(torch.pow(10.0, z), z.to(f64),
                      lambda a: torch.pow(10.0, a)),
        "accurate": rel(am.pow(10, z), z.to(f64),
                        lambda a: torch.pow(10.0, a))}
    out["pow"] = pw
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out.update(card=smi, device=torch.cuda.get_device_name(0),
               torch=torch.__version__, cuda=torch.version.cuda,
               points=n)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
