#!/usr/bin/env python3
"""The port's N2 DME ensemble benchmark on one CUDA card: the PyTorch twin
of bench.py (which stays the JAX package's benchmark).

    python3 scripts/bench_torch_n2.py [--microbatch K] [--legs NAME ...]
                                      [--b-f32x B]

Runs bench.py's legs (bench.py:80-101) through
rmt_tpu_torch.parallel.run_n2_ensemble_lockstep; by default these three,
in this order:
  f32x  the qualifying leg: df32 kinetics, exact block-bidiagonal stage
        solves, cheap_sweeps 2, j_every 8, newton_iters 5, rtol 6e-7,
        atol 1e-9, max_steps 768, at b_total 131072 members in one call,
        recording only the 64 probe rows (out_members); with
        --microbatch K the same members in slices of K (the slices' full
        trajectories are recorded, since out_members and microbatch
        exclude each other);
  ch4   the CH4 second-chemistry guard: the f32x options on the CH4 case
        at its 16 probe temperatures (B = 16); its errors join the f32x
        leg as ch4_max_rel_err / ch4_mean_rel_err;
  f32   plain float32 with Newton-Schulz preconditioners, rtol 1e-5,
        atol 1e-7, j_every 8, newton_iters 5, max_steps 768, at B = 4096.
Legs that run only when named with --legs (with the default legs named
as f32x, ch4, f32; --b-f32x sets the f32x leg's members):
  f64     bench.py's opt-in float64 leg (bench.py:99-100): dtype float64,
          Newton-Schulz preconditioners (float32, from the float64
          colored Jacobian), rtol 1e-7, atol 1e-10, newton_iters 6,
          max_steps 768, at B = 4096, with --microbatch K in slices of K
          (bench.py's f64 chunk is 256);
  true    the f32x options with accurate_rates=True (the kinetics chain
          in float64 inside a float32 RHS), B = 4096;
  full    the f32x options with accurate_rates="full" (the whole RHS and
          its Jacobian in float64), B = 4096;
  f32_am  the f32 leg with the DSL's accurate-f32 switch on
          (kinetics/dsl.accurate_f32_math: the RHS kernel's accurate-math
          variant), B = 4096;
  batched_df32  the f32x options on the member-last df32 RHS
          (batched_rhs=True, which takes no cheap sweeps), at the 64
          probes alone (B = 64): its eager df32 chain takes about a
          minute a call.
bench.py's walk-down to smaller B after a crash is left out: an
out-of-memory error is a failure here.

The sweep is T0 = base + linspace(-5, 5, B) with the probe offsets of
bench_ref.npz (read only) spliced in at evenly spaced members, as
bench.py:_probe_layout does. Each leg is called twice: the first call
(CUDA set-up and kernel builds included) is untimed, the second, the
same call, is timed on the host clock around a synchronised call.

Prints one JSON line per leg with bench.py's fields (B, members_per_sec,
vs_baseline, attempts_mean / attempts_max, max_rel_err, mean_rel_err,
acc_B; ch4_max_rel_err, ch4_mean_rel_err on f32x) and peak_gib
(torch.cuda.max_memory_allocated over the leg's two calls), the first
call's seconds, the card's name and power limit; then one line with all
legs. vs_baseline divides by baseline_seconds 78.411, the SciPy time of
one reference PyREMOT N2 run committed in BENCH_r05.json: it was not
measured on this host. Exits nonzero when a leg fails: a member that
does not finish, a state that is not finite, an error over its bar
(f32x, CH4, f64 and true 1e-6, full 3e-6, f32 and f32_am 5e-5,
chip_smoke.py's bars; batched_df32 1.9473e-6, BATCHED_DF32_BAR) or an out-of-memory error. Without a CUDA card it exits nonzero.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (F32, F32X, F64, FULL_BAR, header,  # noqa: E402
                        probe_layout)

REF_NPZ = os.path.join(ROOT, "bench_ref.npz")
BASELINE_SECONDS = 78.411
BASELINE = ("committed SciPy time (BENCH_r05.json), not measured on this "
            "host")
B_F32X = 131072          # bench.py's LEGS["f32x"]["b_total"]
B_F32 = 4096             # bench.py's B
CH4_ACC_B = 16
# rmt_tpu's own run of the 64 probes errs by 9.7364e-07 with the
# member-last df32 RHS at the f32x options (CPU,
# scripts/jax_n2_modes_error.py batched_df32); as for "full"
# (chip_smoke.FULL_BAR), the port's run is held to twice that
BATCHED_DF32_BAR = 2 * 9.7364e-07
BARS = {"f32x": 1e-6, "ch4": 1e-6, "f32": 5e-5, "f64": 1e-6, "true": 1e-6,
        "full": FULL_BAR, "f32_am": 5e-5, "batched_df32": BATCHED_DF32_BAR}
DEFAULT_LEGS = ("f32x", "ch4", "f32")


class LegFailed(Exception):
    pass


def leg(torch, name, chem, b, opts, device, microbatch=None,
        accurate_math=False):
    """Integrate one leg on the card twice (first call untimed) and
    return its record; raises LegFailed when a check fails.
    accurate_math sets the DSL's accurate-f32 switch for the leg."""
    from rmt_tpu_torch.cases import ch4_case, dme_case
    from rmt_tpu_torch.kinetics.dsl import accurate_f32_math
    from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep

    case = {"dme": dme_case, "ch4": ch4_case}[chem]
    with np.load(REF_NPZ) as z:
        offsets, ref_ys, t_base = (z[f"{chem}_offsets"], z[f"{chem}_ys"],
                                   float(z[f"{chem}_t_base"]))
    sweep, idx = probe_layout(np, b, offsets)
    mi = case.make_model_input(model="N2")

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with accurate_f32_math(accurate_math):
            if microbatch and microbatch < b:
                ys, stats = run_n2_ensemble_lockstep(
                    mi, {"T0": t_base + sweep}, microbatch=microbatch,
                    device=device, **opts)
                ys_sel, y_fin = ys[:, idx], ys[-1]
            else:
                ys_sel, y_fin, stats = run_n2_ensemble_lockstep(
                    mi, {"T0": t_base + sweep}, out_members=idx,
                    device=device, **opts)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, ys_sel, y_fin, stats

    torch.cuda.reset_peak_memory_stats()
    t_first, *_ = call()
    t_ens, ys_sel, y_fin, stats = call()
    n_seg = ys_sel.shape[0] - 1
    unfinished = int(torch.sum(stats.seg < n_seg))
    att = (stats.n_accepted + stats.n_rejected).cpu().numpy()
    mps = b / t_ens
    rec = dict(
        leg=name, B=b, members_per_sec=mps,
        vs_baseline=mps * BASELINE_SECONDS,
        baseline_seconds=BASELINE_SECONDS, baseline=BASELINE,
        rtol=opts["rtol"], atol=opts["atol"],
        attempts_mean=float(att.mean()), attempts_max=int(att.max()),
        unfinished=unfinished, seconds=t_ens, first_call_s=t_first,
        jacobian_refreshes=int(stats.n_jev) - 1,
        cold_rescues=int(stats.n_rescue), microbatch=microbatch,
        accurate_math=accurate_math,
        config={k: (v if isinstance(v, (bool, int, float, str)) else str(v))
                for k, v in opts.items() if k not in ("rtol", "atol")},
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    got = ys_sel.double().cpu().numpy()
    rel = np.abs(got - ref_ys) / np.maximum(np.abs(ref_ys), 1e-7)
    rec.update(max_rel_err=float(rel.max()), mean_rel_err=float(rel.mean()),
               acc_B=int(idx.size))
    if unfinished:
        raise LegFailed(f"{name}: {unfinished}/{b} members exhausted the "
                        "budget")
    if not bool(torch.isfinite(y_fin).all()):
        raise LegFailed(f"{name}: non-finite final states")
    if rec["max_rel_err"] > BARS[name]:
        raise LegFailed(f"{name}: max_rel_err {rec['max_rel_err']} > "
                        f"{BARS[name]:g}")
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--microbatch", type=int, default=None,
                    help="integrate the f32x (or f64) leg K members at a "
                    "time")
    ap.add_argument("--legs", nargs="+", default=list(DEFAULT_LEGS),
                    choices=("f32x", "ch4", "f32", "f64", "true", "full",
                             "f32_am", "batched_df32"),
                    help="the legs to run, in this order")
    ap.add_argument("--b-f32x", type=int, default=B_F32X,
                    help="the f32x leg's members (bench.py: 131072)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_n2: no CUDA device; this script "
                         "measures the card")
    import rmt_tpu_torch  # noqa: F401 (its import turns TF32 off: header)

    device = torch.device("cuda:0")
    name = header(torch)
    known = {
        "f32x": ("dme", args.b_f32x, F32X, args.microbatch, False),
        "ch4": ("ch4", CH4_ACC_B, F32X, None, False),
        "f32": ("dme", B_F32, F32, None, False),
        "f64": ("dme", B_F32, dict(F64, dtype=torch.float64),
                args.microbatch, False),
        "true": ("dme", B_F32, dict(F32X, accurate_rates=True), None, False),
        "full": ("dme", B_F32, dict(F32X, accurate_rates="full"), None,
                 False),
        "f32_am": ("dme", B_F32, F32, None, True),
        "batched_df32": ("dme", 64, dict(F32X, batched_rhs=True,
                                         cheap_sweeps=0), None, False),
    }
    legs, failed = {}, []
    for leg_name in args.legs:
        chem, b, opts, mb, am = known[leg_name]
        try:
            rec = leg(torch, leg_name, chem, b, opts, device, mb, am)
        except (LegFailed, torch.cuda.OutOfMemoryError) as e:
            traceback.print_exc()
            failed.append(f"{leg_name}: {type(e).__name__}: {e}")
            torch.cuda.empty_cache()
            continue
        rec.update(card=name, device=torch.cuda.get_device_name(0))
        print(json.dumps(rec), flush=True)
        legs[leg_name] = rec
    if "f32x" in legs and "ch4" in legs:
        legs["f32x"]["ch4_max_rel_err"] = legs["ch4"]["max_rel_err"]
        legs["f32x"]["ch4_mean_rel_err"] = legs["ch4"]["mean_rel_err"]
    head = legs.get("f32x", {})
    print(json.dumps({
        "metric": "n2_dme_ensemble_members_per_sec",
        "value": head.get("members_per_sec"), "unit": "reactors/s",
        "vs_baseline": head.get("vs_baseline"),
        "baseline_seconds": BASELINE_SECONDS, "baseline": BASELINE,
        "legs": legs, "failed": failed, "card": name}), flush=True)
    if failed:
        raise SystemExit("bench_torch_n2: FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
