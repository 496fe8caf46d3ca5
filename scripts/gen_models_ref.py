#!/usr/bin/env python3
"""Regenerate models_ref.npz: rmt_tpu's rmtExe on the CPU in float64 for
every model but N1, N2 and M9, rmt_tpu's M14 design sweep and its
lockstep M13 sweep, the oracle that chip_smoke.py holds rmt_tpu_torch to
on the card.

    python3 scripts/gen_models_ref.py [--out models_ref.npz]

Inputs: rmt_tpu_torch/cases/pb_case.py and hetero_case.py (the inputs of
rmt_tpu's own tests of these models). For M0, M1, M3, M4, M7 and M8, and
for T1, T2 (by FDM, OC and OCFE: t2, t2_oc, t2_fem), T3, M5 and M14 at
their default grids, the file holds the result's XYList rows (<key>_xy,
(rows, points)) and, where the result has one, dataYs (<key>_data_ys);
for T1 (period 5 s) also the final state (t1_state) and the integrator's
accepted and rejected attempts (t1_attempts); for M2 at its default grid
(zNo 100, tNo 10) dataPacktime (m2_packtime, (7, 10, 100)), the final
state (m2_state) and the attempts (m2_attempts); run_m14_sweep at zNo 30
over the inlet temperatures of scripts/bench_torch_seq.M14_SWEEP_T0
(m14_sweep_t0 (3,), m14_sweep_states (3, 7, 2, 30)). For the dynamic
heterogeneous M10 (zNo 10, tNo 2, period 0.02 s), M11 and M13 (default
grids) and M12 (zNo 10, tNo 2, period 4e-3 s, from the physical startup
state) -- scripts/bench_torch_seq.dyn_input -- every dataPack row stacked
over the intervals (<key>_dataYCon, _dataYTemp, _dataYs, _dataYCons,
_dataYTemps), the checkpoint (<key>_state; M13: m13_gas, m13_solid) and,
for M10-M12, the Radau attempts (<key>_attempts); rmt_tpu's lockstep M13
sweep (zNo 10, rNo 7, tNo 5) at the inlet temperatures of
bench_torch_seq.M13_SWEEP_T0 (m13_sweep_t0 (3,), m13_sweep_gas (3, 5, 7,
10), m13_sweep_solid (3, 5, 7, 7, 10), and its solid Newton's flags
m13_sweep_converged (3,)). M9 is not in the file: rmt_tpu's
M9 run exhausts its attempt budget. About 6 minutes.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEADY = ("M0", "M1", "M3", "M4", "M7", "M8")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "models_ref.npz"))
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["RMT_TPU_X64"] = "1"
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from rmt_tpu import rmtExe
    from rmt_tpu.parallel import run_m14_sweep
    from rmt_tpu_torch.cases import hetero_case
    from rmt_tpu_torch.cases.pb_case import model_input

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from bench_torch_seq import (DYN_MODELS, HETERO_MODELS, M13_SWEEP_T0,
                                 M14_SWEEP_T0, dyn_input, dyn_pack,
                                 hetero_input, ref_key)
    from rmt_tpu.parallel import run_m13_sweep

    out = {}
    for model in (*STEADY, "M2"):
        t0 = time.perf_counter()
        res = rmtExe(model_input(model))["resModel"]
        key = model.lower()
        if model == "M2":
            st = res["solverStats"]
            out["m2_packtime"] = np.asarray(res["dataPacktime"])
            out["m2_state"] = np.asarray(res["checkpoint"]["state"])
            out["m2_attempts"] = np.asarray(
                [st["n_accepted"][0], st["n_rejected"][0]])
        else:
            out[f"{key}_xy"] = np.stack(
                [np.asarray(xy[1], np.float64) for xy in res["XYList"]])
            if "dataYs" in res:
                out[f"{key}_data_ys"] = np.asarray(res["dataYs"])
        print(f"{model}: {time.perf_counter() - t0:.1f} s", flush=True)
    for part in HETERO_MODELS:
        t0 = time.perf_counter()
        res = rmtExe(hetero_input(part))["resModel"]
        key = ref_key(part)
        out[f"{key}_xy"] = np.stack(
            [np.asarray(xy[1], np.float64) for xy in res["XYList"]])
        if "dataYs" in res:
            out[f"{key}_data_ys"] = np.asarray(res["dataYs"])
        if part == "T1":
            st = res["solverStats"]
            out["t1_state"] = np.asarray(res["checkpoint"]["state"])
            out["t1_attempts"] = np.asarray([st["n_accepted"],
                                             st["n_rejected"]])
        print(f"{part}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    sweep = run_m14_sweep(hetero_case.m14_model_input(),
                          {"T0": np.asarray(M14_SWEEP_T0)})
    assert bool(np.all(np.asarray(sweep["converged"])))
    out["m14_sweep_t0"] = np.asarray(M14_SWEEP_T0)
    out["m14_sweep_states"] = np.asarray(sweep["states"])
    print(f"M14 sweep: {time.perf_counter() - t0:.1f} s", flush=True)
    for model in DYN_MODELS:
        t0 = time.perf_counter()
        res = rmtExe(dyn_input(model))["resModel"]
        key = model.lower()
        for k, v in dyn_pack(res).items():
            out[f"{key}_{k}"] = v
        if "solverStats" in res:
            st = res["solverStats"]
            out[f"{key}_attempts"] = np.asarray(
                [st["n_accepted"], st["n_rejected"]])
        print(f"{model}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    sweep = run_m13_sweep(dyn_input("M13"),
                          {"T0": np.asarray(M13_SWEEP_T0)}, engine="lockstep")
    assert not np.asarray(sweep["unreached"]).any()
    # rmt_tpu's solid Newton leaves one node of the middle member above
    # its tolerance at the last interval: recorded, not asserted
    out["m13_sweep_converged"] = np.asarray(sweep["converged"])
    out["m13_sweep_t0"] = np.asarray(M13_SWEEP_T0)
    out["m13_sweep_gas"] = np.asarray(sweep["gas"])
    out["m13_sweep_solid"] = np.asarray(sweep["solid"])
    print(f"M13 lockstep sweep: {time.perf_counter() - t0:.1f} s",
          flush=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k} {v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
