#!/usr/bin/env python3
"""Regenerate models_ref.npz: rmt_tpu's rmtExe on the CPU in float64 for
the packed-bed, plug-flow and batch models, the oracle that chip_smoke.py
holds rmt_tpu_torch's rmtExe to on the card.

    python3 scripts/gen_models_ref.py [--out models_ref.npz]

Inputs: rmt_tpu_torch/cases/pb_case.py (the inputs of rmt_tpu's own tests
of these models). For M0, M1, M3, M4, M7 and M8 the file holds the
result's XYList rows (<id>_xy, (rows, points)) and, where the result has
one, dataYs (<id>_data_ys); for M2 at its default grid (zNo 100, tNo 10)
dataPacktime (m2_packtime, (7, 10, 100)), the final state (m2_state) and
the integrator's accepted and rejected attempts (m2_attempts). M9 is not
in the file: rmt_tpu's M9 run exhausts its attempt budget. About 25 s.
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
    from rmt_tpu_torch.cases.pb_case import model_input

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
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k} {v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
