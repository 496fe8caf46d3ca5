#!/usr/bin/env python3
"""rmt_tpu's own whole-run error in each float32 accuracy mode of the N2
lockstep ensemble, on the CPU: what the port's runs of those modes on
the card are compared with.

    python3 scripts/jax_n2_modes_error.py [MODE ...]

For each MODE (df32, true, full, batched_df32; default all four)
integrates the 64 DME probe temperatures of bench_ref.npz with
rmt_tpu's run_n2_ensemble_lockstep at bench.py's f32x options (exact
block solves, cheap_sweeps 2, j_every 8, newton_iters 5, rtol 6e-7,
atol 1e-9, max_steps 768) and accurate_rates=MODE; batched_df32 is
accurate_rates="df32" on the member-last RHS (batched_rhs=True), which
takes no cheap sweeps (cheap_sweeps 0). In an x64 process on the CPU
(rmt_tpu's float32-state modes need float64 to exist), and prints one
JSON line: max_rel_err and mean_rel_err against bench_ref.npz (the
denominator max(|ref|, 1e-7), bench.py's), the worst (time, member,
state) index, attempts and the seconds. About 15-50 s a mode.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ["RMT_TPU_X64"] = "1"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

MODES = {"df32": dict(accurate_rates="df32"),
         "true": dict(accurate_rates=True),
         "full": dict(accurate_rates="full"),
         "batched_df32": dict(accurate_rates="df32", batched_rhs=True,
                              cheap_sweeps=0)}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from dme_case import make_model_input
    from rmt_tpu.parallel import run_n2_ensemble_lockstep

    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        ref, t_base, offsets = (z["dme_ys"], float(z["dme_t_base"]),
                                z["dme_offsets"])
    for name in sys.argv[1:] or list(MODES):
        t0 = time.perf_counter()
        ys, st = run_n2_ensemble_lockstep(
            make_model_input(model="N2"), {"T0": jnp.asarray(t_base + offsets)},
            rtol=6e-7, atol=1e-9, max_steps=768, newton_iters=5, j_every=8,
            exact_solve=True, **dict(dict(cheap_sweeps=2), **MODES[name]))
        ys = np.asarray(ys, np.float64)
        rel = np.abs(ys - ref) / np.maximum(np.abs(ref), 1e-7)
        att = np.asarray(st.n_accepted) + np.asarray(st.n_rejected)
        print(json.dumps({
            "package": "rmt_tpu", "device": "cpu", "accurate_rates": name,
            "B": int(ys.shape[1]), "max_rel_err": float(rel.max()),
            "mean_rel_err": float(rel.mean()),
            "worst": [int(i) for i in np.unravel_index(rel.argmax(),
                                                       rel.shape)],
            "unfinished": int(np.sum(np.asarray(st.seg) < ys.shape[0] - 1)),
            "attempts_mean": float(att.mean()),
            "attempts_max": int(att.max()),
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
