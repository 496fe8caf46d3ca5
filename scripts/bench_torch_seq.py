#!/usr/bin/env python3
"""The port's sequential path on one CUDA card: rmtExe for N1 and N2 and
the vmapped N2 ensemble (BASELINE config #4), all in float64 on the
member-batched Radau integrator (rmt_tpu_torch.solvers.radau).

    python3 scripts/bench_torch_seq.py [--b B ...] [--skip-api]

  rmtExe N2  the DME case (zNo 20, n = 140, tNo 5, period 0.5, solver
             defaults rtol 1e-7 / atol 1e-10) at the first probe
             temperature of bench_ref.npz, called twice (first, warm);
             its states, rebuilt from dataPack (dataYCons1, dataYTemp1)
             and the checkpoint, against that probe's dme_ys (CPU float64,
             rtol 1e-9), relative error with the denominator
             max(|ref|, 1e-7) as bench.py;
  rmtExe N1  the DME case (101 points over z) at inlet 523 - 5 K, twice;
             its states (dataYCons1, dataYs' pressure row / P0,
             dataYTemp1) against scipy's float64 Radau (rtol 1e-10) on the
             port's N1 RHS, computed on the CPU by a child process that
             starts with the script (chip_smoke.start_n1_reference);
  ensemble   rmt_tpu_torch.parallel.run_n2_ensemble over B members (default
             4096), T0 = 523 + linspace(-5, 5, B) with bench.py's 64 probe
             offsets spliced in (chip_smoke.probe_layout), at rmtExe's
             tolerances: a first call, a warm call (members/s, attempts
             mean / max, max_rel_err over the 64 probes, every member's
             n_unreached 0, peak device memory of the warm call), then an
             instrumented call whose Jacobian, LU factorisations and
             Newton sweeps are each closed by a device synchronisation
             (radau.odeint_batched's timings) for the wall's split.

Prints one line and one JSON line per part, with the card's name and
power limit. Exits nonzero when a check fails (an unreached output time,
a state that is not finite, an error over its bar: 1e-6 against
bench_ref.npz, 1e-5 against scipy) or without a CUDA card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(ROOT, "bench_ref.npz")
BAR_REF = 1e-6       # against bench_ref.npz (CPU float64, rtol 1e-9)
BAR_SCIPY = 1e-5     # against scipy's float64 Radau (rtol 1e-10)
N1_PROBE = 0         # scripts/bench_torch_n1.PROBES[0]: 523 - 5 K


def rel_err(got, ref):
    """Relative error with the denominator max(|ref|, 1e-7) (bench.py)."""
    got = np.asarray(got, np.float64)
    return np.abs(got - ref) / np.maximum(np.abs(ref), 1e-7)


def dme_probes():
    """(offsets (64,), dme_ys (6, 64, 140), t_base) of bench_ref.npz."""
    with np.load(REF_NPZ) as z:
        return z["dme_offsets"], z["dme_ys"], float(z["dme_t_base"])


def at_temperature(mi, t0):
    """modelInput with only its inlet temperature T0 changed (the sweeps
    of bench_ref.npz change that leaf alone)."""
    return dict(mi, **{"operating-conditions": dict(
        mi["operating-conditions"], temperature=float(t0))})


def n2_states(res):
    """(rows (tNo, n), state (n,)): the dimensionless N2 states at the tNo
    output times rebuilt from a resModel's dataPack (dataYCons1 over
    dataYTemp1), and its checkpoint's state (the last output time)."""
    rows = [np.concatenate([p["dataYCons1"], p["dataYTemp1"][None]])
            .reshape(-1) for p in res["dataPack"]]
    return np.stack(rows), np.asarray(res["checkpoint"]["state"])


def n1_states(res, p0):
    """(z_out + 1, n) dimensionless N1 states from a resModel: the
    concentrations, the pressure row of dataYs over P0, the temperature."""
    r = res[0]
    n_comp = r["indexList"][0]
    return np.concatenate([r["dataYCons1"],
                           r["dataYs"][n_comp:n_comp + 1] / p0,
                           r["dataYTemp1"][None]]).T


def timed(torch, fn):
    """(seconds, fn()) on the host clock around a synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def rmtexe_n2(torch, device, warm=True):
    """rmtExe N2 at the first DME probe: a first call and, with warm, a
    second (timed warm)."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases.dme_case import make_model_input

    offsets, ref_ys, t_base = dme_probes()
    mi = at_temperature(make_model_input(model="N2"), t_base + offsets[0])
    first, res = timed(torch, lambda: rmtExe(mi, device=device))
    if warm:
        warm, res = timed(torch, lambda: rmtExe(mi, device=device))
    res = res["resModel"]
    rows, ck = n2_states(res)
    err = max(rel_err(rows, ref_ys[1:, 0]).max(),
              rel_err(ck, ref_ys[-1, 0]).max())
    st = res["solverStats"]
    return dict(part="rmtExe N2", T0=t_base + offsets[0], n=int(ck.size),
                first_s=first, warm_s=warm,
                attempts=st["n_accepted"] + st["n_rejected"], stats=st,
                max_rel_err=float(err), bar=BAR_REF,
                finite=bool(np.isfinite(rows).all()),
                ok=bool(err <= BAR_REF and st["n_unreached"] == 0))


def rmtexe_n1(torch, device, ref, warm=True):
    """rmtExe N1 at 523 + PROBES[N1_PROBE] (a first call and, with warm,
    a second) against ref (101, n), scipy's trajectory of that reactor."""
    import bench_torch_n1 as bench_n1
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases.dme_case import make_model_input

    t0 = bench_n1.T_BASE + bench_n1.PROBES[N1_PROBE]
    mi = at_temperature(make_model_input(model="N1"), t0)
    first, res = timed(torch, lambda: rmtExe(mi, device=device))
    if warm:
        warm, res = timed(torch, lambda: rmtExe(mi, device=device))
    res = res["resModel"]
    ys = n1_states(res, mi["operating-conditions"]["pressure"])
    err = rel_err(ys, ref).max()
    st = res[0]["solverStats"]
    return dict(part="rmtExe N1", T0=t0, n=int(ys.shape[1]), first_s=first,
                warm_s=warm, attempts=st["n_accepted"] + st["n_rejected"],
                stats=st, max_rel_err=float(err), bar=BAR_SCIPY,
                finite=bool(np.isfinite(ys).all()),
                ok=bool(err <= BAR_SCIPY and st["n_unreached"] == 0))


def ensemble(torch, b, device):
    """run_n2_ensemble at b members with the 64 DME probes spliced in."""
    sys.path.insert(0, ROOT)
    from chip_smoke import probe_layout
    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.parallel import run_n2_ensemble

    offsets, ref_ys, t_base = dme_probes()
    sweep, idx = probe_layout(np, b, offsets)
    mi = make_model_input(model="N2")

    def call(**kw):
        return run_n2_ensemble(mi, {"T0": t_base + sweep}, device=device,
                               return_stats=True, **kw)

    first, _ = timed(torch, call)
    torch.cuda.reset_peak_memory_stats()
    warm, (ys, st) = timed(torch, call)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = {}
    split_wall, _ = timed(torch, lambda: call(timings=split))
    att = (st.n_accepted + st.n_rejected).cpu().numpy()
    got = ys[idx].double().cpu().numpy()               # (64, 6, 140)
    rel = rel_err(np.moveaxis(got, 0, 1), ref_ys)
    unreached = int((st.n_unreached > 0).sum())
    finite = bool(torch.isfinite(ys).all())
    return dict(
        part="run_n2_ensemble", B=b, n=int(ys.shape[2]), first_s=first,
        warm_s=warm, members_per_sec=b / warm, attempts_mean=float(att.mean()),
        attempts_max=int(att.max()), n_fev_mean=float(st.n_fev.double().mean()),
        max_rel_err=float(rel.max()), mean_rel_err=float(rel.mean()),
        acc_B=len(idx), unreached_members=unreached, finite=finite,
        peak_gib=peak, split_wall_s=split_wall,
        split_s={k: split[k] for k in sorted(split)}, bar=BAR_REF,
        ok=bool(rel.max() <= BAR_REF and unreached == 0 and finite))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_seq: no CUDA device; this script "
                         "measures the card")
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, nargs="*", default=[4096])
    ap.add_argument("--skip-api", action="store_true",
                    help="only the ensemble")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import rmt_tpu_torch  # noqa: F401 (its import turns TF32 off: header)
    from chip_smoke import header, n1_reference, start_n1_reference

    card = header(torch)
    print(f"linalg: MAGMA {torch.cuda.has_magma}, preferred backend "
          f"{torch.backends.cuda.preferred_linalg_library()}", flush=True)
    device = torch.device("cuda:0")
    parts = []
    if args.skip_api:
        parts += [ensemble(torch, b, device) for b in args.b]
    else:
        proc = start_n1_reference()
        try:
            parts.append(rmtexe_n2(torch, device))
            parts += [ensemble(torch, b, device) for b in args.b]
            ref = n1_reference(np, proc)[:, N1_PROBE]
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        parts.append(rmtexe_n1(torch, device, ref))
    for r in parts:
        r.update(card=card, device=torch.cuda.get_device_name(0))
        print(" ".join(f"{k}={v}" for k, v in r.items() if k != "stats"),
              flush=True)
        print(json.dumps(r), flush=True)
    if not all(r["ok"] for r in parts):
        raise SystemExit("bench_torch_seq: FAILED (an unreached output "
                         "time, a non-finite state or an error over its "
                         "bar)")


if __name__ == "__main__":
    main()
