#!/usr/bin/env python3
"""The port's sequential path on one CUDA card: rmtExe for N1 and N2 and
the vmapped N2 ensemble (BASELINE config #4), all in float64 on the
member-batched Radau integrator (rmt_tpu_torch.solvers.radau); with
--models, rmtExe for the other models instead (--dyn: the dynamic
heterogeneous M10-M13 alone); with --m14-sweep, --m13-sweep or
--m11-sweep, the design sweeps.

    python3 scripts/bench_torch_seq.py [--b B ...] [--skip-api]
    python3 scripts/bench_torch_seq.py --models | --dyn
    python3 scripts/bench_torch_seq.py [--m14-sweep B ...] [--m13-sweep B ...]
                                       [--m11-sweep B ...]

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

With --models (the inputs of rmt_tpu_torch/cases/pb_case.py, solver
defaults, against models_ref.npz: rmt_tpu's rmtExe on the CPU in
float64, scripts/gen_models_ref.py):

  rmtExe M2  the default grid (zNo 100, tNo 10, n = 700: the lockstep
             integrator at B = 1 in block mode, the block kernels at
             m = 7, z = 100), a first and a warm call (attempts, peak
             device memory of the warm call; dataPacktime and the final
             state within 1e-5 relative, attempts within 1.25 times the
             reference's), then an instrumented call whose Jacobian
             refreshes (colored JVPs and block extraction), block-kernel
             calls and RHS calls are each closed by a device
             synchronisation, for the wall's split (the rest is the
             host's integrator glue);
  steady     rmtExe M0, M1, M3, M4, M7 and M8 (the sequential Radau
             integrator on one state of 7 to 9 entries), a first and a
             warm call each; XYList rows and dataYs within 1e-6 relative;
  hetero     rmtExe T1 (FDM, rNo 7, period 5 s, rtol 1e-3: the Radau
             integrator through the explosive early transient), T2 by
             FDM, OC and OCFE (Newton), T3 (zNo 10) and M14 (zNo 30, n =
             420: Radau pseudo-transient continuation, then Newton) and M5
             (Radau), the inputs of rmt_tpu_torch/cases/hetero_case.py, a
             first and a warm call each, the first call's Radau attempts
             and Newton iterations; XYList rows and dataYs within 1e-6
             relative, T1's checkpoint state too and its attempts within
             1.25 times the reference's;
  dynamic    rmtExe M10 (zNo 10, tNo 2, 0.02 s), M11 and M13 (zNo 10, rNo
             7, tNo 5, 5 s) and M12 (zNo 10, tNo 2, 4e-3 s from the
             physical startup state), hetero_case.dyn_model_input's
             inputs: a first and a warm call each (peak device memory of
             the warm call) and an instrumented third whose wall is split
             (M10-M12: Jacobians, LU factorisations, Newton sweeps, rest;
             M13: gas phase, continuation, Newton polish); every dataPack
             row and the checkpoint within 1e-6 of models_ref.npz, M10-
             M12's attempts within 1.25 times the reference's; and M10 at
             its default zNo 100 over 1e-3 s (n = 5,600; no reference:
             finite, mole fractions summing to 1 within 1e-6, temperatures
             within 400-1000 K), its attempts and LU factorisations (a
             first and the instrumented call only); M13 on rmt_tpu's
             test grid (zNo 8, rNo 5) over two chained 1.25 s runs
             against one 2.5 s run (m13_resume, 1e-6).

With --m13-sweep B: run_m13_sweep(engine="lockstep") at B members (M13
at zNo 10, rNo 7, tNo 5; T0 = 523 + linspace(0, 8, B), models_ref.npz's
three inlet temperatures at members 0, B // 2 and B - 1): wall split into
the gas phase, the solid Newton and the homotopy rescue, members/s, peak
device memory, the intervals that took the rescue; every member
converged, none unreached, the three members within rtol 2e-4, atol 1e-8
of rmt_tpu's lockstep engine (the gap printed). With --m11-sweep B:
run_m11_sweep at B members (M11 at its default grid, n = 560, T0 = 523 +
linspace(0, 8, B)): wall split as rmtExe M10-M12's, members/s, attempts,
peak device memory; every member reaches its output times.

With --m14-sweep B (hetero_case's M14 at zNo 30, T0 = 523 +
linspace(0, 20, B) with models_ref.npz's three inlet temperatures at
members 0, B // 2 and B - 1; one call each): wall, members/s, the wall's
split into the pseudo-transient continuation's Jacobians, LU
factorisations, Newton sweeps and the rest (radau.odeint_batched's
timings) and the Newton polish (root_batched), peak device memory; every
member converged, the three members within 1e-6 of models_ref.npz.

Prints one line and one JSON line per part, with the card's name and
power limit. Exits nonzero when a check fails (an unreached output time,
a state that is not finite, an error over its bar: 1e-6 against
bench_ref.npz, 1e-5 against scipy, the bars above against
models_ref.npz) or without a CUDA card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(ROOT, "bench_ref.npz")
MODELS_REF_NPZ = os.path.join(ROOT, "models_ref.npz")
STEADY_MODELS = ("M0", "M1", "M3", "M4", "M7", "M8")
BAR_STEADY = 1e-6    # against models_ref.npz (rmt_tpu, CPU float64)
BAR_M2 = 1e-5
ATTEMPTS_RATIO = 1.25
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


def models_ref():
    with np.load(MODELS_REF_NPZ) as z:
        return {k: z[k] for k in z.files}


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def steady_model(torch, device, model, ref, warm=True):
    """rmtExe of a steady or batch model (a first call and, with warm, a
    second) against models_ref.npz."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases.pb_case import model_input

    first, res = timed(torch, lambda: rmtExe(model_input(model),
                                             device=device))
    if warm:
        warm, res = timed(torch, lambda: rmtExe(model_input(model),
                                                device=device))
    res = res["resModel"]
    key = model.lower()
    xy = np.stack([np.asarray(r[1], np.float64) for r in res["XYList"]])
    err = max_rel(xy, ref[f"{key}_xy"])
    if f"{key}_data_ys" in ref:
        err = max(err, max_rel(res["dataYs"], ref[f"{key}_data_ys"]))
    return dict(part=f"rmtExe {model}", n_var=int(xy.shape[0]),
                points=int(xy.shape[1]), first_s=first, warm_s=warm,
                max_rel_err=err, bar=BAR_STEADY,
                finite=bool(np.isfinite(xy).all()),
                ok=bool(err <= BAR_STEADY and np.isfinite(xy).all()))


# rmtExe of the particle, axial-dispersion and steady heterogeneous models
# (rmt_tpu_torch/cases/hetero_case.py's inputs); "T2 oc" and "T2 fem" are
# T2 by those numerical methods
HETERO_MODELS = ("T1", "T2", "T2 oc", "T2 fem", "T3", "M5", "M14")
# the inlet temperatures of models_ref.npz's M14 sweep rows: 523 K, the
# middle member of 523 + linspace(0, 20, 256) and 543 K
M14_SWEEP_T0 = (523.0, 523.0 + 20.0 * 128 / 255, 543.0)


def hetero_input(part):
    """The modelInput of a HETERO_MODELS entry."""
    from rmt_tpu_torch.cases import hetero_case

    model, _, method = part.partition(" ")
    if model == "T2":
        return hetero_case.t2_model_input(method or None)
    return hetero_case.model_input(model)


def ref_key(part):
    """models_ref.npz's key prefix of a HETERO_MODELS entry (t2_oc, ...)."""
    return part.lower().replace(" ", "_")


class solver_counts:
    """Counts the attempts of every radau.odeint call and the iterations
    of every newton.root call made inside the block into a dict
    ("attempts", "newton_iterations"); it reads each call's statistics
    once the call has returned."""

    def __init__(self, acc):
        self.acc = acc

    def __enter__(self):
        from rmt_tpu_torch.solvers import newton, radau

        self.saved = (radau.odeint, newton.root)
        odeint, root = self.saved
        acc = self.acc

        def counted_odeint(*a, **kw):
            ys, st = odeint(*a, **kw)
            acc["attempts"] = acc.get("attempts", 0) + int(
                st.n_accepted + st.n_rejected)
            return ys, st

        def counted_root(*a, **kw):
            sol = root(*a, **kw)
            acc["newton_iterations"] = acc.get("newton_iterations", 0) + int(
                sol.iterations)
            return sol

        radau.odeint, newton.root = counted_odeint, counted_root
        return acc

    def __exit__(self, *exc):
        from rmt_tpu_torch.solvers import newton, radau

        radau.odeint, newton.root = self.saved


def hetero_model(torch, device, part, ref, warm=True):
    """rmtExe of a HETERO_MODELS entry (a first call and, with warm, a
    second) against models_ref.npz: XYList rows and dataYs within 1e-6
    relative; T1 also its checkpoint state, and its attempts within
    ATTEMPTS_RATIO of the reference's. Records the first call's radau
    attempts and Newton iterations; M14's record carries its gas
    concentrations (co_gas) for the sweep's member 0."""
    from rmt_tpu_torch import rmtExe

    counts = {}
    with solver_counts(counts):
        first, res = timed(torch, lambda: rmtExe(hetero_input(part),
                                                 device=device))
    if warm:
        warm, res = timed(torch, lambda: rmtExe(hetero_input(part),
                                                device=device))
    res = res["resModel"]
    key = ref_key(part)
    xy = np.stack([np.asarray(r[1], np.float64) for r in res["XYList"]])
    err = max_rel(xy, ref[f"{key}_xy"])
    if f"{key}_data_ys" in ref:
        err = max(err, max_rel(res["dataYs"], ref[f"{key}_data_ys"]))
    out = dict(part=f"rmtExe {part}", n_var=int(xy.shape[0]),
               points=int(xy.shape[1]), first_s=first, warm_s=warm, **counts)
    ok = True
    if part == "T1":
        st = res["solverStats"]
        att = st["n_accepted"] + st["n_rejected"]
        ref_att = int(ref["t1_attempts"].sum())
        err = max(err, max_rel(res["checkpoint"]["state"], ref["t1_state"]))
        out.update(attempts=att, ref_attempts=ref_att,
                   accepted=st["n_accepted"], rejected=st["n_rejected"],
                   ref_accepted=int(ref["t1_attempts"][0]),
                   ref_rejected=int(ref["t1_attempts"][1]))
        ok = (st["n_unreached"] == 0 and ref_att / ATTEMPTS_RATIO <= att
              <= ATTEMPTS_RATIO * ref_att)
    if part == "M14":
        out["co_gas"] = np.asarray(res["dataPack"][0]["dataYCoGas"]).tolist()
    finite = bool(np.isfinite(xy).all())
    out.update(max_rel_err=err, bar=BAR_STEADY, finite=finite,
               ok=bool(ok and err <= BAR_STEADY and finite))
    return out


def m14_sweep_t0(b):
    """The sweep's inlet temperatures: 523 + linspace(0, 20, b) with
    M14_SWEEP_T0 at members 0, b // 2 and b - 1."""
    t0 = 523.0 + np.linspace(0.0, 20.0, b)
    t0[[0, b // 2, b - 1]] = M14_SWEEP_T0
    return t0


def m14_sweep(torch, device, b, ref, co_gas=None):
    """run_m14_sweep at b members over m14_sweep_t0(b) (M14 at zNo 30, one
    call): wall split into the pseudo-transient continuation's Jacobians,
    LU factorisations, Newton sweeps and the rest, and the Newton polish
    (run_m14_sweep's timings), members/s, peak device memory; every member converged
    and finite, members 0, b // 2 and b - 1 within 1e-6 of models_ref.npz's
    rows (rel_err, bench.py's floor 1e-7), and, given co_gas (rmtExe M14's
    gas concentrations on the card), member 0 within 1e-6 of it."""
    from rmt_tpu_torch.cases import hetero_case
    from rmt_tpu_torch.parallel import run_m14_sweep

    mi = hetero_case.m14_model_input()
    split = {}
    torch.cuda.reset_peak_memory_stats()
    wall, out = timed(torch, lambda: run_m14_sweep(
        mi, {"T0": m14_sweep_t0(b)}, device=device, timings=split))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    states = out["states"].cpu().numpy()
    converged = int(out["converged"].sum())
    finite = bool(np.isfinite(states).all())
    err = float(rel_err(states[[0, b // 2, b - 1]],
                        ref["m14_sweep_states"]).max())
    rec = dict(part="run_m14_sweep", B=b, n=int(states[0].size), wall_s=wall,
               members_per_sec=b / wall, split_s=split, peak_gib=peak,
               converged=converged, res_norm_max=float(out["res_norm"].max()),
               finite=finite, max_rel_err=err, bar=BAR_STEADY)
    ok = converged == b and finite and err <= BAR_STEADY
    if co_gas is not None:
        c_max = float(np.max(mi["feed"]["concentration"]))
        e0 = max_rel(states[0, :-1, 0] * c_max, np.asarray(co_gas))
        rec["member0_vs_rmtexe"] = e0
        ok = ok and e0 <= BAR_STEADY
    rec["ok"] = bool(ok)
    return rec


# rmtExe of the dynamic heterogeneous models (hetero_case.dyn_model_input):
# M10 at zNo 10 (its default zNo 100 has no CPU reference) and tNo 2 over
# rmt_tpu's test period 0.02 s; M11 and M13 at their default grids (zNo
# 10, rNo 7, tNo 5, period 5 s); M12 at zNo 10 (rNo pinned at 7 by the OC
# basis), tNo 2 over rmt_tpu's test period 4e-3 s from the physical
# startup state; "M10 z100" is M10's default zNo 100 over 1e-3 s, checked
# for physics only (no reference)
DYN_MODELS = ("M10", "M11", "M12", "M13")
# their bar: |got - want| / (|want| + DYN_FLOOR) <= BAR_STEADY, the floor
# of chip_smoke.rel_err's kernel checks. M13's particle Newton stops at a
# residual of 1e-9, so two correct implementations part at about 1e-9
# absolute (measured on the CPU: 4.8e-10, the port against rmt_tpu), in
# rows whose entries reach down to 1e-5 (theta near the inlet
# temperature): rel_err's floor 1e-7 would count that as 1e-4. Both
# errors are recorded.
DYN_FLOOR = 1e-3
DYN_ROWS = ("dataYCon", "dataYTemp", "dataYs", "dataYCons", "dataYTemps")
# the inlet temperatures of models_ref.npz's M13 lockstep sweep rows: the
# members 0, B // 2 and B - 1 of 523 + linspace(0, 8, 256)
M13_SWEEP_T0 = (523.0, 523.0 + 8.0 * 128 / 255, 531.0)


def dyn_input(part):
    """The modelInput of a DYN_MODELS entry (or "M10 z100")."""
    from rmt_tpu_torch.cases import hetero_case

    if part == "M10 z100":
        return hetero_case.dyn_model_input("M10", dict(tNo=2), 1e-3)
    if part == "M10":
        return hetero_case.dyn_model_input("M10", dict(zNo=10, tNo=2), 0.02)
    if part == "M12":
        mi = hetero_case.dyn_model_input("M12", dict(zNo=10, tNo=2), 4e-3)
        mi["resume-state"] = hetero_case.m12_physical_resume(10)
        return mi
    return hetero_case.dyn_model_input(part)


def rel_floor(got, want, floor=DYN_FLOOR):
    """max |got - want| / (|want| + floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (np.abs(want) + floor)).max())


def dyn_pack(res):
    """{row: (tNo, ...)} of a dynamic heterogeneous rmtExe result's
    dataPack, and the checkpoint's arrays (state; M13: gas, solid)."""
    out = {k: np.stack([np.asarray(p[k], np.float64)
                        for p in res["dataPack"]]) for k in DYN_ROWS}
    out.update({k: np.asarray(v, np.float64)
                for k, v in res["checkpoint"].items()
                if k in ("state", "gas", "solid")})
    return out


def m10_physics(res):
    """rmt_tpu's tests/test_m10.py checks of a result without a
    reference: every value finite, gas mole fractions summing to 1 within
    1e-6, temperatures between 400 and 1000 K. Returns the worst
    violation (0 when all hold)."""
    pack = dyn_pack(res)
    if not all(np.isfinite(v).all() for v in pack.values()):
        return float("inf")
    n_comp = pack["dataYCon"].shape[1]
    err = float(np.abs(pack["dataYs"][:, :n_comp].sum(axis=1) - 1.0).max()
                / 1e-6)
    temps = np.concatenate([pack["dataYTemp"].ravel(),
                            pack["dataYTemps"].ravel()])
    out = float(max(400.0 - temps.min(), temps.max() - 1000.0, 0.0))
    return max(err - 1.0, 0.0) + out


def dyn_model(torch, device, part, ref, warm=True, split=False):
    """rmtExe of a DYN_MODELS entry (a first call and, with warm, a
    second; peak device memory of the last) against models_ref.npz:
    every dataPack row and the checkpoint within 1e-6 (rel_floor, floor
    DYN_FLOOR; rel_err's, floor 1e-7, recorded beside it), M10-M12's
    Radau attempts
    within ATTEMPTS_RATIO of the reference's (M13 reports none, in
    rmt_tpu too). "M10 z100" is held to m10_physics instead. With split,
    M13's wall is split into the gas phase, the continuation and the
    Newton polish, and M10-M12's into the Jacobians, LU factorisations,
    Newton sweeps and the rest (an instrumented third call)."""
    from rmt_tpu_torch import rmtExe

    torch.cuda.reset_peak_memory_stats()
    first, res = timed(torch, lambda: rmtExe(dyn_input(part), device=device))
    if warm:
        torch.cuda.reset_peak_memory_stats()
        warm, res = timed(torch, lambda: rmtExe(dyn_input(part),
                                                device=device))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = res["resModel"]
    out = dict(part=f"rmtExe {part}", first_s=first, warm_s=warm,
               peak_gib=peak)
    st = res.get("solverStats")
    if st is not None:
        out.update(attempts=st["n_accepted"] + st["n_rejected"],
                   accepted=st["n_accepted"], rejected=st["n_rejected"],
                   lu=st["n_lu"])
    if split:
        out["split_s"] = dyn_split(torch, device, part)
    if part == "M10 z100":
        v = m10_physics(res)
        out.update(physics_violation=v, ok=bool(v == 0.0))
        return out
    key = part.lower()
    pack = dyn_pack(res)
    err = max(rel_floor(v, ref[f"{key}_{k}"]) for k, v in pack.items())
    out.update(rel_err_1e7=max(float(rel_err(v, ref[f"{key}_{k}"]).max())
                               for k, v in pack.items()),
               max_abs_err=max(float(np.abs(v - ref[f"{key}_{k}"]).max())
                               for k, v in pack.items()))
    finite = all(bool(np.isfinite(v).all()) for v in pack.values())
    ok = err <= BAR_STEADY and finite
    if st is not None:
        ref_att = int(ref[f"{key}_attempts"].sum())
        out.update(ref_attempts=ref_att)
        ok = ok and (ref_att / ATTEMPTS_RATIO <= out["attempts"]
                     <= ATTEMPTS_RATIO * ref_att)
    if part == "M11":
        out["state"] = pack["state"].tolist()
    out.update(max_rel_err=err, bar=BAR_STEADY, finite=finite, ok=bool(ok))
    return out


def dyn_split(torch, device, part):
    """{part: seconds} of an instrumented rmtExe call of a dynamic
    heterogeneous model: radau.odeint_batched's timings (M10-M12), or
    make_m13_driver's (M13), each part closed by a device
    synchronisation."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.models import hetero_dyn
    from rmt_tpu_torch.solvers import radau

    acc = {}
    if part == "M13":
        saved, mod, name = hetero_dyn.make_m13_driver, hetero_dyn, \
            "make_m13_driver"

        def patched(*a, **kw):
            run = saved(*a, **kw)
            return lambda *ra, **rkw: run(*ra, **dict(rkw, timings=acc))
    else:
        saved, mod, name = radau.odeint_batched, radau, "odeint_batched"

        def patched(*a, **kw):
            return saved(*a, **dict(kw, timings=acc))
    setattr(mod, name, patched)
    try:
        timed(torch, lambda: rmtExe(dyn_input(part), device=device))
    finally:
        setattr(mod, name, saved)
    return acc


# M13's chained resume on rmt_tpu's tests/test_m13.py grid, in intervals
# of that test's length (it chains two 2.5 s runs of two intervals each;
# here two runs of one interval each)
RESUME_GRID = dict(zNo=8, rNo=5)
RESUME_INTERVAL_S = 1.25


def m13_resume(torch, device):
    """M13 on RESUME_GRID over two intervals of RESUME_INTERVAL_S in one
    run, and the same as two chained runs of one interval each (the
    first's checkpoint is the second's resume-state), as rmt_tpu's
    tests/test_m13.py chains its runs: the chained checkpoint's error
    (rel_floor; rel_err and the absolute error recorded) against the
    single run's."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases import hetero_case

    t_end = 2 * RESUME_INTERVAL_S
    wall, full = timed(torch, lambda: rmtExe(
        hetero_case.dyn_model_input("M13", dict(RESUME_GRID, tNo=2), t_end),
        device=device))
    ck_full = full["resModel"]["checkpoint"]
    ck = None
    for _ in range(2):
        mi = hetero_case.dyn_model_input("M13", dict(RESUME_GRID, tNo=1),
                                         RESUME_INTERVAL_S)
        if ck is not None:
            mi["resume-state"] = ck
        w, res = timed(torch, lambda: rmtExe(mi, device=device))
        wall += w
        ck = res["resModel"]["checkpoint"]
    pairs = [(ck[k], np.asarray(ck_full[k])) for k in ("gas", "solid")]
    err = max(rel_floor(a, b) for a, b in pairs)
    return dict(part="rmtExe M13 chained resume", wall_s=wall,
                t_end=float(ck["t"]), max_rel_err=err,
                rel_err_1e7=max(float(rel_err(a, b).max()) for a, b in pairs),
                max_abs_err=max(float(np.abs(a - b).max()) for a, b in pairs),
                bar=BAR_STEADY,
                ok=bool(err <= BAR_STEADY and abs(ck["t"] - t_end) < 1e-9))


def m13_sweep_t0(b):
    """The M13 sweep's inlet temperatures: 523 + linspace(0, 8, b) with
    M13_SWEEP_T0 at members 0, b // 2 and b - 1 (scripts/bench_m13.py's
    design sweep)."""
    t0 = 523.0 + np.linspace(0.0, 8.0, b)
    t0[[0, b // 2, b - 1]] = M13_SWEEP_T0
    return t0


def m13_sweep(torch, device, b, ref):
    """run_m13_sweep(engine="lockstep") at b members over m13_sweep_t0(b)
    (M13 at zNo 10, rNo 7, tNo 5, the defaults of scripts/bench_m13.py):
    wall split into the gas phase, the solid Newton and the rescue,
    members/s, peak device memory, the intervals that took the rescue,
    the inlet temperatures of unconverged members; every member
    converged with no output time unreached, members 0,
    b // 2 and b - 1 within rtol 2e-4, atol 1e-8 of rmt_tpu's lockstep
    engine (models_ref.npz; rmt_tpu's bar between its engines), the
    measured gap reported."""
    from rmt_tpu_torch.cases import hetero_case
    from rmt_tpu_torch.parallel import run_m13_sweep

    mi = hetero_case.dyn_model_input("M13")
    split = {}
    torch.cuda.reset_peak_memory_stats()
    wall, out = timed(torch, lambda: run_m13_sweep(
        mi, {"T0": m13_sweep_t0(b)}, engine="lockstep", device=device,
        timings=split))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = [0, b // 2, b - 1]
    gaps, ok_tol = {}, True
    for k in ("gas", "solid"):
        got = out[k].cpu().numpy()
        want = ref[f"m13_sweep_{k}"]
        diff = np.abs(got[rows] - want)
        gaps[k] = dict(abs=float(diff.max()), rel=float(
            (diff / np.maximum(np.abs(want), 1e-8)).max()))
        ok_tol = (ok_tol and bool(np.isfinite(got).all())
                  and bool(np.all(diff <= 1e-8 + 2e-4 * np.abs(want))))
    converged = int(out["converged"].sum())
    unreached = int(out["unreached"].sum())
    t0 = m13_sweep_t0(b)
    return dict(part="run_m13_sweep lockstep", B=b, wall_s=wall,
                unconverged_t0=t0[~out["converged"].cpu().numpy()].tolist(),
                members_per_sec=b / wall, split_s=split, peak_gib=peak,
                converged=converged, unreached=unreached,
                rescued_intervals=out["rescued"], gap=gaps,
                bar="rtol 2e-4, atol 1e-8",
                ok=bool(ok_tol and converged == b and unreached == 0))


def m11_sweep(torch, device, b, state=None):
    """run_m11_sweep at b members, T0 = M11_SWEEP_T0's first b entries
    spread over the same 8 K (M11 at its default grid, n = 560): wall
    split into the Jacobians, LU factorisations, Newton sweeps and the
    rest, members/s, peak device memory; every member reaches its output
    times and stays finite, and, given state (rmtExe M11's checkpoint on
    the card), member 0's final state within 1e-6 of it (rel_floor; the
    record carries member 0's final state as "state")."""
    from rmt_tpu_torch.cases import hetero_case
    from rmt_tpu_torch.parallel import run_m11_sweep

    mi = hetero_case.dyn_model_input("M11")
    split = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = 523.0 + np.linspace(0.0, 8.0, b)
    wall, (ys, stats) = timed(torch, lambda: run_m11_sweep(
        mi, {"T0": t0}, device=device, timings=split))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    att = (stats.n_accepted + stats.n_rejected).cpu().numpy()
    finite = bool(torch.isfinite(ys).all())
    unreached = int(stats.n_unreached.sum())
    rec = dict(part="run_m11_sweep", B=b, n=int(ys.shape[-1]), wall_s=wall,
               members_per_sec=b / wall, split_s=split, peak_gib=peak,
               attempts_mean=float(att.mean()), attempts_max=int(att.max()),
               unreached=unreached, finite=finite, bar=BAR_STEADY,
               state=ys[0, -1].cpu().numpy().tolist())
    ok = finite and unreached == 0
    if state is not None:
        e0 = rel_floor(ys[0, -1].cpu().numpy(), state)
        rec["member0_vs_rmtexe"] = e0
        ok = ok and e0 <= BAR_STEADY
    rec["ok"] = bool(ok)
    return rec


def _timed_calls(torch, fn, acc, key):
    """fn, with each call closed by device synchronisations and its wall
    added to acc[key]."""
    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return out

    return wrapped


def m2_split(torch, device):
    """(wall, {part: seconds}) of an rmtExe M2 call whose Jacobian
    refreshes, block-kernel calls and RHS calls are timed (each closed by
    a device synchronisation)."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases.pb_case import m2_model_input
    from rmt_tpu_torch.models import pb
    from rmt_tpu_torch.ops import cuda_block, jacobian
    from rmt_tpu_torch.solvers import stiff_ensemble

    acc = {}
    make_rhs, make_jac = pb.make_m2_rhs, jacobian.batched_colored_jacobian
    saved = [(jacobian, "batched_colored_jacobian", make_jac),
             (pb, "make_m2_rhs", make_rhs),
             (stiff_ensemble, "extract_bidiag_blocks",
              stiff_ensemble.extract_bidiag_blocks)]
    saved += [(cuda_block, k, getattr(cuda_block, k))
              for k in ("block_factor", "block_apply", "block_apply_real")]

    def rhs_maker(spec, frozen_pressure_jac=False):
        rhs = make_rhs(spec, frozen_pressure_jac)
        # the frozen RHS runs inside the Jacobian's JVPs
        return rhs if frozen_pressure_jac else _timed_calls(
            torch, rhs, acc, "rhs")

    try:
        jacobian.batched_colored_jacobian = lambda *a: _timed_calls(
            torch, make_jac(*a), acc, "jacobian")
        pb.make_m2_rhs = rhs_maker
        stiff_ensemble.extract_bidiag_blocks = _timed_calls(
            torch, saved[2][2], acc, "jacobian")
        for mod, k, fn in saved[3:]:
            setattr(mod, k, _timed_calls(torch, fn, acc, "block kernels"))
        wall, _ = timed(torch, lambda: rmtExe(m2_model_input(),
                                              device=device))
    finally:
        for mod, k, fn in saved:
            setattr(mod, k, fn)
    acc["host"] = wall - sum(acc.values())
    return wall, acc


def rmtexe_m2(torch, device, ref, split=True):
    """rmtExe M2 at the default grid, a first and a warm call (and, with
    split, the instrumented one), against models_ref.npz."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases.pb_case import m2_model_input
    from rmt_tpu_torch.ops import cuda_block

    first, _ = timed(torch, lambda: rmtExe(m2_model_input(), device=device))
    torch.cuda.reset_peak_memory_stats()
    before = dict(cuda_block.LAUNCHES)
    warm, res = timed(torch, lambda: rmtExe(m2_model_input(), device=device))
    launches = {k: v - before[k] for k, v in cuda_block.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = res["resModel"]
    st = res["solverStats"]
    attempts = st["n_accepted"][0] + st["n_rejected"][0]
    ref_att = int(ref["m2_attempts"].sum())
    err = max(max_rel(res["dataPacktime"], ref["m2_packtime"]),
              max_rel(res["checkpoint"]["state"], ref["m2_state"]))
    out = dict(part="rmtExe M2", n=int(ref["m2_state"].size), first_s=first,
               warm_s=warm, attempts=attempts, ref_attempts=ref_att,
               jacobian_refreshes=st["n_jev"] - 1, launches=launches,
               peak_gib=peak, max_rel_err=err, bar=BAR_M2,
               finite=bool(np.isfinite(res["dataPacktime"]).all()))
    if split:
        out["split_wall_s"], out["split_s"] = m2_split(torch, device)
    out["ok"] = bool(err <= BAR_M2 and out["finite"]
                     and ref_att / ATTEMPTS_RATIO <= attempts
                     <= ATTEMPTS_RATIO * ref_att)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_seq: no CUDA device; this script "
                         "measures the card")
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, nargs="*", default=[4096])
    ap.add_argument("--skip-api", action="store_true",
                    help="only the ensemble")
    ap.add_argument("--models", action="store_true",
                    help="only rmtExe of the models other than N1/N2")
    ap.add_argument("--dyn", action="store_true",
                    help="only rmtExe of M10-M13 (and M10 at zNo 100)")
    ap.add_argument("--m14-sweep", type=int, nargs="+", metavar="B",
                    help="only run_m14_sweep at these member counts")
    ap.add_argument("--m13-sweep", type=int, nargs="+", metavar="B",
                    help="only run_m13_sweep(engine='lockstep') at these "
                    "member counts")
    ap.add_argument("--m11-sweep", type=int, nargs="+", metavar="B",
                    help="only run_m11_sweep at these member counts")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import rmt_tpu_torch  # noqa: F401 (its import turns TF32 off: header)
    from chip_smoke import header, n1_reference, start_n1_reference

    card = header(torch)
    print(f"linalg: MAGMA {torch.cuda.has_magma}, preferred backend "
          f"{torch.backends.cuda.preferred_linalg_library()}", flush=True)
    device = torch.device("cuda:0")
    parts = []
    if args.m14_sweep or args.m13_sweep or args.m11_sweep:
        ref = models_ref()
        parts += [m14_sweep(torch, device, b, ref)
                  for b in args.m14_sweep or ()]
        parts += [m13_sweep(torch, device, b, ref)
                  for b in args.m13_sweep or ()]
        parts += [m11_sweep(torch, device, b) for b in args.m11_sweep or ()]
    elif args.models or args.dyn:
        ref = models_ref()
        if args.models:
            parts.append(rmtexe_m2(torch, device, ref))
            parts += [steady_model(torch, device, m, ref)
                      for m in STEADY_MODELS]
            parts += [hetero_model(torch, device, m, ref)
                      for m in HETERO_MODELS]
        # M10 at zNo 100: a first and the instrumented call (minutes each)
        parts += [dyn_model(torch, device, m, ref, warm=m != "M10 z100",
                            split=True)
                  for m in (*DYN_MODELS, "M10 z100")]
        parts.append(m13_resume(torch, device))
    elif args.skip_api:
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
        r = {k: v for k, v in r.items()
             if k not in ("stats", "co_gas", "state", "checkpoint")}
        print(" ".join(f"{k}={v}" for k, v in r.items()), flush=True)
        print(json.dumps(r), flush=True)
    if not all(r["ok"] for r in parts):
        raise SystemExit("bench_torch_seq: FAILED (an unreached output "
                         "time, a non-finite state or an error over its "
                         "bar)")


if __name__ == "__main__":
    main()
