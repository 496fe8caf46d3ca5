#!/usr/bin/env python3
"""Throughput and accuracy of the port's N1 steady-state ensemble on one
CUDA card (the PyTorch twin of scripts/bench_n1.py, which stays the JAX
package's).

    python3 scripts/bench_torch_n1.py [B ...] [--iso]

N1 (BASELINE configs #1 and #3, the reference's primary documented use:
solve_ivp over the reactor length with 101 output points) on the lockstep
Radau integrator (rmt_tpu_torch.solvers.stiff_ensemble.odeint_ensemble),
B members (default 4096) sweeping the inlet temperature 523 K +- 5 K, in
float32, at rtol 1e-5 / atol 1e-7, max_steps 1536, newton_iters 5,
j_every 8, with dense output: in Newton-Schulz mode, so the
preconditioner updates run ns_fused_step (csrc/ns.cu) at n = 8 (n = 7
with --iso, the iso-thermal process). The Jacobian is the integrator's
default, forward-mode JVPs of the batched RHS.

Accuracy: 8 probe members (ACC_B) spliced into the sweep as
scripts/bench_n1.py splices them, against float64 trajectories of the
same 8 reactors computed on the CPU by scipy.integrate.solve_ivp (Radau,
rtol 1e-10, atol 1e-13, t_eval the output grid) on the port's float64 N1
RHS: an integrator independent of the one under test. Relative error with
the denominator max(|ref|, 1e-7), as bench.py.

Prints, for each B: the first call's seconds (CUDA set-up included),
members/s of the best of two warm calls, attempts mean / max, unfinished
members, max / mean relative error over the probes, the ns_fused_step
launches of the last call, peak device memory, and the card's name and
power limit; then one JSON line with the same. Exits nonzero when a
member does not finish, a state is not finite or max_rel_err > 5e-5
(the guard chip_smoke.py holds the f32 N2 leg to: the dense interpolant
carries an error of about rtol). Without a CUDA card it exits nonzero.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_BASE = 523.0
ACC_B = 8
PROBES = np.linspace(-5.0, 5.0, ACC_B)      # probe offsets from T_BASE
RTOL, ATOL = 1e-5, 1e-7
OPTS = dict(max_steps=1536, newton_iters=5, j_every=8)
BAR = 5e-5


def probe_layout(b):
    """Sweep offsets for b members (linspace -5 ... 5 K) with the ACC_B
    probe offsets spliced in at evenly spaced indices
    (scripts/bench_n1.py); returns (offsets, probe indices)."""
    offs = np.linspace(-5.0, 5.0, b)
    idx = np.round(np.linspace(0, b - 1, ACC_B)).astype(int)
    offs[idx] = PROBES
    return offs, idx


def build(mi, t_offsets, device=None, dtype=None):
    """The batched N1 problem of a T0 sweep on ``device`` (default: the
    CUDA card; without one it raises, rmt_tpu_torch.config.resolve_device)
    in ``dtype`` (default float32): (f, f_stages, y0, ts) with
    f(z (B,), y (B, n)) the per-member RHS mapped over members by
    torch.func.vmap, f_stages(zs (B, 3), Y (B, 3, n)) the same over the
    three Radau stages as one batch of 3B rows (row 3b + s is stage s of
    member b), y0 (B, n) and the output grid ts = linspace(0, 1,
    z_out + 1)."""
    import torch
    from torch.func import vmap

    from rmt_tpu_torch import config
    from rmt_tpu_torch.models import homo
    from rmt_tpu_torch.parallel import batch_params

    device = config.resolve_device(device)
    dtype = dtype or torch.float32
    spec = homo.build_spec(mi)
    base = homo.build_params(mi, dtype=dtype, device=device)
    t_offsets = np.asarray(t_offsets)
    params, axes = batch_params(base, {"T0": T_BASE + t_offsets})

    def derive(q):
        d = homo.feed_state(spec, q)
        return d, homo.n1_initial_state(spec, q, d)

    dB, y0 = vmap(derive, in_dims=(axes,))(params)
    fB = vmap(homo.make_n1_rhs(spec), in_dims=(0, 0, axes, 0))
    # the stages' rows: each member's parameters and feed state three times
    p3, _ = batch_params(base, {"T0": T_BASE + np.repeat(t_offsets, 3)})
    d3 = {k: v.repeat_interleave(3, dim=0) for k, v in dB.items()}
    n = y0.shape[1]
    ts = torch.linspace(0.0, 1.0, spec.z_out + 1, dtype=dtype, device=device)
    return (lambda z, y: fB(z, y, params, dB),
            lambda zs, Y: fB(zs.reshape(-1), Y.reshape(-1, n), p3,
                             d3).reshape(Y.shape),
            y0, ts)


def run(mi, t_offsets, device=None, dtype=None, rtol=RTOL, atol=ATOL,
        dense_output=True, **overrides):
    """Integrate the sweep (build's device and dtype): (ys (101, B, n),
    stats)."""
    from rmt_tpu_torch.solvers import stiff_ensemble

    f, f_stages, y0, ts = build(mi, t_offsets, device, dtype)
    return stiff_ensemble.odeint_ensemble(
        f, y0, ts, rtol=rtol, atol=atol, f_stages=f_stages,
        dense_output=dense_output, **dict(OPTS, **overrides), batched=True)


def scipy_reference(mi, t_offsets, rtol=1e-10, atol=1e-13):
    """float64 trajectories (101, P, n) of the P reactors of t_offsets by
    scipy's Radau on the port's float64 N1 RHS on the CPU, all members in
    one system (the Jacobian block diagonal, from the port's JVPs)."""
    import scipy.linalg
    import torch
    from scipy.integrate import solve_ivp

    from rmt_tpu_torch.solvers.stiff_ensemble import batched_jacobian

    f, _, y0, ts = build(mi, t_offsets, "cpu", torch.float64)
    P, n = y0.shape

    def state(z, x):
        return (torch.full((P,), z, dtype=torch.float64),
                torch.from_numpy(x.reshape(P, n)))

    def fun(z, x):
        return f(*state(z, x)).numpy().reshape(-1)

    def jac(z, x):
        return scipy.linalg.block_diag(*batched_jacobian(f, *state(z, x)))

    sol = solve_ivp(fun, (0.0, 1.0), y0.numpy().reshape(-1), method="Radau",
                    t_eval=ts.numpy(), rtol=rtol, atol=atol, jac=jac)
    if not sol.success:
        raise RuntimeError(f"scipy reference failed: {sol.message}")
    return sol.y.T.reshape(len(ts), P, n)


def rel_err(got, ref):
    """Relative error with the denominator max(|ref|, 1e-7) (bench.py)."""
    got = np.asarray(got, np.float64)
    return np.abs(got - ref) / np.maximum(np.abs(ref), 1e-7)


def bench(torch, mi, b, ref, device):
    """One B: a first call, then two warm calls, timed on the host clock
    around a synchronised call."""
    from rmt_tpu_torch.ops import cuda_ns

    offs, idx = probe_layout(b)

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys, st = run(mi, offs, device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, ys, st

    t_first, _, _ = call()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        cuda_ns.LAUNCHES["ns_fused_step"] = 0
        wall, ys, st = call()
        walls.append(wall)
    att = (st.n_accepted + st.n_rejected).cpu().numpy()
    unfinished = int(torch.sum(st.seg < ys.shape[0] - 1))
    rel = rel_err(ys[:, idx].double().cpu().numpy(), ref)
    return dict(
        B=b, n=int(ys.shape[2]), members_per_sec=b / min(walls),
        walls_s=walls, first_call_s=t_first,
        attempts_mean=float(att.mean()), attempts_max=int(att.max()),
        unfinished=unfinished, finite=bool(torch.isfinite(ys).all()),
        max_rel_err=float(rel.max()), mean_rel_err=float(rel.mean()),
        acc_B=ACC_B, ns_fused_step_launches=cuda_ns.LAUNCHES["ns_fused_step"],
        jacobian_refreshes=int(st.n_jev) - 1, cold_rescues=int(st.n_rescue),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_n1: no CUDA device; this script "
                         "measures the card")
    sys.path.insert(0, ROOT)
    from chip_smoke import header
    from rmt_tpu_torch.cases.dme_case import make_model_input

    args = sys.argv[1:]
    bs = [int(a) for a in args if not a.startswith("-")] or [4096]
    process = "iso-thermal" if "--iso" in args else "non-iso-thermal"
    mi = make_model_input(model="N1", process_type=process)
    name = header(torch)
    t0 = time.perf_counter()
    ref = scipy_reference(mi, PROBES)
    print(f"scipy reference (CPU, float64): {time.perf_counter() - t0:.1f} s",
          flush=True)
    ok = True
    for b in bs:
        r = bench(torch, mi, b, ref, torch.device("cuda:0"))
        r.update(process=process, card=name,
                 device=torch.cuda.get_device_name(0))
        print(f"N1 {process} B={b} n={r['n']}: {r['members_per_sec']:.3f} "
              f"members/s (best of walls {r['walls_s']}), first call "
              f"{r['first_call_s']:.3f} s, attempts mean "
              f"{r['attempts_mean']:.1f} max {r['attempts_max']}, unfinished "
              f"{r['unfinished']}, max_rel_err {r['max_rel_err']:.4e} mean "
              f"{r['mean_rel_err']:.4e} ({ACC_B} probes, bar {BAR:g}), "
              f"ns_fused_step launches {r['ns_fused_step_launches']}, peak "
              f"{r['peak_gib']:.3f} GiB, on {name}", flush=True)
        print(json.dumps(r), flush=True)
        ok &= (r["unfinished"] == 0 and r["finite"]
               and r["max_rel_err"] <= BAR)
    if not ok:
        raise SystemExit("bench_torch_n1: FAILED (unfinished members, "
                         "non-finite states or max_rel_err over the bar)")


if __name__ == "__main__":
    main()
