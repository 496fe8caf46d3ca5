#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, nvcc under
/usr/local/cuda (or on PATH) and PyTorch built for CUDA. It never falls
back to the CPU: without a card it exits nonzero and prints no result.

Phases (any failure ends the run with a nonzero exit and no "ok" line):
  0. header: the card's name and power limit, torch/CUDA versions, and
     both TF32 switches off;
  1. build: nvcc builds the block kernels (csrc/block.cu) and the fused
     N2 RHS kernels generated for the DME chemistry (plain and df32), all
     at once, into build/;
  2. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (B = 4096 members, z = 20 nodes, m = 7 variables; the
     RHS at M = B and M = 3B rows), each timed with CUDA events (median
     of 25 samples of 5 back-to-back calls);
  3. the f32x DME sweep (bench.py's headline leg) at B = 4096 through
     rmt_tpu_torch.parallel.run_n2_ensemble_lockstep, with the 64 probe
     temperatures of bench_ref.npz spliced into the sweep, run twice (the
     first run pays the one-time CUDA set-up, the second is timed): every
     member must finish, every state be finite, the probes' max relative
     error against the CPU-float64 reference stay <= 1e-6, and every
     kernel of the path must have launched in the timed run (counts reset
     just before it).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

B = 4096
SEED = 0
REPS = 25
GROUP = 5
# bench.py's f32x leg (LEGS["f32x"])
F32X = dict(rtol=6e-7, atol=1e-9, max_steps=768, newton_iters=5, j_every=8,
            accurate_rates="df32", exact_solve=True, cheap_sweeps=2)


def say(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def header(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(f"nvidia-smi: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    check(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    return card


def time_ms(torch, fn):
    """Median over REPS samples of the per-call milliseconds of GROUP
    back-to-back calls between two CUDA events, after two warm-up calls
    (back to back, so a kernel's time is not the host's launch gap)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(GROUP):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GROUP)
    return statistics.median(times)


def rel_err(got, want, floor):
    """max |got - want| / (|want| + floor) and max |got - want|."""
    d = (got.double() - want.double()).abs()
    return float((d / (want.double().abs() + floor)).max()), float(d.max())


def block_phase(torch, np, cuda_block, tableau, dev):
    """The three block kernels against their twins on random stiff
    block-bidiagonal systems (the inputs of tests/test_pallas_block.py)."""
    _, A_np, _, _, w, T, Tinv = tableau
    gamma, mu_r, mu_i = float(w[0].real), float(w[1].real), float(w[1].imag)
    coef = cuda_block.apply_coefficients(gamma, mu_r, mu_i, T, Tinv)
    z, m = 20, 7
    n = m * z
    rng = np.random.default_rng(SEED)
    Jd = (5.0 * rng.standard_normal((B, z, m, m))).astype(np.float32)
    Jl = (2.0 * rng.standard_normal((B, z, m, m))).astype(np.float32)
    Jl[:, 0] = 0
    h = (10 ** rng.uniform(-3, -1.5, B)).astype(np.float32)
    R = rng.standard_normal((B, 3, n)).astype(np.float32)
    e = rng.standard_normal((B, n)).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device=dev)
    Jd_t = on(Jd.transpose(1, 2, 3, 0)).contiguous()
    Jl_t = on(Jl.transpose(1, 2, 3, 0)).contiguous()
    h_t = on(h)
    R_t = on(R.reshape(B, 3, m, z).transpose(1, 2, 3, 0)).contiguous()
    e_t = on(e.reshape(B, m, z).transpose(1, 2, 0)).contiguous()
    kw = dict(gamma=gamma, mu_r=mu_r, mu_i=mu_i)

    fk = cuda_block.block_factor(Jd_t, h_t, **kw)
    ft = cuda_block.block_factor_twin(Jd_t, h_t, gamma, mu_r, mu_i)
    dk_k = cuda_block.block_apply(R_t, *fk, Jl_t, h_t, coef=coef)
    dk_t = cuda_block.block_apply_twin(R_t, *ft, Jl_t, h_t, coef)
    x_k = cuda_block.block_apply_real(e_t, fk[0], Jl_t, h_t, gamma=gamma)
    x_t = cuda_block.block_apply_real_twin(e_t, ft[0], Jl_t, h_t, gamma)
    # the factor is held through its apply: the twin apply of the kernel's
    # factors against the all-twin chain
    dk_kt = cuda_block.block_apply_twin(R_t, *fk, Jl_t, h_t, coef)
    torch.cuda.synchronize()

    # bars of tests/test_pallas_block.py: 5e-4 for the stage solve (the
    # complex recurrence compounds f32 rounding over 20 nodes), 5e-5 for
    # the real solve; the floor 1e-3 keeps near-zero entries meaningful
    rel_f, _ = rel_err(dk_kt, dk_t, 1e-3)
    abs_f = max(float((a - b).abs().max()) for a, b in zip(fk, ft))
    rel_a, abs_a = rel_err(dk_k, dk_t, 1e-3)
    rel_r, abs_r = rel_err(x_k, x_t, 1e-3)
    say(f"block_factor: max_abs_err {abs_f:.3e}; through its apply rel "
        f"{rel_f:.3e} (bar 5e-4)")
    say(f"block_apply: rel {rel_a:.3e} (bar 5e-4), abs {abs_a:.3e}")
    say(f"block_apply_real: rel {rel_r:.3e} (bar 5e-5), abs {abs_r:.3e}")
    check(rel_f < 5e-4, f"block_factor through its apply rel {rel_f}")
    check(rel_a < 5e-4, f"block_apply rel {rel_a}")
    check(rel_r < 5e-5, f"block_apply_real rel {rel_r}")
    # and bit for bit: kernel and twin run the same f32 operations in the
    # same order, and nvcc builds with -fmad=false, so no product is fused
    # into a sum; a difference means the kernel computes something else
    for name, err in (("block_factor", abs_f), ("block_apply", abs_a),
                      ("block_apply_real", abs_r)):
        check(err == 0.0, f"{name} differs from its twin by {err}")

    # the kernel's stage solve is exact: M dK = R with the dense Kronecker
    # operator M = I - h A (x) J, in float64, for a few members
    dK = dk_k.permute(3, 0, 1, 2).reshape(B, 3, n).double().cpu().numpy()
    worst = 0.0
    for b in range(0, B, B // 8):
        J = np.zeros((n, n))
        for zi in range(z):
            rows = np.arange(m) * z + zi
            J[np.ix_(rows, rows)] = Jd[b, zi]
            if zi > 0:
                J[np.ix_(rows, rows - 1)] = Jl[b, zi]
        M = np.eye(3 * n) - float(h[b]) * np.kron(A_np, J)
        res = M @ dK[b].reshape(-1) - R[b].astype(np.float64).reshape(-1)
        worst = max(worst, np.abs(res).max() / (np.abs(R[b]).max() + 1.0))
    say(f"block_apply: Kronecker residual {worst:.3e} (bar 5e-4)")
    check(worst < 5e-4, f"block_apply Kronecker residual {worst}")

    res = {}
    res["block_factor"] = dict(
        max_abs_err=abs_f,
        ms=time_ms(torch, lambda: cuda_block.block_factor(Jd_t, h_t, **kw)),
        plain_ms=time_ms(torch, lambda: cuda_block.block_factor_twin(
            Jd_t, h_t, gamma, mu_r, mu_i)))
    res["block_apply"] = dict(
        max_abs_err=abs_a,
        ms=time_ms(torch, lambda: cuda_block.block_apply(
            R_t, *fk, Jl_t, h_t, coef=coef)),
        plain_ms=time_ms(torch, lambda: cuda_block.block_apply_twin(
            R_t, *ft, Jl_t, h_t, coef)))
    res["block_apply_real"] = dict(
        max_abs_err=abs_r,
        ms=time_ms(torch, lambda: cuda_block.block_apply_real(
            e_t, fk[0], Jl_t, h_t, gamma=gamma)),
        plain_ms=time_ms(torch, lambda: cuda_block.block_apply_real_twin(
            e_t, ft[0], Jl_t, h_t, gamma)))
    return res


def scaled_err(got, want):
    """max |got - want| / max(|want|, 1e-3 max|want|), in float64."""
    want = want.double()
    d = (got.double() - want).abs()
    scale = want.abs().clamp(min=1e-3 * float(want.abs().max()))
    return float((d / scale).max()), float(d.max())


def rhs_phase(torch, np, cuda_rhs, rhs_fns, ens, rhs64):
    """Both fused RHS kernels against their twin at M = B and M = 3B, on a
    perturbed DME state (the input of tests/test_fused_rhs.py), and the
    df32 kernel against the plain one on distance to the float64 RHS."""
    rng = np.random.default_rng(SEED)
    pert = 1.0 + 0.05 * rng.uniform(size=tuple(ens.y0.shape))
    y = (ens.y0.double() * torch.as_tensor(pert, device=ens.y0.device)).to(
        torch.float32)
    y3 = torch.cat([y, y * 1.01, y * 0.99], dim=0)
    ref64 = rhs64(y)
    res, err64 = {}, {}
    for mode, rhs_f in rhs_fns.items():
        df32_mode = mode == "df32"
        worst, worst_abs = 0.0, 0.0
        for yy in (y, y3):
            got = rhs_f(yy, ens.leaves1, ens.leaves2)
            want = cuda_rhs.n2_rhs_twin(ens.spec, df32_mode, ens.ko_keys, yy,
                                        ens.leaves1, ens.leaves2)
            torch.cuda.synchronize()
            rel, dmax = scaled_err(got, want)
            worst, worst_abs = max(worst, rel), max(worst_abs, dmax)
        name = rhs_f.kernel_name
        err64[name] = scaled_err(rhs_f(y, ens.leaves1, ens.leaves2), ref64)[0]
        # bar of tests/test_fused_rhs.py: a few f32 ulps through the
        # ~1e3-amplifying kinetics cancellation (libm and prefix order)
        say(f"{name}: rel {worst:.3e} (bar 5e-5), abs {worst_abs:.3e} "
            f"at M = B and 3B; against float64 {err64[name]:.3e}")
        check(worst < 5e-5, f"{name} rel {worst}")
        # and bit for bit: the twin runs the kernel's operations in its
        # order, nvcc builds with -fmad=false and libm calls are the same
        # device functions; an error-free transform of the df32 chain
        # contracted into an FMA, or a step left in plain f32, moves the
        # result by about an f32 ulp, far inside the 5e-5 bar, but not here
        check(worst_abs == 0.0,
              f"{name} differs from its twin by {worst_abs}")
        res[name] = dict(
            max_abs_err=worst_abs,
            ms=time_ms(torch, lambda: rhs_f(y3, ens.leaves1, ens.leaves2)),
            plain_ms=time_ms(torch, lambda: cuda_rhs.n2_rhs_twin(
                ens.spec, df32_mode, ens.ko_keys, y3, ens.leaves1,
                ens.leaves2)))
    # the twin could share a fault with the kernel, so the df32 mode is
    # also held to what it is for: on this input its error against the
    # float64 RHS is about a fifth of the plain mode's (a CPU run of the
    # twins at B = 64 gives 9.2e-7 against 4.4e-6); a df32 chain that has
    # lost its low words lands back at the plain mode's error
    e_df, e_pl = err64["n2_rhs_df32"], err64["n2_rhs_plain"]
    say(f"n2_rhs: against float64, df32 {e_df:.3e} vs plain {e_pl:.3e} "
        f"(bar: df32 <= plain / 2)")
    check(e_df <= 0.5 * e_pl, f"df32 RHS error {e_df} not under half the "
          f"plain RHS error {e_pl}")
    return res


def sweep_phase(torch, np, mi, run, counts, dev):
    """bench.py's f32x leg at B = 4096 with the 64 reference probes
    spliced in (bench.py:_probe_layout), probes recorded (out_members).
    It runs twice: the first run pays the process's one-time CUDA and
    library set-up; the second is the timed one, and the kernel launch
    counts are reset just before it and read just after it."""
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        offsets, ref_ys, t_base = (z["dme_offsets"], z["dme_ys"],
                                   float(z["dme_t_base"]))
    sweep = np.linspace(-5.0, 5.0, B)
    idx = np.round(np.linspace(0, B - 1, len(offsets))).astype(int)
    sweep[idx] = offsets

    def integrate(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys_sel, y_fin, stats = run(mi, {"T0": t_base + sweep},
                                   out_members=idx, device=dev, **F32X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_seg = ys_sel.shape[0] - 1
        unfinished = int(torch.sum(stats.seg < n_seg))
        att = (stats.n_accepted + stats.n_rejected).cpu().numpy()
        got = ys_sel.double().cpu().numpy()
        rel = np.abs(got - ref_ys) / np.maximum(np.abs(ref_ys), 1e-7)
        say(f"sweep ({label}): B {B}, wall {wall:.3f} s, members/s "
            f"{B / wall:.3f}")
        say(f"sweep ({label}): attempts mean {att.mean():.1f} max "
            f"{int(att.max())}; unfinished {unfinished}")
        say(f"sweep ({label}): max_rel_err {rel.max():.4e} mean_rel_err "
            f"{rel.mean():.4e} over {len(idx)} probes (bar 1e-6)")
        check(unfinished == 0,
              f"{unfinished}/{B} members exhausted the budget")
        check(bool(torch.isfinite(y_fin).all()), "non-finite final states")
        check(tuple(y_fin.shape) == (B, ref_ys.shape[2]), "final state shape")
        check(rel.max() <= 1e-6, f"max_rel_err {rel.max()} > 1e-6")
        return stats

    integrate("first run")
    for table in counts:
        for k in table:
            table[k] = 0
    stats = integrate("timed run")
    launches = {k: v for table in counts for k, v in table.items()}
    n_attempt_calls = (stats.n_jev - 1) * F32X["j_every"]
    say(f"sweep: lockstep attempt calls {n_attempt_calls}")
    for k, v in launches.items():
        say(f"sweep: launches {k} {v}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched by the sweep")
    check(launches["block_factor"] == n_attempt_calls,
          "block_factor did not run once per attempt")
    return launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a card")
    sys.path.insert(0, ROOT)
    from torch.func import vmap

    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.models import homo
    from rmt_tpu_torch.ops import _build, cuda_block, cuda_rhs
    from rmt_tpu_torch.parallel import (prepare_n2_ensemble,
                                        run_n2_ensemble_lockstep)
    from rmt_tpu_torch.parallel.ensemble import _cast
    from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

    dev = torch.device("cuda:0")
    card = header(torch)

    mi = make_model_input(model="N2")
    ens = prepare_n2_ensemble(mi, {"T0": 523.0 + np.linspace(-5.0, 5.0, B)},
                              device=dev)
    rhs_fns = {
        mode: cuda_rhs.build_n2_fused(ens.spec, accurate_rates=mode,
                                      ko_keys=ens.ko_keys)
        for mode in (False, "df32")}
    t0 = time.perf_counter()
    _build.compile_sources(
        [("block", (_build.CSRC / "block.cu").read_text())]
        + [(f.kernel_name, f.source()) for f in rhs_fns.values()])
    say(f"build: {time.perf_counter() - t0:.1f} s (nvcc, all sources at "
        f"once, into {_build.build_dir()})")

    res = block_phase(torch, np, cuda_block, _transformed_tableau(), dev)
    f64 = torch.float64
    rhs64_b = vmap(homo.make_n2_rhs(ens.spec), in_dims=(None, 0, ens.axes, 0))
    p64, d64 = _cast(ens.params, f64), _cast(ens.d, f64)
    res.update(rhs_phase(torch, np, cuda_rhs, rhs_fns, ens,
                         lambda y: rhs64_b(0.0, y.to(f64), p64, d64)))
    for k, v in res.items():
        say(f"time {k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} "
            f"ms (median of {REPS} x {GROUP} calls) on {card}")

    launches = sweep_phase(torch, np, mi, run_n2_ensemble_lockstep,
                           (cuda_block.LAUNCHES, cuda_rhs.LAUNCHES), dev)

    sources = {
        "block_factor": ("rmt_tpu_torch/csrc/block.cu",
                         "rmt_tpu/ops/pallas_block.py:278"),
        "block_apply": ("rmt_tpu_torch/csrc/block.cu",
                        "rmt_tpu/ops/pallas_block.py:324"),
        "block_apply_real": ("rmt_tpu_torch/csrc/block.cu",
                             "rmt_tpu/ops/pallas_block.py:355"),
        "n2_rhs_plain": ("rmt_tpu_torch/ops/cuda_rhs.py",
                         "rmt_tpu/ops/pallas_rhs.py:340"),
        "n2_rhs_df32": ("rmt_tpu_torch/ops/cuda_rhs.py",
                        "rmt_tpu/ops/pallas_rhs.py:340"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], **res[k])
               for k, (src, rep) in sources.items()]
    say(json.dumps({"kernels": kernels}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
