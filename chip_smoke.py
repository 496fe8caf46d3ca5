#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, nvcc under
/usr/local/cuda (or on PATH) and PyTorch built for CUDA. It never falls
back to the CPU: without a card it exits nonzero and prints no result.

Phases (any failure ends the run with a nonzero exit and no "ok" line):
  0. header: the card's name and power limit, torch/CUDA versions, and
     both TF32 switches off;
  1. build: nvcc builds the block kernels (csrc/block.cu), the
     Newton-Schulz kernel (csrc/ns.cu) and the fused N2 RHS kernels
     generated for the DME and the CH4 chemistry (plain, df32 and the
     plain mode's accurate-f32-math variant each; and the DME RHS at the
     grids of phases 10 and 15), all at once, into build/, and prints
     each kernel's registers, spills and static shared memory;
  2. each kernel against its plain PyTorch twin on the card, at the main
     paths' shapes (B = 4096 members, z = 20 nodes, m = 7 variables, n =
     140; the RHS at M = B and M = 3B rows), each timed with CUDA events
     (median of 25 samples of 5 back-to-back calls) beside its twin, its
     roofline bound and, where one PyTorch call computes the same
     function, that call (the accurate-math RHS variant as the plain one,
     against its twin with the DSL's accurate-f32 switch on); each kernel
     also timed with its samples queued behind a sleep of the card
     (card_ms: the card's work alone), and the wrapper's host time a call
     (host_ms). The block and RHS kernels equal their twins bit for bit,
     also at a ragged member count (B = 100; the RHS of both chemistries
     at M = 300 rows), for block_factor also with steps 1000 times longer
     (inversions that pivot) and, for the RHS, on a state that is not
     16-byte aligned (the kernel's 4-byte copies); each RHS result must be
     a contiguous row-major (M, n) tensor; the Newton-Schulz kernel (dense
     float32 products against cuBLAS) is held to 2e-5, and to a float64
     evaluation, at n = 140, 24, 30, 80 and 100; its wide route
     (csrc/ns_wide.cu, the members wider than 160) to 2e-5 at n = 161,
     200, 210, 420, 301, 1000 and 1584 (its limit), at a ragged B = 100 (n
     = 210) and on operands not 16-byte aligned (n = 210, 420), bit for
     bit on a repeat, and at the f32_wide phase's shape (B = 256, n = 210,
     J the zNo-30 DME Jacobians) also to a float64 evaluation, timed there
     and at n = 420 (B = 64), its geometry and resident blocks recorded;
     it is also held to 2e-5 at the N1 shapes (B = 4096; n = 8, and n = 7
     of the iso-thermal process; J the N1 Jacobians at the sweep's inlet)
     and timed at n = 8 beside its twin, three torch.bmm and its bound;
     the three block kernels equal their twins bit for bit at M2's shape
     (m = 7, z = 100) for B = 1 and B = 33;
  3. the f32x DME sweep (bench.py's headline leg: df32 kinetics, exact
     block solves) at B = 4096 through
     rmt_tpu_torch.parallel.run_n2_ensemble_lockstep, with the 64 probe
     temperatures of bench_ref.npz spliced into the sweep, run twice (the
     first run pays the one-time CUDA set-up, the second is timed): every
     member must finish, every state be finite, the probes' max relative
     error against the CPU-float64 reference stay <= 1e-6, and every
     kernel of the path must have launched in the timed run (counts reset
     just before it);
  4. the f32 DME sweep (bench.py's f32 leg: plain float32, Newton-Schulz
     preconditioners) the same way, under a 5e-5 bar that guards against
     a broken solve (bench.py sets no accuracy bar for this leg);
  5. the CH4 second-chemistry guard: the f32x options on the CH4 case at
     its 16 probe temperatures, <= 1e-6;
  6. the N1 steady sweep of scripts/bench_torch_n1.py: B = 4096 members
     (inlet temperature 523 +- 5 K) in float32 with dense output and the
     Newton-Schulz preconditioners (ns_fused_step at n = 8) from the
     integrator's default Jacobian: every member must finish, every state
     be finite, the 8 probes stay <= 5e-5 against float64 trajectories by
     scipy's Radau (rtol 1e-10) on the port's N1 RHS, computed on the CPU
     by a child process that starts with the script, and ns_fused_step
     must launch as often as the chunks, refreshes and rescues say;
  7. microbatch: the f32x options at B = 512 with microbatch=256 equal,
     member by member and bit for bit, two separate calls of 256;
  8. seq, the sequential float64 path (rmt_tpu_torch.solvers.radau,
     dopri5, fixed; scripts/bench_torch_seq.py's checks), in a child
     process with phase 9, which launches none of the kernels (counts
     reset just before it, all 0 after it):
     rmtExe N2 (DME, solver defaults) at the first probe temperature of
     bench_ref.npz, its states rebuilt from dataPack and checkpoint and
     held to that probe at 1e-6; rmtExe N1 at 518 K held to the child's
     scipy reference at 1e-5; run_n2_ensemble over the 64 DME probes held
     to bench_ref.npz at 1e-6 with every member's n_unreached 0, and
     probe 0 alone (B = 1) held to its B = 64 row at 1e-10; Dopri5, RK4,
     AB3 and PreCorr3 on Lotka-Volterra with per-member parameters at
     B = 4096 held to the same calls on the CPU at 1e-12, Dopri5 on
     exponential decay held to exp at 1e-7, and rmtExe N1 with ivp "AM"
     must raise (the fixed stepper diverges, as in rmt_tpu);
  9. est, adjoint-gradient estimation (BASELINE config #5;
     rmt_tpu_torch.parallel.estimation on solvers/implicit_diff.py, float64,
     scripts/bench_torch_estimation.py's configuration: N2 DME, period
     0.5 s, zNo 8, 12 fixed Radau steps, T0 = 523 + linspace(-4, 4, B),
     the constants K1-K3 at 523 K, uniform targets), which launches none
     of the kernels (counts reset just before it, all 0 after it): a
     warm-up and a timed step at B = 512 (wall, members/s forward and
     adjoint, peak memory; loss and gradients finite); a B = 8 step at
     every 73rd of those members, whose outlet mole fractions equal the
     B = 512 rows at 1e-10, whose loss and theta_new equal the same step
     on the CPU at 1e-9, and whose loss, gradients and outlet fractions
     equal estimation_ref.npz (rmt_tpu, CPU float64) at 1e-8; the
     adjoint gradient in K1 of one member against central differences
     (eps 1e-4, bar 2e-4); Newton's root_batched on 4096 independent
     cubic systems with per-member parameters and a closed-form root, to
     a residual of 1e-12 (every member converged, 1e-10 from the root
     relative to max(|root|, 1); the same call on the CPU gives equal
     iteration counts and states within 1e-12) and root on one member;
 10. f32_wide: the f32 DME leg at zNo 30 (n = 210: ns_fused_step's wide
     route) at F32_WIDE_B members, T0 = 523 + linspace(-5, 5, B), against
     the f32x leg at the same zNo and members (the block kernels at
     z = 30): every member of both finishes, every state is finite, the
     f32 states stay within 5e-5 of the f32x states (the f32 guard's
     bar), and each leg's kernels launch as its chunks say (counts reset
     just before each leg);
 11. models, rmtExe of the packed-bed, plug-flow and batch models on the
     card (rmt_tpu_torch/cases/pb_case.py's inputs) against
     models_ref.npz (rmt_tpu, CPU float64): M0, M1, M3, M4, M7 and M8 in
     a child process (the sequential Radau integrator is the host's
     work), each within 1e-6 relative; M2 at the
     default grid (zNo 100, tNo 10, n = 700: the lockstep integrator at
     B = 1 in block mode, its blocks from the dense colored Jacobian) in
     this process within 1e-5 relative, its attempts within 1.25 times
     the reference's, the three block kernels launched as its chunks say
     and no other kernel (counts reset just before it); M9's RHS and
     frozen-march Jacobian blocks on the card against the CPU at 1e-12
     (rmt_tpu's own M9 run exhausts its attempt budget, so M9 is not
     integrated here);
 12. steady_het, the particle, axial-dispersion and steady heterogeneous
     models (rmt_tpu_torch/cases/hetero_case.py's inputs), which launch
     none of the kernels: rmtExe T1 (FDM, rNo 7, period 5 s), T2 by FDM,
     OC and OCFE, T3 (zNo 10), M5 and M14 (zNo 30) in a child process
     (the host's work), each within 1e-6 relative
     of models_ref.npz (rmt_tpu, CPU float64), T1's checkpoint state too
     and its attempts within 1.25 times the reference's (the M2 bar),
     and no kernel launched in the child; then, in the same child,
     run_m14_sweep at
     M14_SWEEP_B members (zNo 30, n = 420, T0 = 523 + linspace(0, 20, B)
     with models_ref.npz's three inlet temperatures at members 0, B // 2
     and B - 1; wall split into the pseudo-transient continuation and the
     Newton polish, members/s, peak device memory): every member
     converged and finite, those three members within 1e-6 of
     models_ref.npz, member 0 within 1e-6 of the child's rmtExe M14 on the
     card; counts reset just before the phase, all 0 after it;
 13. dyn_het, the dynamic heterogeneous models
     (rmt_tpu_torch/cases/hetero_case.py's dyn_model_input), which launch
     none of the kernels, in four children (DYN_CHILDREN): rmtExe M10
     (zNo 10, tNo 2, 0.02 s), M11 and M13 (zNo 10, rNo 7, tNo 5, 5 s:
     n = 560 and the split driver) and M12 (zNo 10, tNo 2, 4e-3 s from
     the physical startup state), every dataPack row and checkpoint
     within 1e-6 of models_ref.npz (rmt_tpu, CPU float64) as |d| /
     (|ref| + 1e-3) (bench_torch_seq.DYN_FLOOR says why; the floor-1e-7
     error and the absolute one printed beside it), M10-M12's Radau
     attempts within 1.25 times the reference's; M13 on rmt_tpu's
     tests/test_m13.py grid (zNo 8, rNo 5) over two chained 1.25 s runs
     against one 2.5 s run of two intervals, within 1e-6; the M13
     lockstep sweep at M13_SWEEP_B members (T0 = 523 + linspace(0, 8, B),
     models_ref.npz's three inlet temperatures at members 0, B // 2 and
     B - 1: every member converged, none with an unreached output time,
     those three within rtol 2e-4, atol 1e-8 of rmt_tpu's lockstep
     engine, the gap printed) and run_m11_sweep at M11_SWEEP_B members
     (member 0 within 1e-6 of the child's rmtExe M11), each with its
     wall, members/s, peak device memory (and the M13 sweep's rescued
     intervals); no kernel launched in any child; counts reset just
     before the phase, all 0 after it;
 14. n2_opts, the rest of rmt_tpu's N2 ensemble options at the 64 DME
     probe temperatures of bench_ref.npz (B = 64, zNo 20; the
     accurate-math pair at phase 4's B = 4096 with the probes spliced
     in), each check held to the probes with the launch counts reset just
     before it,
     every member finished and every state finite: bench.py's f64 leg
     (dtype float64, Newton-Schulz; bar 1e-6; ns_fused_step),
     accurate_rates=True (f32x options; 1e-6; the block kernels and the
     plain RHS kernel of the cheap sweeps), accurate_rates="full" (3e-6,
     twice rmt_tpu's own error in that mode, FULL_BAR; the block kernels,
     no RHS kernel), batched_rhs=True (f32 options, the member-last
     plain RHS; 5e-5; ns_fused_step, no RHS kernel), fused_rhs=False
     (f32x; 1e-6; block kernels), colored_jacobian=False (f32 options;
     5e-5; ns_fused_step and the plain RHS kernel) and the f32 options
     with the DSL's accurate-f32 switch on (5e-5; ns_fused_step and the
     RHS kernel's accurate-math variant) and off, both errors printed;
 15. mesh, rmt_tpu's dp mesh (rmt_tpu_torch/parallel/mesh.py,
     dryrun.py), in child processes that load the kernels phase 1 built:
     (a) phase 3's f32x sweep with mesh= over MESH_RANKS gloo ranks
     sharing the card (twice, the second timed, its members/s printed
     beside phase 3's): rank 0's gathered probes, final states,
     per-member statistics and counters equal phase 3's timed run bit for
     bit; (b) phase 4's f32 sweep over the same ranks against phase 4's
     timed run: bit for bit with equal counters, or, where the members'
     bits depend on the batch's size (the largest difference and its
     member printed), bit for bit equal to separate calls on the ranks'
     blocks with n_jev the slowest block's, the final states within 5e-5
     of the unsharded run and the probes within 5e-5; (c)
     dryrun_multichip (the three phases of __graft_entry__.py's
     multichip dry run) over MESH_RANKS gloo ranks and over one NCCL
     rank at once, their ranks started after phase 4, each estimation
     step's loss and gradient within 1e-12 of the same step on this
     process; every rank's kernel launches held
     by check_launches (the dry runs' estimation and M13 phases launch
     none), every rank's gathered results equal to rank 0's.

Order: phases 0-4 run alone on the card. Then the children start: phases
8 and 9, phase 11's steady models, phase 12, phase 13 (four children)
and phase 15's dry runs, while this process runs
phases 5, 6, 7, 10, 11 (M2, M9), phase 15's own runs (check (b)'s
separate calls, the dry runs' estimation step) and 14; then it reads the
children's results (8 and 9, 11, 12, 13) and runs phase 15's ranks'
sweeps alone on the card. The card interleaves the processes' launches, so the walls of
phases 5-14 are taken beside one another.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

B = 4096
# a member count that is a multiple of no kernel's tile (the RHS at M = 3
# x RAGGED_B rows)
RAGGED_B = 100
SEED = 0
REPS = 25
GROUP = 5
# about 1 ms of the card's clock: the host queues GROUP calls meanwhile
SLEEP_CYCLES = 2_000_000
# bench.py's f32x leg (LEGS["f32x"])
F32X = dict(rtol=6e-7, atol=1e-9, max_steps=768, newton_iters=5, j_every=8,
            accurate_rates="df32", exact_solve=True, cheap_sweeps=2)
# bench.py's f32 leg (LEGS["f32"]), with the integrator's Newton-Schulz
# defaults spelled out for the launch count
F32 = dict(rtol=1e-5, atol=1e-7, max_steps=768, newton_iters=5, j_every=8,
           ns_refresh=5, ns_step=1)
# bench.py's opt-in f64 leg (LEGS["f64"]: the integrator's defaults spelled
# out), with dtype=torch.float64
F64 = dict(rtol=1e-7, atol=1e-10, max_steps=768, newton_iters=6,
           j_every=16, ns_refresh=5, ns_step=1)
# the card's published peaks (H100 SXM): device memory and float32 outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
F32X_KERNELS = ("block_factor", "block_apply", "block_apply_real",
                "n2_rhs_df32", "n2_rhs_plain")
F32_KERNELS = ("ns_fused_step", "n2_rhs_plain")
N1_KERNELS = ("ns_fused_step",)
# the f32_wide phase: both DME legs at zNo WIDE_Z (n = 210) and
# F32_WIDE_B members; the f32 leg's Newton-Schulz steps take the wide route
WIDE_Z, F32_WIDE_B = 30, 256
F32_WIDE_KERNELS = ("ns_fused_step_wide", "n2_rhs_plain")
# the n2_opts phase: accurate_rates="full" at the f32x options. rmt_tpu's
# own run of the 64 probes errs by 1.50e-6 in that mode (and by 2.78e-6
# in df32 mode, 6.67e-7 with accurate_rates=True; CPU,
# scripts/jax_n2_modes_error.py): at rtol 6e-7 a float32 run's whole-run
# error lands anywhere in that span with its step sequence, so the check
# holds the mode to twice the reference's own error
FULL_BAR = 3e-6
# the models phase: rmtExe M2's stage solves
M2_KERNELS = ("block_factor", "block_apply", "block_apply_real")
BLOCK_KERNELS = M2_KERNELS
# the steady_het phase: run_m14_sweep at M14_SWEEP_B members
M14_SWEEP_B = 64
# the dyn_het phase: the M13 lockstep sweep and run_m11_sweep
M13_SWEEP_B, M11_SWEEP_B = 64, 8
# the microbatch check: MICRO_B members in slices of MICROBATCH
MICRO_B, MICROBATCH = 512, 256
# the seq phase: explicit steppers at SEQ_B members, STEPS fixed steps
SEQ_B, STEPS = 4096, 200
# the mesh phase: phase 3's f32x sweep and phase 4's f32 sweep over
# MESH_RANKS gloo ranks sharing the card
MESH_RANKS = 2
# the est phase: the estimation step at EST_B members, held to its B =
# EST_REF_B run (members EST_B // (EST_REF_B - 1) apart: the same inlet
# temperatures) and to estimation_ref.npz; Newton at SEQ_B members of
# NEWTON_N unknowns
EST_B, EST_REF_B, NEWTON_N = 512, 8, 8


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


def _median_ms(torch, fn, sleep_cycles):
    """Median over REPS samples of the per-call milliseconds of GROUP
    back-to-back calls between two CUDA events, after two warm-up calls;
    each sample's calls queued behind sleep_cycles of the card's sleep."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(GROUP):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GROUP)
    return statistics.median(times)


def time_ms(torch, fn):
    """Median over REPS samples of the per-call milliseconds of GROUP
    back-to-back calls between two CUDA events, after two warm-up calls
    (back to back, so a kernel's time is not the host's launch gap). Where
    a wrapper's host time exceeds its kernel's, this measures the host."""
    return _median_ms(torch, fn, 0)


def card_time_ms(torch, fn):
    """time_ms with each sample's GROUP calls queued behind about 1 ms of
    the card's sleep (SLEEP_CYCLES), long enough for the host to queue
    them, so the events time the card's work and not the host's rate of
    launching it."""
    return _median_ms(torch, fn, SLEEP_CYCLES)


def host_ms(torch, fn, calls=50):
    """The host's milliseconds a call of fn: calls enqueued back to back,
    the clock stopped before the card is synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e3


def kernel_times(torch, fn, host_calls=50):
    """A kernel wrapper's three times: ms (time_ms), card_ms and host_ms."""
    return dict(ms=time_ms(torch, fn), card_ms=card_time_ms(torch, fn),
                host_ms=host_ms(torch, fn, host_calls))


def bound(n_bytes, n_ops):
    """The least time the card could take: each input read once and each
    output written once over the memory rate, or the operations over the
    float32 rate, whichever is larger."""
    t_b, t_o = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def rel_err(got, want, floor):
    """max |got - want| / (|want| + floor) and max |got - want|."""
    d = (got.double() - want.double()).abs()
    return float((d / (want.double().abs() + floor)).max()), float(d.max())


def block_inputs(torch, np, cuda_block, tableau, dev, m=7, B=B, z=20):
    """Random stiff block-bidiagonal systems (the inputs of
    tests/test_pallas_block.py) at B members, z nodes (20, the DME path's),
    m variables a node (7, the DME path's), in numpy and as the kernels'
    member-last tensors, with the Radau shifts and block_apply's
    constants."""
    _, A_np, _, _, w, T, Tinv = tableau
    gamma, mu_r, mu_i = float(w[0].real), float(w[1].real), float(w[1].imag)
    n = m * z
    rng = np.random.default_rng(SEED)
    Jd = (5.0 * rng.standard_normal((B, z, m, m))).astype(np.float32)
    Jl = (2.0 * rng.standard_normal((B, z, m, m))).astype(np.float32)
    Jl[:, 0] = 0
    h = (10 ** rng.uniform(-3, -1.5, B)).astype(np.float32)
    R = rng.standard_normal((B, 3, n)).astype(np.float32)
    e = rng.standard_normal((B, n)).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device=dev)
    return SimpleNamespace(
        A_np=A_np, z=z, m=m, n=n, Jd=Jd, Jl=Jl, h=h, R=R,
        kw=dict(gamma=gamma, mu_r=mu_r, mu_i=mu_i),
        coef=cuda_block.apply_coefficients(gamma, mu_r, mu_i, T, Tinv),
        Jd_t=on(Jd.transpose(1, 2, 3, 0)).contiguous(),
        Jl_t=on(Jl.transpose(1, 2, 3, 0)).contiguous(),
        h_t=on(h),
        R_t=on(R.reshape(B, 3, m, z).transpose(1, 2, 3, 0)).contiguous(),
        e_t=on(e.reshape(B, m, z).transpose(1, 2, 0)).contiguous())


def block_phase(torch, np, cuda_block, tableau, dev):
    """The three block kernels against their twins on block_inputs."""
    x = block_inputs(torch, np, cuda_block, tableau, dev)
    A_np, z, m, n = x.A_np, x.z, x.m, x.n
    Jd, Jl, h, R, kw, coef = x.Jd, x.Jl, x.h, x.R, x.kw, x.coef
    Jd_t, Jl_t, h_t, R_t, e_t = x.Jd_t, x.Jl_t, x.h_t, x.R_t, x.e_t
    gamma, mu_r, mu_i = kw["gamma"], kw["mu_r"], kw["mu_i"]
    on = lambda a: torch.as_tensor(a, device=dev)

    fk = cuda_block.block_factor(Jd_t, h_t, **kw)
    ft = cuda_block.block_factor_twin(Jd_t, h_t, gamma, mu_r, mu_i)
    dk_k = cuda_block.block_apply(R_t, *fk, Jl_t, h_t, coef=coef)
    dk_t = cuda_block.block_apply_twin(R_t, *ft, Jl_t, h_t, coef)
    x_k = cuda_block.block_apply_real(e_t, fk[0], Jl_t, h_t, gamma=gamma)
    x_t = cuda_block.block_apply_real_twin(e_t, ft[0], Jl_t, h_t, gamma)
    # the factor is held through its apply: the twin apply of the kernel's
    # factors against the all-twin chain
    dk_kt = cuda_block.block_apply_twin(R_t, *fk, Jl_t, h_t, coef)
    # a ragged member count: the first RAGGED_B members, a multiple of no
    # kernel's tile; and the factor at steps 1000 times longer, where the
    # shifted blocks are far from the identity and most inversions pivot
    cut = lambda t: t[..., :RAGGED_B].contiguous()
    Jd_r, Jl_r, h_r = cut(Jd_t), cut(Jl_t), cut(h_t)
    fk_r = cuda_block.block_factor(Jd_r, h_r, **kw)
    ft_r = cuda_block.block_factor_twin(Jd_r, h_r, gamma, mu_r, mu_i)
    fk_p = cuda_block.block_factor(Jd_r, h_r * 1000.0, **kw)
    ft_p = cuda_block.block_factor_twin(Jd_r, h_r * 1000.0, gamma, mu_r,
                                        mu_i)
    args_r = (cut(R_t), *map(cut, fk), Jl_r, h_r)
    dk_r = cuda_block.block_apply(*args_r, coef=coef)
    dk_rt = cuda_block.block_apply_twin(*args_r, coef)
    args_r = (cut(e_t), cut(fk[0]), Jl_r, h_r)
    x_r = cuda_block.block_apply_real(*args_r, gamma=gamma)
    x_rt = cuda_block.block_apply_real_twin(*args_r, gamma)
    # the CH4 guard's shape, m = 4 at B = 16: the kernels' m = 4
    # instances, which only that path runs; M2's, z = 100 at B = 1 (its
    # one member) and at B = 33 (a tile and one member)
    y = block_inputs(torch, np, cuda_block, tableau, dev, m=4, B=16)
    m2 = [block_inputs(torch, np, cuda_block, tableau, dev, B=b, z=100)
          for b in (1, 33)]
    ch4 = [(cuda_block.block_factor(y.Jd_t, y.h_t * s, **kw),
            cuda_block.block_factor_twin(y.Jd_t, y.h_t * s, gamma, mu_r,
                                         mu_i)) for s in (1.0, 1000.0)]
    fy = ch4[0][0]
    ch4.append((
        (cuda_block.block_apply(y.R_t, *fy, y.Jl_t, y.h_t, coef=coef),),
        (cuda_block.block_apply_twin(y.R_t, *fy, y.Jl_t, y.h_t, coef),)))
    ch4.append((
        (cuda_block.block_apply_real(y.e_t, fy[0], y.Jl_t, y.h_t,
                                     gamma=gamma),),
        (cuda_block.block_apply_real_twin(y.e_t, fy[0], y.Jl_t, y.h_t,
                                          gamma),)))
    torch.cuda.synchronize()

    # bars of tests/test_pallas_block.py: 5e-4 for the stage solve (the
    # complex recurrence compounds f32 rounding over 20 nodes), 5e-5 for
    # the real solve; the floor 1e-3 keeps near-zero entries meaningful
    rel_f, _ = rel_err(dk_kt, dk_t, 1e-3)
    abs_f = max(float((a - b).abs().max())
                for a, b in zip((*fk, *fk_r, *fk_p), (*ft, *ft_r, *ft_p)))
    rel_a, abs_a = rel_err(dk_k, dk_t, 1e-3)
    rel_r, abs_r = rel_err(x_k, x_t, 1e-3)
    say(f"block_factor: max_abs_err {abs_f:.3e} at B = {B}, {RAGGED_B} "
        f"(ragged) and {RAGGED_B} with h x 1000 (pivoting); through its "
        f"apply rel {rel_f:.3e} (bar 5e-4)")
    abs_a = max(abs_a, float((dk_r - dk_rt).abs().max()))
    say(f"block_apply: rel {rel_a:.3e} (bar 5e-4), abs {abs_a:.3e} at "
        f"B = {B} and {RAGGED_B} (ragged)")
    abs_r = max(abs_r, float((x_r - x_rt).abs().max()))
    say(f"block_apply_real: rel {rel_r:.3e} (bar 5e-5), abs {abs_r:.3e} at "
        f"B = {B} and {RAGGED_B} (ragged)")
    check(rel_f < 5e-4, f"block_factor through its apply rel {rel_f}")
    check(rel_a < 5e-4, f"block_apply rel {rel_a}")
    check(rel_r < 5e-5, f"block_apply_real rel {rel_r}")
    # and bit for bit: kernel and twin run the same f32 operations in the
    # same order, and nvcc builds with -fmad=false, so no product is fused
    # into a sum; a difference means the kernel computes something else
    for name, err in (("block_factor", abs_f), ("block_apply", abs_a),
                      ("block_apply_real", abs_r)):
        check(err == 0.0, f"{name} differs from its twin by {err}")
    for name, (got, want) in zip(
            ("block_factor", "block_factor (h x 1000)", "block_apply",
             "block_apply_real"), ch4):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        say(f"{name}: max_abs_err {err:.3e} at the CH4 shape (m = 4, "
            f"B = 16)")
        check(err == 0.0, f"{name} at m = 4 differs from its twin by {err}")
    for v in m2:
        b = v.h_t.shape[0]
        fk_m, ft_m = (cuda_block.block_factor(v.Jd_t, v.h_t, **kw),
                      cuda_block.block_factor_twin(v.Jd_t, v.h_t, gamma,
                                                   mu_r, mu_i))
        pairs = {
            "block_factor": (fk_m, ft_m),
            "block_apply": (
                (cuda_block.block_apply(v.R_t, *fk_m, v.Jl_t, v.h_t,
                                        coef=coef),),
                (cuda_block.block_apply_twin(v.R_t, *fk_m, v.Jl_t, v.h_t,
                                             coef),)),
            "block_apply_real": (
                (cuda_block.block_apply_real(v.e_t, fk_m[0], v.Jl_t, v.h_t,
                                             gamma=gamma),),
                (cuda_block.block_apply_real_twin(v.e_t, fk_m[0], v.Jl_t,
                                                  v.h_t, gamma),))}
        torch.cuda.synchronize()
        for name, (got, want) in pairs.items():
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            say(f"{name}: max_abs_err {err:.3e} at M2's shape (m = 7, "
                f"z = 100, B = {b})")
            check(err == 0.0, f"{name} at z = 100, B = {b} differs from its "
                  f"twin by {err}")

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

    # bounds: bytes of each operand once; operations of three in-place
    # Gauss-Jordan inversions (2m^3 - m^2 each: a column's m divisions and
    # (m - 1) x m multiply-subtract pairs), three m x m products (2m^3 -
    # m^2 each) and the shifted assemblies (9m^2) (factor), eight m x m
    # matvecs and the two 3 x 3 stage transforms per node (apply), two
    # matvecs per node (real)
    mat, vec = z * m * m * B * 4, m * z * B * 4
    # the library's part of block_factor: the real-shift inverses alone
    M_r = (torch.eye(m, device=dev) - (gamma * h_t)[:, None, None, None]
           * on(Jd)).reshape(B * z, m, m)
    res = {}
    res["block_factor"] = dict(
        max_abs_err=abs_f,
        **kernel_times(torch, lambda: cuda_block.block_factor(
            Jd_t, h_t, **kw)),
        plain_ms=time_ms(torch, lambda: cuda_block.block_factor_twin(
            Jd_t, h_t, gamma, mu_r, mu_i)),
        library_ms=time_ms(torch, lambda: torch.linalg.inv(M_r)),
        **bound(4 * mat + 4 * B, B * z * (12 * m ** 3 + 3 * m * m)))
    res["block_apply"] = dict(
        max_abs_err=abs_a,
        **kernel_times(torch, lambda: cuda_block.block_apply(
            R_t, *fk, Jl_t, h_t, coef=coef)),
        plain_ms=time_ms(torch, lambda: cuda_block.block_apply_twin(
            R_t, *ft, Jl_t, h_t, coef)),
        library_ms=None,
        **bound(4 * mat + 6 * vec + 4 * B,
                B * z * (16 * m * m + 12 * m + 30 * m)))
    res["block_apply_real"] = dict(
        max_abs_err=abs_r,
        **kernel_times(torch, lambda: cuda_block.block_apply_real(
            e_t, fk[0], Jl_t, h_t, gamma=gamma)),
        plain_ms=time_ms(torch, lambda: cuda_block.block_apply_real_twin(
            e_t, ft[0], Jl_t, h_t, gamma)),
        library_ms=None,
        **bound(2 * mat + 2 * vec + 4 * B, B * z * (4 * m * m + 2 * m)))
    return res


def scaled_err(got, want):
    """max |got - want| / max(|want|, 1e-3 max|want|), in float64."""
    want = want.double()
    d = (got.double() - want).abs()
    scale = want.abs().clamp(min=1e-3 * float(want.abs().max()))
    return float((d / scale).max()), float(d.max())


def perturbed_state(torch, np, ens):
    """The ensemble's initial states perturbed by up to 5% (the input of
    tests/test_fused_rhs.py), float32 (B, n)."""
    rng = np.random.default_rng(SEED)
    pert = 1.0 + 0.05 * rng.uniform(size=tuple(ens.y0.shape))
    return (ens.y0.double() * torch.as_tensor(
        pert, device=ens.y0.device)).to(torch.float32)


def ragged_rows(torch, y, ens):
    """(y, leaves1, leaves2) of RAGGED_B members (the ensemble's members
    repeated in order where it has fewer) stacked as three stages: M =
    300 rows, a multiple of neither RHS tile height."""
    idx = torch.arange(RAGGED_B, device=y.device) % y.shape[0]
    yb = y[idx]
    return (torch.cat([yb, yb * 1.01, yb * 0.99]).contiguous(),
            ens.leaves1[:, idx].contiguous(),
            ens.leaves2[:, :, idx].contiguous())


def misaligned(torch, t):
    """A contiguous copy of t that starts one float into a larger buffer:
    not 16-byte aligned, so the RHS wrapper takes its kernel's 4-byte
    copies."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    check(out.is_contiguous() and out.data_ptr() % 16 != 0,
          "the misaligned copy is 16-byte aligned")
    return out


def check_row_major(got, shape, name):
    """The RHS hands back a contiguous row-major (M, n) tensor."""
    check(tuple(got.shape) == tuple(shape) and got.is_contiguous()
          and got.stride() == (shape[1], 1),
          f"{name}: result of shape {tuple(got.shape)}, strides "
          f"{got.stride()} is not a contiguous row-major {tuple(shape)}")


def rhs_phase(torch, np, cuda_rhs, rhs_fns, ens, rhs64):
    """The fused RHS kernels (plain, df32 and the plain mode's
    accurate-math variant) against their twins at M = B, M = 3B (also
    from a start that is not 16-byte aligned) and the ragged M = 300, on
    a perturbed DME state (the input of tests/test_fused_rhs.py), each
    result a contiguous row-major tensor, and the df32 kernel against the
    plain one on distance to the float64 RHS."""
    y = perturbed_state(torch, np, ens)
    y3 = torch.cat([y, y * 1.01, y * 0.99], dim=0)
    ref64 = rhs64(y)
    res, err64 = {}, {}
    ragged = ragged_rows(torch, y, ens)
    for rhs_f in rhs_fns.values():
        worst, worst_abs = 0.0, 0.0
        for yy, l1, l2 in ((y, ens.leaves1, ens.leaves2),
                           (y3, ens.leaves1, ens.leaves2), ragged,
                           (misaligned(torch, y3), ens.leaves1,
                            ens.leaves2)):
            got = rhs_f(yy, l1, l2)
            want = rhs_f.twin(yy, l1, l2)
            torch.cuda.synchronize()
            check_row_major(got, yy.shape, rhs_f.kernel_name)
            rel, dmax = scaled_err(got, want)
            worst, worst_abs = max(worst, rel), max(worst_abs, dmax)
        name = rhs_f.kernel_name
        err64[name] = scaled_err(rhs_f(y, ens.leaves1, ens.leaves2), ref64)[0]
        # bar of tests/test_fused_rhs.py: a few f32 ulps through the
        # ~1e3-amplifying kinetics cancellation (libm and prefix order)
        say(f"{name}: rel {worst:.3e} (bar 5e-5), abs {worst_abs:.3e} "
            f"at M = B, 3B, {ragged[0].shape[0]} (ragged) and 3B not "
            f"16-byte aligned; against float64 {err64[name]:.3e}")
        check(worst < 5e-5, f"{name} rel {worst}")
        # and bit for bit: the twin runs the kernel's operations in its
        # order, nvcc builds with -fmad=false and libm calls are the same
        # device functions; an error-free transform of the df32 chain
        # contracted into an FMA, or a step left in plain f32, moves the
        # result by about an f32 ulp, far inside the 5e-5 bar, but not here
        check(worst_abs == 0.0,
              f"{name} differs from its twin by {worst_abs}")
        # bound at the timed shape, M = 3B rows: the state read and the
        # derivative written once, the leaves read once; operations from
        # the traced rate program (cuda_rhs.operation_count)
        n_bytes = 4 * (2 * y3.numel() + ens.leaves1.numel()
                       + ens.leaves2.numel())
        n_ops = rhs_f.operations() * y3.shape[0] * ens.spec.z_no
        res[name] = dict(
            max_abs_err=worst_abs,
            **kernel_times(torch, lambda: rhs_f(y3, ens.leaves1,
                                                ens.leaves2)),
            plain_ms=time_ms(torch, lambda: rhs_f.twin(y3, ens.leaves1,
                                                       ens.leaves2)),
            library_ms=None, **bound(n_bytes, n_ops))
    # the twin could share a fault with the kernel, so the df32 mode is
    # also held to what it is for: on this input its error against the
    # float64 RHS is about a fifth of the plain mode's (a CPU run of the
    # twins at B = 64 gives 9.2e-7 against 4.4e-6); a df32 chain that has
    # lost its low words lands back at the plain mode's error
    e_df, e_pl = err64["n2_rhs_df32"], err64["n2_rhs_plain"]
    say(f"n2_rhs: against float64, df32 {e_df:.3e} vs plain {e_pl:.3e} "
        f"(bar: df32 <= plain / 2); the plain mode's accurate-math variant "
        f"{err64['n2_rhs_plain_am']:.3e}")
    check(e_df <= 0.5 * e_pl, f"df32 RHS error {e_df} not under half the "
          f"plain RHS error {e_pl}")
    return res


def rhs_guard(torch, np, cuda_rhs, rhs_fns, ens):
    """The RHS kernels generated for a second chemistry against their
    twins, bit for bit, at the stage-stacked M = 3B rows and at the ragged
    M = 300 (its 16 members repeated), also from a start that is not
    16-byte aligned."""
    y = perturbed_state(torch, np, ens)
    y3 = torch.cat([y, y * 1.01, y * 0.99], dim=0)
    for rhs_f in rhs_fns.values():
        ragged = ragged_rows(torch, y, ens)
        for yy, l1, l2 in ((y3, ens.leaves1, ens.leaves2), ragged,
                           (misaligned(torch, ragged[0]), *ragged[1:])):
            got = rhs_f(yy, l1, l2)
            want = rhs_f.twin(yy, l1, l2)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "CH4 RHS is not finite")
            check_row_major(got, yy.shape, f"ch4 {rhs_f.kernel_name}")
            dmax = float((got - want).abs().max())
            say(f"ch4 {rhs_f.kernel_name}: max_abs_err {dmax:.3e} against "
                f"its twin at M = {yy.shape[0]} rows, n = {yy.shape[1]}, "
                f"16-byte aligned {yy.data_ptr() % 16 == 0}")
            check(dmax == 0.0, f"CH4 {rhs_f.kernel_name} differs from its "
                  f"twin by {dmax} at M = {yy.shape[0]}")


def ns_phase(torch, np, cuda_ns, tableau, J, h0, dev):
    """ns_fused_step against its twin at the f32 leg's shapes: J the DME
    dense Jacobian of the sweep's members at y0, h the integrator's first
    step times a spread of 1 ... 100, P the cold seed after three twin
    iterations (so the step contracts)."""
    eig = ns_eig(tableau)
    Bn, n, _ = J.shape
    h, P = ns_operands(torch, cuda_ns, eig, J, h0)
    ws = cuda_ns.Workspace(Bn, n, dev)

    got = cuda_ns.ns_fused_step(J, *P, h, **eig, workspace=ws)
    want = cuda_ns.ns_fused_step_twin(J, *P, h, *eig.values())
    f64 = torch.float64
    ref = cuda_ns.ns_fused_step_twin(J.to(f64), *(p.to(f64) for p in P),
                                     h.to(f64), *eig.values())
    torch.cuda.synchronize()

    names = ("Pr", "Pcr", "Pci", "rho")
    err_tw = max(ns_scaled(g, t) for g, t in zip(got[:3], want[:3]))
    abs_tw = max(float((g - t).abs().max()) for g, t in zip(got, want))
    rho_rel = float(((got[3] - want[3]).abs()
                     / want[3].abs().clamp(min=1e-3)).max())
    err_k = max(ns_scaled(g, r) for g, r in zip(got, ref))
    err_p = max(ns_scaled(t, r) for t, r in zip(want, ref))
    say(f"ns_fused_step: input rho max {float(want[3].max()):.3e} min "
        f"{float(want[3].min()):.3e} over h0 x 1...100")
    say(f"ns_fused_step: |got - want| / (1 + |want|) {err_tw:.3e} (bar "
        f"2e-5), rho rel {rho_rel:.3e} (bar 2e-5), abs {abs_tw:.3e}")
    say(f"ns_fused_step: against float64, kernel {err_k:.3e} vs plain "
        f"{err_p:.3e} (bar: kernel <= 2 x plain)")
    for g, name in zip(got, names):
        check(bool(torch.isfinite(g).all()), f"ns_fused_step {name} is not "
              "finite")
    check(err_tw <= 2e-5, f"ns_fused_step differs from its twin by {err_tw}")
    check(rho_rel <= 2e-5, f"ns_fused_step rho differs by {rho_rel}")
    check(err_k <= 2.0 * err_p, f"ns_fused_step float64 error {err_k} over "
          f"twice the plain version's {err_p}")

    # four chained kernel steps never raise max rho, and two runs of the
    # chain give the same bits (the Frobenius sums have a fixed order)
    def chain():
        Pc, rhos = P, []
        for _ in range(4):
            *Pc, rho = cuda_ns.ns_fused_step(J, *Pc, h, **eig, workspace=ws)
            rhos.append(rho)
        return [r.clone() for r in rhos], Pc[0].clone()

    rhos, pr_a = chain()
    rhos_b, pr_b = chain()
    tops = [float(r.max()) for r in rhos]
    say("ns_fused_step: max rho over four chained steps "
        + " ".join(f"{t:.3e}" for t in tops))
    for prev, nxt in zip(tops, tops[1:]):
        check(nxt <= prev + 1e-6, f"chained steps raised max rho: {tops}")
    check(all(torch.equal(a, b) for a, b in zip(rhos, rhos_b))
          and torch.equal(pr_a, pr_b), "ns_fused_step is not reproducible")

    # ragged edges: n = 24 (one panel, padded rows), n = 30 (rows not
    # 16-byte aligned: 4-byte copies), n = 80 (the CH4 width) and n = 100
    # (a partial last panel)
    rng = np.random.default_rng(SEED)
    for Bs, ns in ((3, 24), (3, 30), (16, 80), (16, 100)):
        Js = torch.as_tensor(
            (-np.eye(ns) * rng.uniform(1.0, 50.0, (Bs, 1, 1))
             + 0.3 * rng.standard_normal((Bs, ns, ns))).astype(np.float32),
            device=dev)
        hs = torch.as_tensor(rng.uniform(0.005, 0.02, Bs).astype(np.float32),
                             device=dev)
        Ps = cuda_ns.ns_cold_start(Js, hs, **eig)
        g_s = cuda_ns.ns_fused_step(Js, *Ps, hs, **eig)
        w_s = cuda_ns.ns_fused_step_twin(Js, *Ps, hs, *eig.values())
        e_s = max(ns_scaled(a, b) for a, b in zip(g_s, w_s))
        say(f"ns_fused_step: n = {ns}, B = {Bs}: {e_s:.3e} (bar 2e-5)")
        check(e_s <= 2e-5, f"ns_fused_step at n = {ns} differs by {e_s}")

    return {"ns_fused_step": ns_times(torch, cuda_ns, eig, J, P, h, want,
                                      ws, abs_tw, host_calls=5)}


def random_stiff(torch, np, rng, Bs, ns, dev):
    """(J, h) of Bs random stiff members of edge ns (the inputs of
    tests/test_pallas_ns.py), float32 on dev."""
    J = torch.as_tensor(
        (-np.eye(ns) * rng.uniform(1.0, 50.0, (Bs, 1, 1))
         + 0.3 * rng.standard_normal((Bs, ns, ns))).astype(np.float32),
        device=dev)
    h = torch.as_tensor(rng.uniform(0.005, 0.02, Bs).astype(np.float32),
                        device=dev)
    return J, h


def ns_wide_phase(torch, np, cuda_ns, tableau, J, h0, dev):
    """ns_fused_step's wide route (members wider than 160, csrc/ns_wide.cu)
    against its twin: at n = 161, 200, 210, 420, 301, 1000 and its limit
    on random stiff members, at n = 210 also for a ragged B = 100, at
    n = 210 and 420 also on operands 4 bytes off 16-byte alignment; then
    at the f32_wide phase's shape (J the zNo-30 DME Jacobians at the
    sweep's inlet, h and P as ns_operands makes them) also against
    float64, twice for the same bits; timed there and at n = 420
    (B = 64). Returns its record, with the geometry at n = 210 and 420
    and its resident blocks."""
    eig = ns_eig(tableau)
    rng = np.random.default_rng(SEED)
    # the widths of the tests (161, 200), zNo 30 and 60 (210, 420), then an
    # odd n of 24-column panels, 8-column panels with slabs of 4 (1000) and
    # the route's limit (4-column panels); the ragged B = 100 at n = 210.
    # n % 4 == 0 on 16-byte aligned operands takes the tensor-map copies,
    # the rest cp.async
    for Bs, ns in ((3, 161), (3, 200), (3, 210), (2, 420), (2, 301),
                   (1, 1000), (1, cuda_ns.WIDE_MAX_N), (RAGGED_B, 210)):
        check(cuda_ns.route(ns) == "wide", f"n = {ns} is not routed wide")
        Js, hs = random_stiff(torch, np, rng, Bs, ns, dev)
        Ps = cuda_ns.ns_cold_start(Js, hs, **eig)
        g_s = cuda_ns.ns_fused_step(Js, *Ps, hs, **eig)
        w_s = cuda_ns.ns_fused_step_twin(Js, *Ps, hs, *eig.values())
        e_s = max(ns_scaled(a, b) for a, b in zip(g_s, w_s))
        say(f"ns_fused_step (wide): n = {ns}, B = {Bs}: {e_s:.3e} (bar 2e-5) "
            f"({cuda_ns.wide_geometry(ns)})")
        check(e_s <= 2e-5, f"ns_fused_step (wide) at n = {ns}, B = {Bs} "
              f"differs by {e_s}")
        if ns in (210, 420) and Bs != RAGGED_B:
            # J and P 4 bytes off 16-byte alignment: 4-byte cp.async copies
            Jm, Pm = misaligned(torch, Js), [misaligned(torch, p) for p in Ps]
            g_m = cuda_ns.ns_fused_step(Jm, *Pm, hs, **eig)
            e_m = max(ns_scaled(a, b) for a, b in zip(g_m, w_s))
            say(f"ns_fused_step (wide): n = {ns}, B = {Bs}, J and P not "
                f"16-byte aligned: {e_m:.3e} (bar 2e-5)")
            check(e_m <= 2e-5, f"ns_fused_step (wide) at n = {ns} on "
                  f"misaligned operands differs by {e_m}")
    # the chosen geometries and the blocks resident on an SM
    geometry = {}
    for ns in (210, 420):
        geo = cuda_ns.wide_geometry(ns)
        geometry[ns] = dict(geo._asdict(),
                            blocks_per_sm=cuda_ns.wide_blocks_per_sm(geo))
        say(f"ns_fused_step (wide): n = {ns}: {geometry[ns]}")
        check(geometry[ns]["blocks_per_sm"] >= 1,
              f"ns_fused_step (wide) at n = {ns}: no block fits an SM")
    Bn, n, _ = J.shape
    h, P = ns_operands(torch, cuda_ns, eig, J, h0)
    ws = cuda_ns.Workspace(Bn, n, dev)
    got = [t.clone() for t in cuda_ns.ns_fused_step(J, *P, h, **eig,
                                                    workspace=ws)]
    again = cuda_ns.ns_fused_step(J, *P, h, **eig, workspace=ws)
    want = cuda_ns.ns_fused_step_twin(J, *P, h, *eig.values())
    f64 = torch.float64
    ref = cuda_ns.ns_fused_step_twin(J.to(f64), *(p.to(f64) for p in P),
                                     h.to(f64), *eig.values())
    torch.cuda.synchronize()
    err_tw = max(ns_scaled(g, t) for g, t in zip(got[:3], want[:3]))
    abs_tw = max(float((g - t).abs().max()) for g, t in zip(got, want))
    rho_rel = float(((got[3] - want[3]).abs()
                     / want[3].abs().clamp(min=1e-3)).max())
    err_k = max(ns_scaled(g, r) for g, r in zip(got, ref))
    err_p = max(ns_scaled(t, r) for t, r in zip(want, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    say(f"ns_fused_step (wide): f32_wide shape B = {Bn}, n = {n}: input rho "
        f"max {float(want[3].max()):.3e}; |got - want| / (1 + |want|) "
        f"{err_tw:.3e}, rho rel {rho_rel:.3e} (bar 2e-5), abs {abs_tw:.3e}; "
        f"against float64 kernel {err_k:.3e} vs plain {err_p:.3e}; the same "
        f"bits twice {same}")
    for g in got:
        check(bool(torch.isfinite(g).all()), "ns_fused_step (wide) is not "
              "finite")
    check(err_tw <= 2e-5 and rho_rel <= 2e-5,
          f"ns_fused_step (wide) differs from its twin by {err_tw}, rho "
          f"{rho_rel}")
    check(err_k <= 2.0 * err_p, f"ns_fused_step (wide) float64 error "
          f"{err_k} over twice the plain version's {err_p}")
    check(same, "ns_fused_step (wide) is not reproducible")
    res = dict(B=Bn, n=n, geometry=geometry,
               **ns_times(torch, cuda_ns, eig, J, P, h, want, ws, abs_tw,
                          host_calls=5))
    J4, h4 = random_stiff(torch, np, rng, 64, 420, dev)
    P4 = cuda_ns.ns_cold_start(J4, h4, **eig)
    for _ in range(3):
        *P4, _ = cuda_ns.ns_fused_step_twin(J4, *P4, h4, *eig.values())
    P4 = tuple(p.contiguous() for p in P4)
    w4 = cuda_ns.ns_fused_step_twin(J4, *P4, h4, *eig.values())
    g4 = cuda_ns.ns_fused_step(J4, *P4, h4, **eig)
    e4 = max(ns_scaled(a, b) for a, b in zip(g4, w4))
    check(e4 <= 2e-5, f"ns_fused_step (wide) at n = 420, B = 64 differs by "
          f"{e4}")
    res["n420"] = dict(B=64, n=420, **ns_times(
        torch, cuda_ns, eig, J4, P4, h4, w4, cuda_ns.Workspace(64, 420, dev),
        max(float((a - b).abs().max()) for a, b in zip(g4, w4)),
        host_calls=5))
    return res


def ns_eig(tableau):
    """The Radau eigenvalues ns_fused_step takes (gamma, mu_r, mu_i)."""
    w = tableau[4]
    return dict(gamma=float(w[0].real), mu_r=float(w[1].real),
                mu_i=float(w[1].imag))


def ns_operands(torch, cuda_ns, eig, J, h0):
    """(h, P) for ns_fused_step at J: h the integrator's first steps h0
    times a spread of 1 ... 100, P the cold seed after three twin
    iterations (so the step contracts)."""
    spread = torch.logspace(0.0, 2.0, J.shape[0], device=J.device,
                            dtype=torch.float32)
    h = (h0 * spread).contiguous()
    P = cuda_ns.ns_cold_start(J, h, **eig)
    for _ in range(3):
        *P, _ = cuda_ns.ns_fused_step_twin(J, *P, h, *eig.values())
    return h, tuple(p.contiguous() for p in P)


def three_bmm(torch, eig, J, P, h):
    """The concatenated torch.bmm formulation of ns_fused_step's step
    (rmt_tpu/solvers/stiff_ensemble.py, the path without the kernel):
    J [Pr|Pcr|Pci], Pcr [MPc_r|MPc_i], Pci [MPc_r|MPc_i] and Pr MPr."""
    Pr, Pcr, Pci = P
    n = J.shape[-1]
    hh = h[:, None, None]
    JP = torch.bmm(J, torch.cat([Pr, Pcr, Pci], dim=-1))
    MPr = Pr - (eig["gamma"] * hh) * JP[..., :n]
    MPc_r = Pcr - hh * (eig["mu_r"] * JP[..., n:2 * n]
                        - eig["mu_i"] * JP[..., 2 * n:])
    MPc_i = Pci - hh * (eig["mu_r"] * JP[..., 2 * n:]
                        + eig["mu_i"] * JP[..., n:2 * n])
    eye = torch.eye(n, device=J.device)
    res_r = torch.sqrt(torch.mean((eye - MPr) ** 2, dim=(-1, -2)) * n)
    res_c = torch.sqrt((torch.mean((eye - MPc_r) ** 2, dim=(-1, -2))
                        + torch.mean(MPc_i ** 2, dim=(-1, -2))) * n)
    Mc = torch.cat([MPc_r, MPc_i], dim=-1)
    Ar, Ai = torch.bmm(Pcr, Mc), torch.bmm(Pci, Mc)
    return (2 * Pr - torch.bmm(Pr, MPr),
            2 * Pcr - (Ar[..., :n] - Ai[..., n:]),
            2 * Pci - (Ai[..., :n] + Ar[..., n:]),
            torch.maximum(res_r, res_c))


def ns_scaled(x, y):
    """max |x - y| / (1 + |y|), in float64."""
    return float(((x.double() - y.double()).abs()
                  / (1.0 + y.double().abs())).max())


def ns_times(torch, cuda_ns, eig, J, P, h, want, ws, max_abs_err,
             host_calls):
    """ns_fused_step's times at (J, P, h) beside its twin, the three-bmm
    formulation (first held to the twin's result ``want`` at 2e-5) and
    its roofline bound."""
    Bn, n, _ = J.shape
    lib = three_bmm(torch, eig, J, P, h)
    e_lib = max(ns_scaled(a, b) for a, b in zip(lib, want))
    check(e_lib <= 2e-5, f"the bmm formulation differs from the twin by "
          f"{e_lib} at n = {n}")
    # bound: 8 products of 2 n^3 a member; 4 matrices in, 3 out
    ops = 16 * n ** 3 * Bn
    res = dict(
        max_abs_err=max_abs_err,
        **kernel_times(torch, lambda: cuda_ns.ns_fused_step(
            J, *P, h, **eig, workspace=ws), host_calls=host_calls),
        plain_ms=time_ms(torch, lambda: cuda_ns.ns_fused_step_twin(
            J, *P, h, *eig.values())),
        library_ms=time_ms(torch, lambda: three_bmm(torch, eig, J, P, h)),
        **bound(4 * (7 * Bn * n * n + 2 * Bn), ops))
    geo = (cuda_ns.wide_geometry(n) if cuda_ns.route(n) == "wide"
           else cuda_ns.geometry(n))
    say(f"ns_fused_step: {ops / res['ms'] * 1e-9:.2f} TFLOP/s, "
        f"{res['bound_ms'] / res['ms']:.3f} of its bound, at B = {Bn}, "
        f"n = {n} ({geo})")
    return res


def ns_n1_phase(torch, cuda_ns, tableau, jacobians):
    """ns_fused_step against its twin at the N1 shapes: for each (J, h0)
    of ``jacobians`` (an N1 Jacobian (B, n, n) at the sweep's inlet and
    the integrator's first steps (B,)), with ns_operands' h and P. The
    first is also timed; returns its record."""
    eig = ns_eig(tableau)
    timed = None
    for J, h0 in jacobians:
        Bn, n, _ = J.shape
        h, P = ns_operands(torch, cuda_ns, eig, J, h0)
        ws = cuda_ns.Workspace(Bn, n, J.device)
        got = cuda_ns.ns_fused_step(J, *P, h, **eig, workspace=ws)
        want = cuda_ns.ns_fused_step_twin(J, *P, h, *eig.values())
        torch.cuda.synchronize()
        err = max(ns_scaled(g, t) for g, t in zip(got[:3], want[:3]))
        abs_err = max(float((g - t).abs().max()) for g, t in zip(got, want))
        rho_rel = float(((got[3] - want[3]).abs()
                         / want[3].abs().clamp(min=1e-3)).max())
        say(f"ns_fused_step: N1 shape n = {n}, B = {Bn}: input rho max "
            f"{float(want[3].max()):.3e}; |got - want| / (1 + |want|) "
            f"{err:.3e}, rho rel {rho_rel:.3e} (bar 2e-5), abs "
            f"{abs_err:.3e}")
        for g in got:
            check(bool(torch.isfinite(g).all()),
                  f"ns_fused_step at n = {n} is not finite")
        check(err <= 2e-5, f"ns_fused_step at n = {n} differs by {err}")
        check(rho_rel <= 2e-5,
              f"ns_fused_step rho at n = {n} differs by {rho_rel}")
        if timed is None:
            timed = dict(B=Bn, n=n, **ns_times(
                torch, cuda_ns, eig, J, P, h, want, ws, abs_err,
                host_calls=50))
    return timed


def probe_layout(np, b, offsets):
    """Sweep offsets for b members with the reference probes spliced in at
    evenly spaced indices (bench.py:_probe_layout)."""
    sweep = np.linspace(-5.0, 5.0, b)
    idx = np.round(np.linspace(0, b - 1, len(offsets))).astype(int)
    sweep[idx] = offsets
    return sweep, idx


def sweep_phase(torch, np, mi, run, counts, dev, *, name, chem, b, opts,
                bar, kernels, keep=None):
    """One leg of bench.py at b members with the reference probes of
    bench_ref.npz spliced in, probes recorded (out_members). It runs
    twice: the first run pays the process's one-time CUDA and library
    set-up; the second is the timed one, and the kernel launch counts are
    reset just before it and read just after it. Every kernel of the leg
    must have launched in the timed run. keep: a dict that gets the timed
    run's results (ys, y_fin, stats on the host) and wall."""
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        offsets, ref_ys, t_base = (z[f"{chem}_offsets"], z[f"{chem}_ys"],
                                   float(z[f"{chem}_t_base"]))
    sweep, idx = probe_layout(np, b, offsets)

    def integrate(label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ys_sel, y_fin, stats = run(mi, {"T0": t_base + sweep},
                                   out_members=idx, device=dev, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_seg = ys_sel.shape[0] - 1
        unfinished = int(torch.sum(stats.seg < n_seg))
        att = (stats.n_accepted + stats.n_rejected).cpu().numpy()
        got = ys_sel.double().cpu().numpy()
        rel = np.abs(got - ref_ys) / np.maximum(np.abs(ref_ys), 1e-7)
        say(f"{name} ({label}): B {b}, wall {wall:.3f} s, members/s "
            f"{b / wall:.3f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        say(f"{name} ({label}): attempts mean {att.mean():.1f} max "
            f"{int(att.max())}; unfinished {unfinished}; rejects conv "
            f"{int(stats.n_rej_conv.sum())} err {int(stats.n_rej_err.sum())} "
            f"rho {int(stats.n_rej_rho.sum())}; Jacobian refreshes "
            f"{stats.n_jev - 1}, cold rescues {stats.n_rescue}")
        say(f"{name} ({label}): max_rel_err {rel.max():.4e} mean_rel_err "
            f"{rel.mean():.4e} over {len(idx)} probes (bar {bar:g})")
        check(unfinished == 0,
              f"{name}: {unfinished}/{b} members exhausted the budget")
        check(bool(torch.isfinite(y_fin).all()),
              f"{name}: non-finite final states")
        check(tuple(y_fin.shape) == (b, ref_ys.shape[2]),
              f"{name}: final state shape")
        check(rel.max() <= bar, f"{name}: max_rel_err {rel.max()} > {bar:g}")
        if keep is not None:
            keep.update(ys=ys_sel.cpu(), y_fin=y_fin.cpu(), wall=wall,
                        stats=host_stats(torch, stats))
        return stats

    integrate("first run")
    reset_counts(counts)
    stats = integrate("timed run")
    return check_launches(name, counts, kernels, stats, opts)


def host_stats(torch, stats):
    """An EnsembleStats as a dict, its tensors on the host."""
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in stats._asdict().items()}


def reset_counts(counts):
    for table in counts:
        for k in table:
            table[k] = 0


def check_launches(name, counts, kernels, stats, opts):
    """The kernel launch counts of the run just made (reset just before
    it): every kernel of the path launched, no other; block_factor once
    an attempt; ns_fused_step as the chunks, rescues and refreshes say."""
    launches = {k: v for table in counts for k, v in table.items()}
    for k, v in launches.items():
        say(f"{name}: launches {k} {v}")
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was not launched by {name}")
    for k in set(launches) - set(kernels):
        check(launches[k] == 0, f"kernel {k} is not on the path of {name}")
    n_chunks = stats.n_jev - 1
    if "block_factor" in kernels:
        check(launches["block_factor"] == n_chunks * opts["j_every"],
              f"{name}: block_factor did not run once per attempt")
    for ns in ("ns_fused_step", "ns_fused_step_wide"):
        if ns not in kernels:
            continue
        # per chunk: the refresh and one maintenance step per attempt;
        # each cold rescue repeats a refresh; the refresh queued ahead of
        # the early-exit read is dropped when every member has finished
        dropped = int(n_chunks < opts["max_steps"] // opts["j_every"])
        want = (n_chunks * (opts["ns_refresh"]
                            + opts["j_every"] * opts["ns_step"])
                + opts["ns_refresh"] * (stats.n_rescue + dropped))
        say(f"{name}: {ns} launches expected {want} ({n_chunks} chunks, "
            f"{stats.n_rescue} rescues, {dropped} dropped refresh)")
        check(launches[ns] == want,
              f"{name}: {ns} launched {launches[ns]} times, expected {want}")
    return launches


def start_n1_reference():
    """A child process computing the N1 probes' float64 reference
    (scripts/bench_torch_n1.scipy_reference, scipy on the CPU, one
    thread) while the card works; it writes the array to its stdout in
    .npy form."""
    code = "\n".join((
        f"import sys; sys.path[:0] = [{ROOT!r}, "
        f"{os.path.join(ROOT, 'scripts')!r}]",
        "import numpy as np, torch",
        "torch.set_num_threads(1)",
        "import bench_torch_n1 as b",
        "from rmt_tpu_torch.cases.dme_case import make_model_input",
        "np.save(sys.stdout.buffer, b.scipy_reference("
        "make_model_input(model='N1'), b.PROBES))"))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def n1_reference(np, proc):
    """The child's reference (101, ACC_B, n), once it has finished."""
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, "the N1 reference child failed: "
          + err.decode(errors="replace")[-2000:])
    say(f"n1: scipy reference ready (waited {time.perf_counter() - t0:.1f} "
        "s for the child)")
    return np.load(io.BytesIO(out))


def n1_jacobians(torch, bench_n1, dev, gamma):
    """(J (B, n, n) float32, h0 (B,)) of the N1 sweep at its inlet, for
    the non-iso-thermal (n = 8) and the iso-thermal (n = 7) process: the
    integrator's default Jacobian and first step."""
    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.solvers.stiff_ensemble import batched_jacobian

    out = []
    for process in ("non-iso-thermal", "iso-thermal"):
        mi = make_model_input(model="N1", process_type=process)
        f, _, y0, ts = bench_n1.build(mi, bench_n1.probe_layout(B)[0], dev,
                                      torch.float32)
        t0 = torch.zeros(B, device=dev)
        J = batched_jacobian(f, t0, y0).contiguous()
        j_norm = torch.amax(torch.sum(torch.abs(J), dim=-1), dim=-1)
        out.append((J, torch.clamp(0.05 / (gamma * j_norm + 1e-30),
                                   max=1e-3 * float(ts[-1] - ts[0]))))
    return out


def n1_phase(torch, np, bench_n1, counts, dev, ref):
    """scripts/bench_torch_n1.py's N1 sweep at B members on the card, once,
    with the kernel counts reset just before it."""
    from rmt_tpu_torch.cases.dme_case import make_model_input

    mi = make_model_input(model="N1")
    offs, idx = bench_n1.probe_layout(B)
    ns = dict(ns_refresh=5, ns_step=1)
    reset_counts(counts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ys, stats = bench_n1.run(mi, offs, dev, **ns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_seg = ys.shape[0] - 1
    unfinished = int(torch.sum(stats.seg < n_seg))
    att = (stats.n_accepted + stats.n_rejected).cpu().numpy()
    rel = bench_n1.rel_err(ys[:, idx].double().cpu().numpy(), ref)
    say(f"n1 sweep: B {B}, n {ys.shape[2]}, wall {wall:.3f} s (the process's "
        f"first N1 run), members/s {B / wall:.3f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    say(f"n1 sweep: attempts mean {att.mean():.1f} max {int(att.max())}; "
        f"unfinished {unfinished}; rejects conv {int(stats.n_rej_conv.sum())}"
        f" err {int(stats.n_rej_err.sum())} rho "
        f"{int(stats.n_rej_rho.sum())}; Jacobian refreshes "
        f"{stats.n_jev - 1}, cold rescues {stats.n_rescue}")
    say(f"n1 sweep: max_rel_err {rel.max():.4e} mean_rel_err "
        f"{rel.mean():.4e} over {len(idx)} probes against scipy float64 "
        f"(bar {bench_n1.BAR:g})")
    check(tuple(ys.shape) == (ref.shape[0], B, ref.shape[2]),
          f"n1 sweep: result shape {tuple(ys.shape)}")
    check(unfinished == 0, f"n1 sweep: {unfinished}/{B} members exhausted "
          "the budget")
    check(bool(torch.isfinite(ys).all()), "n1 sweep: non-finite states")
    check(rel.max() <= bench_n1.BAR,
          f"n1 sweep: max_rel_err {rel.max()} > {bench_n1.BAR:g}")
    return check_launches("n1 sweep", counts, N1_KERNELS, stats,
                          dict(bench_n1.OPTS, **ns))


def microbatch_phase(torch, np, mi, run, dev):
    """run_n2_ensemble_lockstep(microbatch=MICROBATCH) at MICRO_B members
    with the f32x options against separate calls of its slices: the same
    states and per-member statistics, bit for bit, and the summed
    counters."""
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        t0 = float(z["dme_t_base"]) + np.linspace(-5.0, 5.0, MICRO_B)
    ys, st = run(mi, {"T0": t0}, microbatch=MICROBATCH, device=dev, **F32X)
    parts = [run(mi, {"T0": t0[lo:lo + MICROBATCH]}, device=dev, **F32X)
             for lo in range(0, MICRO_B, MICROBATCH)]
    same = torch.equal(ys, torch.cat([p[0] for p in parts], dim=1))
    for name in ("n_accepted", "n_rejected", "seg", "n_rej_conv"):
        same &= torch.equal(getattr(st, name),
                            torch.cat([getattr(p[1], name) for p in parts]))
    unfinished = int(torch.sum(st.seg < ys.shape[0] - 1))
    say(f"microbatch: B {MICRO_B} in slices of {MICROBATCH}: equal to the "
        f"separate calls {same}; unfinished {unfinished}; Jacobian "
        f"refreshes {st.n_jev} (the slices' {[p[1].n_jev for p in parts]})")
    check(same, "microbatch differs from separate calls of its slices")
    check(st.n_jev == sum(p[1].n_jev for p in parts),
          "microbatch did not sum the refresh counters")
    check(unfinished == 0, f"microbatch: {unfinished} members unfinished")


def lotka_volterra(torch, np, device):
    """f(t, z (B, 2)) and z0 of SEQ_B Lotka-Volterra systems (numpy seed
    SEED) with per-member parameters, on device, in float64."""
    rng = np.random.default_rng(SEED)
    lam = torch.as_tensor(rng.uniform([1.2, 0.8, 2.5, 0.7],
                                      [1.8, 1.2, 3.5, 1.3], (SEQ_B, 4)),
                          device=device)
    z0 = torch.as_tensor(rng.uniform([5.0, 3.0], [12.0, 7.0], (SEQ_B, 2)),
                         device=device)
    a, b, c, d = lam.unbind(1)

    def f(t, z):
        x, y = z[:, 0], z[:, 1]
        return torch.stack([a * x - b * x * y, -c * y + d * x * y], dim=1)

    return f, z0


def steppers(torch, np, device):
    """The explicit steppers on lotka_volterra: Dopri5 (rtol 1e-9, atol
    1e-12, 11 output times over [0, 5]) and RK4, AB3, PreCorr3 (STEPS
    steps over [0, 5]); {name: (ys, stats or None)}."""
    from rmt_tpu_torch.solvers import dopri5, fixed

    f, z0 = lotka_volterra(torch, np, device)
    ts = torch.linspace(0.0, 5.0, 11, dtype=torch.float64, device=device)
    out = {"dopri5": dopri5.odeint_batched(f, z0, ts, rtol=1e-9, atol=1e-12)}
    for name in ("rk4", "adams_bashforth3", "precorr3"):
        out[name] = (getattr(fixed, name)(f, 0.0, 5.0, STEPS, z0), None)
    return out


def seq_phase(torch, np, bench_seq, counts, dev, ref_n1):
    """The sequential float64 path on the card (see the module docstring,
    phase 8): every check exits nonzero; no kernel may launch."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases.dme_case import make_model_input
    from rmt_tpu_torch.parallel import run_n2_ensemble
    from rmt_tpu_torch.solvers import dopri5

    reset_counts(counts)
    t_phase = time.perf_counter()
    for part in (bench_seq.rmtexe_n2(torch, dev, warm=False),
                 bench_seq.rmtexe_n1(torch, dev, ref_n1[:, bench_seq.N1_PROBE],
                                     warm=False)):
        say(f"seq: {part['part']} at T0 {part['T0']:.4f} K, n {part['n']}: "
            f"wall {part['first_s']:.3f} s (the process's first call), "
            f"attempts {part['attempts']}, stats {part['stats']}, "
            f"max_rel_err {part['max_rel_err']:.4e} (bar {part['bar']:g})")
        check(part["finite"] and part["ok"],
              f"seq: {part['part']} failed its check: {part}")

    t0 = time.perf_counter()
    offsets, ref_ys, t_base = bench_seq.dme_probes()
    mi = make_model_input(model="N2")
    ys, st = run_n2_ensemble(mi, {"T0": t_base + offsets}, device=dev,
                             return_stats=True)
    wall = time.perf_counter() - t0
    rel = bench_seq.rel_err(ys.transpose(0, 1).cpu().numpy(), ref_ys)
    att = (st.n_accepted + st.n_rejected).cpu().numpy()
    say(f"seq: run_n2_ensemble B {len(offsets)}: wall {wall:.3f} s, "
        f"attempts mean {att.mean():.1f} max {int(att.max())}, n_unreached "
        f"{int(st.n_unreached.sum())}, max_rel_err {rel.max():.4e} "
        f"mean_rel_err {rel.mean():.4e} (bar {bench_seq.BAR_REF:g})")
    check(bool(torch.isfinite(ys).all()), "seq: non-finite ensemble states")
    check(int(st.n_unreached.max()) == 0, "seq: a member missed an output "
          f"time: {st.n_unreached.tolist()}")
    check(rel.max() <= bench_seq.BAR_REF,
          f"seq: run_n2_ensemble max_rel_err {rel.max()}")
    t0 = time.perf_counter()
    y1, _ = run_n2_ensemble(mi, {"T0": t_base + offsets[:1]}, device=dev)
    d1 = bench_seq.rel_err(y1[0].cpu().numpy(), ys[0].cpu().numpy()).max()
    say(f"seq: probe 0 alone (B = 1, wall {time.perf_counter() - t0:.3f} s) "
        f"against its B = {len(offsets)} row: max relative difference "
        f"{d1:.4e} (bar 1e-10)")
    check(d1 <= 1e-10, f"seq: probe 0 alone differs by {d1}")

    t0 = time.perf_counter()
    card_runs = steppers(torch, np, dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu_runs = steppers(torch, np, torch.device("cpu"))
    for name, (ys_c, st_c) in card_runs.items():
        ys_h, st_h = cpu_runs[name]
        e = bench_seq.rel_err(ys_c.cpu().numpy(), ys_h.numpy()).max()
        same = st_c is None or all(
            torch.equal(v.cpu(), getattr(st_h, k))
            for k, v in st_c._asdict().items())
        say(f"seq: {name} B {SEQ_B} on the card against the CPU: max "
            f"relative difference {e:.4e} (bar 1e-12), same statistics "
            f"{same}" + ("" if st_c is None else
                         f", accepted max {int(st_c.n_accepted.max())}"))
        check(e <= 1e-12 and same, f"seq: {name} card and CPU differ by {e}")
    rng = np.random.default_rng(SEED)
    k = torch.as_tensor(rng.uniform(0.5, 3.0, SEQ_B), device=dev)
    ts = torch.linspace(0.0, 2.0, 11, dtype=torch.float64, device=dev)
    yd, _ = dopri5.odeint_batched(
        lambda t, y: -k[:, None] * y,
        torch.ones((SEQ_B, 2), dtype=torch.float64, device=dev), ts,
        rtol=1e-9, atol=1e-12)
    exact = torch.exp(-k[:, None] * ts[None, :])[..., None].expand_as(yd)
    e_exp = float(((yd - exact).abs() / exact).max())
    say(f"seq: explicit steppers on the card {t_card:.3f} s; dopri5 decay "
        f"against exp: max relative error {e_exp:.4e} (bar 1e-7)")
    check(e_exp <= 1e-7, f"seq: dopri5 decay off exp by {e_exp}")
    try:
        rmtExe(make_model_input(model="N1", ivp="AM"), device=dev)
    except RuntimeError as e:
        say(f"seq: rmtExe N1 ivp 'AM' raised as rmt_tpu does: {e}")
    else:
        check(False, "seq: rmtExe N1 with ivp 'AM' did not raise")
    launches = {k: v for table in counts for k, v in table.items()}
    say(f"seq: kernel launches {launches} (the sequential path runs none)")
    check(not any(launches.values()),
          f"seq: a kernel launched on the sequential path: {launches}")
    say(f"seq: phase wall {time.perf_counter() - t_phase:.3f} s")


class z_no_of:
    """Within the block, homo.build_spec gives every N2 model z_no axial
    nodes (rmtExe and the ensembles take the grid from HomoSpec's
    defaults, zNo 20)."""

    def __init__(self, homo, z_no):
        self.homo, self.z_no = homo, z_no

    def __enter__(self):
        import functools

        self.saved = self.homo.build_spec
        self.homo.build_spec = functools.partial(self.saved, z_no=self.z_no)

    def __exit__(self, *exc):
        self.homo.build_spec = self.saved


def f32_wide_phase(torch, np, homo, mi, run, counts, dev):
    """The f32 DME leg at zNo WIDE_Z (ns_fused_step's wide route) against
    the f32x leg at the same zNo and F32_WIDE_B members (see the module
    docstring, phase 10)."""
    t0s = 523.0 + np.linspace(-5.0, 5.0, F32_WIDE_B)
    legs, by_path = {}, {}
    with z_no_of(homo, WIDE_Z):
        for name, opts, kernels in (("f32x", F32X, F32X_KERNELS),
                                    ("f32", F32, F32_WIDE_KERNELS)):
            reset_counts(counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys, st = run(mi, {"T0": t0s}, device=dev, **opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            unfinished = int(torch.sum(st.seg < ys.shape[0] - 1))
            att = (st.n_accepted + st.n_rejected).cpu().numpy()
            label = f"f32_wide {name} (zNo {WIDE_Z}, n {ys.shape[2]})"
            say(f"{label}: B {F32_WIDE_B}, wall {wall:.3f} s, attempts mean "
                f"{att.mean():.1f} max {int(att.max())}; unfinished "
                f"{unfinished}; Jacobian refreshes {st.n_jev - 1}, cold "
                f"rescues {st.n_rescue}")
            check(unfinished == 0, f"{label}: {unfinished} members exhausted "
                  "the budget")
            check(bool(torch.isfinite(ys).all()), f"{label}: non-finite "
                  "states")
            by_path[name] = check_launches(label, counts, kernels, st, opts)
            legs[name] = ys.double().cpu().numpy()
    rel = np.abs(legs["f32"] - legs["f32x"]) / np.maximum(
        np.abs(legs["f32x"]), 1e-7)
    say(f"f32_wide: f32 against f32x over every member and output time: "
        f"max_rel_err {rel.max():.4e} mean {rel.mean():.4e} (bar 5e-5)")
    check(rel.max() <= 5e-5, f"f32_wide: f32 and f32x differ by {rel.max()}")
    return by_path


def start_steady_models():
    """A child process running rmtExe M0, M1, M3, M4, M7 and M8 on the card
    (scripts/bench_torch_seq.steady_model, one call each) while this
    process works; it writes a JSON list of their records to its stdout."""
    code = "\n".join((
        f"import sys, json; sys.path[:0] = [{ROOT!r}, "
        f"{os.path.join(ROOT, 'scripts')!r}]",
        "import torch",
        "import bench_torch_seq as b",
        "ref = b.models_ref()",
        "out = [b.steady_model(torch, torch.device('cuda:0'), m, ref, "
        "warm=False) for m in b.STEADY_MODELS]",
        "print(json.dumps(out))"))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def models_phase(torch, np, bench_seq, counts, dev):
    """rmtExe M2 and M9's RHS on the card in this process (see the module
    docstring, phase 11; models_children reads the rest). Returns M2's
    launch counts."""
    from rmt_tpu_torch import rmtExe
    from rmt_tpu_torch.cases import pb_case
    from rmt_tpu_torch.models import pb
    from rmt_tpu_torch.ops import block_solve, jacobian

    t_phase = time.perf_counter()
    ref = bench_seq.models_ref()
    reset_counts(counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rmtExe(pb_case.m2_model_input(), device=dev)["resModel"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = res["solverStats"]
    attempts = st["n_accepted"][0] + st["n_rejected"][0]
    ref_att = int(ref["m2_attempts"].sum())
    err = max(bench_seq.max_rel(res["dataPacktime"], ref["m2_packtime"]),
              bench_seq.max_rel(res["checkpoint"]["state"], ref["m2_state"]))
    say(f"models: rmtExe M2 (zNo 100, tNo 10, n 700, B 1, block mode): wall "
        f"{wall:.3f} s, attempts {attempts} (reference {ref_att}, bar x "
        f"{bench_seq.ATTEMPTS_RATIO}), Jacobian refreshes {st['n_jev'] - 1}; "
        f"max_rel_err against models_ref.npz {err:.4e} (bar "
        f"{bench_seq.BAR_M2:g})")
    check(bool(np.isfinite(res["dataPacktime"]).all()), "models: M2 is not "
          "finite")
    check(err <= bench_seq.BAR_M2, f"models: M2 differs by {err}")
    check(ref_att / bench_seq.ATTEMPTS_RATIO <= attempts
          <= bench_seq.ATTEMPTS_RATIO * ref_att,
          f"models: M2 took {attempts} attempts against {ref_att}")
    launches = check_launches(
        "models M2", counts, M2_KERNELS,
        SimpleNamespace(n_jev=st["n_jev"], n_rescue=0), {"j_every": 16})

    # M9: the RHS and its frozen-march Jacobian blocks, card against CPU
    mi9 = pb_case.model_input("M9")
    spec = pb.build_spec(mi9)
    var_no = spec.n_comp + 1
    pert = np.random.default_rng(SEED).uniform(0.98, 1.02,
                                               (2, var_no * spec.z_no))

    def m9_on(where):
        """M9's RHS and frozen-march Jacobian blocks at two perturbed
        states on ``where``."""
        p = pb.build_params(mi9, device=where)
        y = pb.m9_initial_state(spec, p) * torch.as_tensor(pert,
                                                           device=where)
        frozen = pb.make_m9_rhs(spec, frozen_march_jac=True)
        jac = jacobian.batched_colored_jacobian(
            lambda x: frozen(None, x, p),
            jacobian.banded_coloring(var_no, spec.z_no))
        return (pb.make_m9_rhs(spec)(None, y, p),
                *block_solve.extract_bidiag_blocks(jac(y), var_no,
                                                   spec.z_no))

    e9 = max(float((a.cpu() - b).abs().max() / b.abs().max())
             for a, b in zip(m9_on(dev), m9_on(torch.device("cpu"))))
    say(f"models: M9 (zNo {spec.z_no}) RHS and frozen-march Jacobian blocks "
        f"on the card against the CPU: {e9:.3e} of each one's max (bar "
        f"1e-12)")
    check(e9 <= 1e-12, f"models: M9 on the card differs by {e9}")
    say(f"models: phase wall {time.perf_counter() - t_phase:.3f} s")
    return launches


def models_children(steady_proc):
    """Phase 11's steady models, run by the child steady_proc: each within
    its bar of models_ref.npz."""
    t0 = time.perf_counter()
    sout, serr = steady_proc.communicate(timeout=900)
    check(steady_proc.returncode == 0, "models: the steady-model child "
          "failed: " + serr.decode(errors="replace")[-2000:])
    say(f"models: steady-model child ready (waited "
        f"{time.perf_counter() - t0:.1f} s)")
    for r in json.loads(sout.decode().strip().splitlines()[-1]):
        say(f"models: {r['part']} ({r['n_var']} rows x {r['points']} "
            f"points): wall {r['first_s']:.3f} s (its process's first call "
            f"of it), max_rel_err {r['max_rel_err']:.4e} (bar {r['bar']:g})")
        check(r["ok"], f"models: {r['part']} failed its check: {r}")


def start_hetero_models():
    """A child process running rmtExe T1, T2 (FDM, OC, OCFE), T3, M5 and
    M14 on the card (scripts/bench_torch_seq.hetero_model, one call each),
    then run_m14_sweep at M14_SWEEP_B members (bench_torch_seq.m14_sweep,
    its member 0 held to that rmtExe M14), while this process works; it
    writes a JSON object of their records and of the kernel launches of
    its process to its stdout."""
    code = "\n".join((
        f"import sys, json; sys.path[:0] = [{ROOT!r}, "
        f"{os.path.join(ROOT, 'scripts')!r}]",
        "import torch",
        "import bench_torch_seq as b",
        "from rmt_tpu_torch.ops import cuda_block, cuda_ns, cuda_rhs",
        "dev = torch.device('cuda:0')",
        "ref = b.models_ref()",
        "out = [b.hetero_model(torch, dev, m, ref, warm=False) "
        "for m in b.HETERO_MODELS]",
        "co_gas = next(r['co_gas'] for r in out if 'co_gas' in r)",
        f"sweep = b.m14_sweep(torch, dev, {M14_SWEEP_B}, ref, "
        "co_gas=co_gas)",
        "launches = {k: v for c in (cuda_block, cuda_ns, cuda_rhs) "
        "for k, v in c.LAUNCHES.items()}",
        "print(json.dumps({'records': out, 'sweep': sweep, "
        "'launches': launches}))"))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def steady_het_phase(torch, np, bench_seq, counts, dev, het_proc):
    """The particle, axial-dispersion and steady heterogeneous models and
    the M14 design sweep on the card, all run by the child het_proc (see
    the module docstring, phase 12): every check exits nonzero; no kernel
    may launch."""
    t_phase = time.perf_counter()
    reset_counts(counts)
    t0 = time.perf_counter()
    sout, serr = het_proc.communicate(timeout=900)
    check(het_proc.returncode == 0, "steady_het: the model child failed: "
          + serr.decode(errors="replace")[-2000:])
    say(f"steady_het: model child ready (waited "
        f"{time.perf_counter() - t0:.1f} s)")
    child = json.loads(sout.decode().strip().splitlines()[-1])
    co_gas = None
    for r in child["records"]:
        extra = ""
        if "ref_attempts" in r:
            extra = (f", attempts {r['attempts']} ({r['accepted']} accepted,"
                     f" {r['rejected']} rejected; reference "
                     f"{r['ref_attempts']}: {r['ref_accepted']} and "
                     f"{r['ref_rejected']}; bar x "
                     f"{bench_seq.ATTEMPTS_RATIO})")
        say(f"steady_het: {r['part']} ({r['n_var']} rows x {r['points']} "
            f"points): wall {r['first_s']:.3f} s (its process's first call "
            f"of it), radau attempts {r.get('attempts', 0)}, Newton "
            f"iterations {r.get('newton_iterations', 0)}, max_rel_err "
            f"{r['max_rel_err']:.4e} (bar {r['bar']:g}){extra}")
        check(r["ok"], f"steady_het: {r['part']} failed its check: "
              + json.dumps({k: v for k, v in r.items() if k != "co_gas"}))
        co_gas = r.get("co_gas", co_gas)
    say(f"steady_het: kernel launches in the model child "
        f"{child['launches']}")
    check(not any(child["launches"].values()),
          f"steady_het: a kernel launched in the model child: "
          f"{child['launches']}")
    check(co_gas is not None, "steady_het: no rmtExe M14 record")

    r = child["sweep"]
    split = ", ".join(f"{k} {v:.3f} s" for k, v in r["split_s"].items())
    say(f"steady_het: run_m14_sweep B {r['B']} (zNo 30, n {r['n']}): wall "
        f"{r['wall_s']:.3f} s ({split}), {r['members_per_sec']:.2f} "
        f"members/s, peak {r['peak_gib']:.3f} GiB; converged "
        f"{r['converged']}/{r['B']}, max residual {r['res_norm_max']:.3e}; "
        f"members 0, {r['B'] // 2}, {r['B'] - 1} against models_ref.npz: "
        f"max_rel_err {r['max_rel_err']:.4e} (bar {r['bar']:g}); member 0 "
        f"against rmtExe M14 on the card {r['member0_vs_rmtexe']:.4e}")
    check(r["converged"] == r["B"] and r["finite"],
          f"steady_het: {r['B'] - r['converged']} sweep members did not "
          "converge or are not finite")
    check(r["ok"], f"steady_het: the sweep failed its check: {r}")

    launches = {k: v for table in counts for k, v in table.items()}
    say(f"steady_het: kernel launches {launches} (these paths run none)")
    check(not any(launches.values()),
          f"steady_het: a kernel launched on these paths: {launches}")
    say(f"steady_het: phase wall {time.perf_counter() - t_phase:.3f} s")


def start_dyn_models(calls):
    """A child process running calls, expressions of
    scripts/bench_torch_seq (as b) with torch, dev and ref bound, on the
    card while this process works (rmtExe of the dynamic heterogeneous
    models, M13's chained resume); it writes a JSON object of their
    records and of the kernel launches of its process to its stdout."""
    code = "\n".join((
        f"import sys, json; sys.path[:0] = [{ROOT!r}, "
        f"{os.path.join(ROOT, 'scripts')!r}]",
        "import torch",
        "import bench_torch_seq as b",
        "from rmt_tpu_torch.ops import cuda_block, cuda_ns, cuda_rhs",
        "dev = torch.device('cuda:0')",
        "ref = b.models_ref()",
        f"out = [{', '.join(calls)}]",
        "launches = {k: v for c in (cuda_block, cuda_ns, cuda_rhs) "
        "for k, v in c.LAUNCHES.items()}",
        "print(json.dumps({'records': out, 'launches': launches}))"))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


# the dyn_het phase's four children, side by side (the host's work of
# each within that of the phase-12 child, which T1 sets): rmtExe M10-M12
# and the M13 lockstep sweep; rmtExe M13; run_m11_sweep; M13's chained
# resume
DYN_CHILDREN = (
    [*(f"b.dyn_model(torch, dev, {m!r}, ref, warm=False)"
       for m in ("M10", "M11", "M12")),
     f"b.m13_sweep(torch, dev, {M13_SWEEP_B}, ref)"],
    ["b.dyn_model(torch, dev, 'M13', ref, warm=False)"],
    [f"b.m11_sweep(torch, dev, {M11_SWEEP_B})"],
    ["b.m13_resume(torch, dev)"],
)


def dyn_het_phase(torch, np, bench_seq, counts, dev, dyn_procs):
    """The dynamic heterogeneous models, the M13 lockstep sweep and the
    M11 sweep on the card, all run by the children dyn_procs (see the
    module docstring, phase 13): every check exits nonzero; no kernel may
    launch."""
    t_phase = time.perf_counter()
    reset_counts(counts)
    records = {}
    for proc in dyn_procs:
        t0 = time.perf_counter()
        sout, serr = proc.communicate(timeout=1200)
        check(proc.returncode == 0, "dyn_het: a model child failed: "
              + serr.decode(errors="replace")[-2000:])
        say(f"dyn_het: model child ready (waited "
            f"{time.perf_counter() - t0:.1f} s)")
        child = json.loads(sout.decode().strip().splitlines()[-1])
        records.update((c["part"], c) for c in child["records"])
        say(f"dyn_het: kernel launches in the model child "
            f"{child['launches']}")
        check(not any(child["launches"].values()),
              f"dyn_het: a kernel launched in a model child: "
              f"{child['launches']}")

    r = records.pop("run_m13_sweep lockstep")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in r["split_s"].items())
    say(f"dyn_het: run_m13_sweep lockstep B {r['B']} (zNo 10, rNo 7, tNo 5):"
        f" wall {r['wall_s']:.3f} s ({split}), {r['members_per_sec']:.3f} "
        f"members/s, peak {r['peak_gib']:.3f} GiB; converged "
        f"{r['converged']}/{r['B']}, unreached {r['unreached']}, rescued "
        f"intervals {r['rescued_intervals']}; members 0, {r['B'] // 2}, "
        f"{r['B'] - 1} against rmt_tpu's lockstep engine: gas gap "
        f"{r['gap']['gas']['abs']:.3e} abs, {r['gap']['gas']['rel']:.3e} "
        f"rel, solid gap {r['gap']['solid']['abs']:.3e} abs, "
        f"{r['gap']['solid']['rel']:.3e} rel (bar {r['bar']})")
    check(r["ok"], f"dyn_het: the M13 lockstep sweep failed its check: {r}")
    r11 = records.pop("run_m11_sweep")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in r11["split_s"].items())
    say(f"dyn_het: run_m11_sweep B {r11['B']} (zNo 10, rNo 7, n "
        f"{r11['n']}): wall {r11['wall_s']:.3f} s ({split}), "
        f"{r11['members_per_sec']:.3f} members/s, peak "
        f"{r11['peak_gib']:.3f} GiB, attempts mean "
        f"{r11['attempts_mean']:.1f} max {r11['attempts_max']}, unreached "
        f"{r11['unreached']}")
    check(r11["ok"], "dyn_het: the M11 sweep failed its check: " + json.dumps(
        {k: v for k, v in r11.items() if k != "state"}))

    for c in records.values():
        extra = ""
        if "ref_attempts" in c:
            extra = (f", attempts {c['attempts']} ({c['accepted']} "
                     f"accepted, {c['rejected']} rejected; reference "
                     f"{c['ref_attempts']}; bar x "
                     f"{bench_seq.ATTEMPTS_RATIO})")
        wall = (f"wall {c['first_s']:.3f} s (its process's first "
                f"call), peak {c['peak_gib']:.3f} GiB" if "first_s" in c
                else f"wall {c['wall_s']:.3f} s")
        say(f"dyn_het: {c['part']}: {wall}, "
            f"error {c['max_rel_err']:.4e} (|d| / (|ref| + "
            f"{bench_seq.DYN_FLOOR:g}), bar {c['bar']:g}; floor 1e-7: "
            f"{c['rel_err_1e7']:.4e}, absolute {c['max_abs_err']:.4e})"
            f"{extra}")
        check(c["ok"], f"dyn_het: {c['part']} failed its check: "
              + json.dumps({k: v for k, v in c.items() if k != "state"}))
    check("rmtExe M11" in records, "dyn_het: no rmtExe M11 record")
    e0 = bench_seq.rel_floor(np.asarray(r11["state"]),
                             np.asarray(records["rmtExe M11"]["state"]))
    say(f"dyn_het: run_m11_sweep member 0 against rmtExe M11 on the card "
        f"{e0:.4e} (|d| / (|ref| + {bench_seq.DYN_FLOOR:g}), bar "
        f"{bench_seq.BAR_STEADY:g})")
    check(e0 <= bench_seq.BAR_STEADY,
          f"dyn_het: M11 sweep member 0 differs from rmtExe M11 by {e0}")

    launches = {k: v for table in counts for k, v in table.items()}
    say(f"dyn_het: kernel launches {launches} (these paths run none)")
    check(not any(launches.values()),
          f"dyn_het: a kernel launched on these paths: {launches}")
    say(f"dyn_het: phase wall {time.perf_counter() - t_phase:.3f} s")


def n2_opts_phase(torch, np, mi, run, counts, dev):
    """The rest of rmt_tpu's N2 ensemble options at the DME probe
    temperatures of bench_ref.npz (zNo 20), each check held to the
    reference probes at its bar with the launch counts reset just before
    it: every member finishes, every state is finite, and the kernels of
    the check's path launch as its chunks say (no other). Most checks run
    the 64 probes alone (B = 64); the accurate-math pair runs phase 4's
    sweep (B = 4096, the probes spliced in), on and off in turns, since a
    float32 run's step sequence, and with it a probe's error, moves with
    the batch's rounding (the f32 options at B = 64 put one probe at
    6.4e-5 where the same member at B = 4096 stays at 5.8e-6)."""
    from rmt_tpu_torch.kinetics.dsl import accurate_f32_math

    t_phase = time.perf_counter()
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        ref_ys, t_base, offsets = (z["dme_ys"], float(z["dme_t_base"]),
                                   z["dme_offsets"])
    b64 = len(offsets)
    checks = (
        ("f64 leg", dict(F64, dtype=torch.float64), 1e-6,
         ("ns_fused_step",), False, b64),
        ("accurate_rates=True", dict(F32X, accurate_rates=True), 1e-6,
         BLOCK_KERNELS + ("n2_rhs_plain",), False, b64),
        ('accurate_rates="full"', dict(F32X, accurate_rates="full"),
         FULL_BAR, BLOCK_KERNELS, False, b64),
        # plain float32: the member-last df32 chain in eager PyTorch takes
        # about 63 s at B = 64 on the card (thousands of launches an
        # evaluation, every sweep), beyond this phase's share of the wall
        ("batched_rhs=True", dict(F32, batched_rhs=True), 5e-5,
         ("ns_fused_step",), False, b64),
        ("fused_rhs=False", dict(F32X, fused_rhs=False), 1e-6,
         BLOCK_KERNELS, False, b64),
        ("colored_jacobian=False", dict(F32, colored_jacobian=False), 5e-5,
         ("ns_fused_step", "n2_rhs_plain"), False, b64),
        ("accurate f32 math on", F32, 5e-5,
         ("ns_fused_step", "n2_rhs_plain_am"), True, B),
        ("accurate f32 math off", F32, 5e-5,
         ("ns_fused_step", "n2_rhs_plain"), False, B),
    )
    total, errs = {}, {}
    for label, opts, bar, kernels, am, b in checks:
        name = f"n2_opts {label}"
        sweep, idx = probe_layout(np, b, offsets)
        reset_counts(counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with accurate_f32_math(am):
            ys, y_fin, stats = run(mi, {"T0": t_base + sweep},
                                   out_members=idx, device=dev, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        unfinished = int(torch.sum(stats.seg < ys.shape[0] - 1))
        att = (stats.n_accepted + stats.n_rejected).cpu().numpy()
        got = ys.double().cpu().numpy()
        rel = np.abs(got - ref_ys) / np.maximum(np.abs(ref_ys), 1e-7)
        errs[label] = float(rel.max())
        say(f"{name}: B {b}, {ys.dtype}, wall {wall:.3f} s, members/s "
            f"{b / wall:.3f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
            f"attempts mean {att.mean():.1f} max {int(att.max())}, "
            f"unfinished {unfinished}, Jacobian refreshes "
            f"{stats.n_jev - 1}; max_rel_err {rel.max():.4e} mean_rel_err "
            f"{rel.mean():.4e} over {len(idx)} probes (bar {bar:g})")
        check(unfinished == 0, f"{name}: {unfinished}/{b} members exhausted "
              "the budget")
        check(bool(torch.isfinite(y_fin).all()), f"{name}: non-finite "
              "states")
        check(rel.max() <= bar, f"{name}: max_rel_err {rel.max()} > {bar:g}")
        launches = check_launches(name, counts, kernels, stats, opts)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    say(f"n2_opts: the f32 leg's max_rel_err with accurate f32 math on "
        f"{errs['accurate f32 math on']:.4e}, off "
        f"{errs['accurate f32 math off']:.4e}")
    say(f"n2_opts: phase wall {time.perf_counter() - t_phase:.3f} s")
    return total


def mesh_worker(mesh):
    """One rank of the mesh phase, in a child process (this script is its
    __main__): phase 3's f32x DME sweep (B members, the reference probes
    spliced in) twice, the second timed, then phase 4's f32 sweep once,
    each with mesh=. Returns each run's gathered results, its wall (from
    a barrier of the ranks to the gathered result) and this rank's
    kernel launches in it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rmt_tpu_torch.cases import dme_case
    from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep
    from rmt_tpu_torch.parallel.dryrun import launch_counts, launches_since

    mi = dme_case.make_model_input(model="N2")
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        offsets, t_base = z["dme_offsets"], float(z["dme_t_base"])
    out = {}
    sweep, idx = probe_layout(np, B, offsets)
    for label, opts, runs in (("f32x", F32X, 2), ("f32", F32, 1)):
        for _ in range(runs):
            torch.cuda.synchronize()
            dist.barrier(group=mesh.group)
            before = launch_counts()
            t0 = time.perf_counter()
            ys, y_fin, stats = run_n2_ensemble_lockstep(
                mi, {"T0": t_base + sweep}, out_members=idx, mesh=mesh,
                **opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[label] = dict(ys=ys.cpu(), y_fin=y_fin.cpu(), wall=wall,
                          stats=host_stats(torch, stats),
                          launches=launches_since(before))
    return out


def same_run(torch, got, want):
    """Whether two runs' probes, final states and statistics (per member
    and the counters) are equal bit for bit."""
    same = (torch.equal(got["ys"], want["ys"])
            and torch.equal(got["y_fin"], want["y_fin"]))
    for k, v in want["stats"].items():
        same &= (torch.equal(got["stats"][k], v) if isinstance(v, torch.Tensor)
                 else got["stats"][k] == v)
    return bool(same)


def mesh_sweep_checks(torch, np, ranks, f32x_run, f32_run, ref_ys, blocks,
                      launched):
    """Mesh checks (a) and (b) of the ranks' results (see the module
    docstring, phase 15; blocks: rank_blocks)."""
    for r, res in enumerate(ranks):
        launched(f"mesh f32x rank {r}", res["f32x"]["launches"],
                 F32X_KERNELS, res["f32x"]["stats"], F32X)
        launched(f"mesh f32 rank {r}", res["f32"]["launches"],
                 F32_KERNELS, res["f32"]["stats"], F32)
        check(same_run(torch, res["f32x"], ranks[0]["f32x"])
              and same_run(torch, res["f32"], ranks[0]["f32"]),
              f"mesh: rank {r}'s gathered results differ from rank 0's")
    a, b = ranks[0]["f32x"], ranks[0]["f32"]
    same_a = same_run(torch, a, f32x_run)
    say(f"mesh (a) f32x: B {B} over {MESH_RANKS} ranks, wall "
        f"{a['wall']:.3f} s, members/s {B / a['wall']:.3f}; unsharded "
        f"(phase 3's timed run) {f32x_run['wall']:.3f} s, members/s "
        f"{B / f32x_run['wall']:.3f}; Jacobian refreshes "
        f"{a['stats']['n_jev'] - 1} (unsharded "
        f"{f32x_run['stats']['n_jev'] - 1}); bit for bit equal to phase "
        f"3's timed run: {same_a}")
    check(same_a, "mesh (a): the sharded f32x sweep differs from phase 3's "
          "timed run")
    same_b = same_run(torch, b, f32_run)
    say(f"mesh (b) f32: B {B} over {MESH_RANKS} ranks, wall "
        f"{b['wall']:.3f} s (the ranks' first f32 run), members/s "
        f"{B / b['wall']:.3f}; unsharded (phase 4's timed run) "
        f"{f32_run['wall']:.3f} s; n_jev {b['stats']['n_jev']} (unsharded "
        f"{f32_run['stats']['n_jev']}), n_rescue {b['stats']['n_rescue']} "
        f"(unsharded {f32_run['stats']['n_rescue']}); bit for bit equal to "
        f"phase 4's timed run: {same_b}")
    if not same_b:
        mesh_b_fallback(torch, np, b, f32_run, ref_ys, blocks)


def rank_blocks(torch, np, mi, run, dev):
    """Phase 4's f32 sweep as separate calls on the mesh ranks' blocks
    of B // MESH_RANKS members (the probes each holds): each call's
    probes, final states and statistics on the host, for mesh check
    (b)."""
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        t_base, offsets = float(z["dme_t_base"]), z["dme_offsets"]
    sweep, idx = probe_layout(np, B, offsets)
    k = B // MESH_RANKS
    blocks = []
    for lo in range(0, B, k):
        mine = idx[(idx >= lo) & (idx < lo + k)] - lo
        ys, y_fin, st = run(mi, {"T0": t_base + sweep[lo:lo + k]},
                            out_members=mine, device=dev, **F32)
        blocks.append(dict(ys=ys.cpu(), y_fin=y_fin.cpu(),
                           stats=host_stats(torch, st)))
    return blocks


def mesh_b_fallback(torch, np, got, want, ref_ys, blocks):
    """Mesh check (b) where the sharded f32 sweep's bits differ from the
    unsharded run's (the members' bits depend on the batch's size): the
    largest difference and its member printed; then every member and
    per-member statistic equal bit for bit to separate calls on the
    ranks' blocks (the same batch size; blocks, from rank_blocks), n_jev
    the slowest block's, the final states within the f32 leg's 5e-5 of
    the unsharded run and the probes within 5e-5 of bench_ref.npz."""
    d = (got["y_fin"].double() - want["y_fin"].double()).abs()
    rel = d / want["y_fin"].double().abs().clamp(min=1e-7)
    worst = int(torch.argmax(rel.amax(dim=1)))
    probe = np.abs(got["ys"].double().numpy() - ref_ys) / np.maximum(
        np.abs(ref_ys), 1e-7)
    say(f"mesh (b) f32: the members' bits depend on the batch's size: "
        f"largest difference {float(d.max()):.4e} ({float(rel.max()):.4e} "
        f"relative) at member {worst}; probes' max_rel_err {probe.max():.4e}")
    k = B // MESH_RANKS
    same = (torch.equal(got["ys"], torch.cat([p["ys"] for p in blocks], 1))
            and torch.equal(got["y_fin"],
                            torch.cat([p["y_fin"] for p in blocks])))
    for name, v in got["stats"].items():
        if isinstance(v, torch.Tensor):
            same &= torch.equal(v, torch.cat([p["stats"][name]
                                              for p in blocks]))
    slowest = max(p["stats"]["n_jev"] for p in blocks)
    say(f"mesh (b) f32: equal bit for bit to separate calls on the ranks' "
        f"blocks of {k}: {bool(same)}; n_jev {got['stats']['n_jev']} (the "
        f"slowest block's {slowest})")
    check(same, "mesh (b): the sharded f32 sweep differs from separate "
          "calls on the ranks' blocks")
    check(got["stats"]["n_jev"] == slowest, "mesh (b): n_jev is not the "
          "slowest block's")
    check(float(rel.max()) <= 5e-5, "mesh (b): final states beyond 5e-5 "
          "of the unsharded run")
    check(probe.max() <= 5e-5, "mesh (b): probes beyond 5e-5")


def estimation_reference(torch, dev, b):
    """The dry run's estimation step on one process at b members:
    (loss, gradients)."""
    from rmt_tpu_torch.parallel import dryrun, make_estimation_step

    spec, params, axes, target, theta0 = dryrun.estimation_problem(b, dev)
    step = make_estimation_step(spec, axes, target, device=dev,
                                **dryrun.ESTIMATION)
    loss, grads, _ = step.value_and_grad(theta0, params)
    return float(loss), {k: float(v) for k, v in grads.items()}


# the mesh phase's dry runs: their backends and numbers of ranks
DRY_RUNS = {"gloo": MESH_RANKS, "nccl": 1}
# the mesh phase fails when its ranks have not ended this long after it
# waits for them
RANKS_TIMEOUT_S = 300


def start_dry_runs(dev, store):
    """The ranks of both dry runs of the mesh phase (dryrun_multichip's:
    dryrun.start of dryrun_worker), started at once on dev with their
    stores under store; dryrun.dryrun_results collects each. Their ranks
    are bound by the host, so they run beside this process's next
    phases."""
    from rmt_tpu_torch.parallel import dryrun

    return {backend: dryrun.start(dryrun.dryrun_worker, n, backend, dev,
                                  store)
            for backend, n in DRY_RUNS.items()}


def mesh_phase(torch, np, dev, f32x_run, f32_run, store, dry_runs, prep):
    """The dp mesh (see the module docstring, phase 15): phase 3's f32x
    sweep and phase 4's f32 sweep over MESH_RANKS gloo ranks sharing the
    card, held to those phases' timed runs (f32x_run, f32_run), then the
    dry runs over the same ranks and over one NCCL rank (dry_runs, the
    ranks start_dry_runs started). prep, computed beside the children:
    "blocks" (rank_blocks) and "est_ref" ({b: estimation_reference at b
    members}). Returns the phase's kernel launches, every rank's."""
    from rmt_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        ref_ys = z["dme_ys"]
    est_ref = prep["est_ref"]
    total = {}

    def launched(name, counts, kernels, stats, opts):
        launches = check_launches(name, (counts,), kernels,
                                  SimpleNamespace(**stats), opts)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    ranks = dryrun.start(mesh_worker, MESH_RANKS, "gloo", dev,
                         store).results(RANKS_TIMEOUT_S)
    say(f"mesh: {MESH_RANKS} gloo ranks on {dev}: the sweeps' ranks "
        f"ended in {time.perf_counter() - t0:.1f} s")
    mesh_sweep_checks(torch, np, ranks, f32x_run, f32_run, ref_ys,
                      prep["blocks"], launched)
    t0 = time.perf_counter()
    dry = {backend: dryrun.dryrun_results(launch, RANKS_TIMEOUT_S)
           for backend, launch in dry_runs.items()}
    say(f"mesh (c) dry runs over {MESH_RANKS} gloo ranks and 1 NCCL rank "
        f"on {dev}, at once beside phases 5-14: "
        + ", ".join(f"{backend} {launch.wall:.1f} s"
                    for backend, launch in dry_runs.items())
        + f" from their start to their last rank's result (waited "
        f"{time.perf_counter() - t0:.1f} s here)")
    for backend, res in dry.items():
        say(f"mesh (c) {backend}: rank 0's seconds by phase "
            + json.dumps({k: round(v, 3) for k, v in res["walls"].items()}))
    ns_defaults = dict(j_every=16, ns_refresh=5, ns_step=1)
    for backend, res in dry.items():
        loss, grads = est_ref[2 * DRY_RUNS[backend]]
        est = res["estimation"]
        err = max([abs(est["loss"] - loss) / abs(loss)]
                  + [abs(est["grads"][k] - g) / abs(g)
                     for k, g in grads.items()])
        say(f"mesh (c) {backend}: estimation loss {est['loss']!r} "
            f"(unsharded {loss!r}), largest relative difference of "
            f"loss and gradient {err:.3e} (bar 1e-12)")
        check(err <= 1e-12, f"mesh (c) {backend}: the estimation step "
              "differs from the unsharded step")
        for r, counts in enumerate(res["launches_by_rank"]):
            for run_name, kernels, opts in (
                    ("lockstep", F32_KERNELS,
                     dict(dryrun.LOCKSTEP, **ns_defaults)),
                    ("lockstep_f32x", F32X_KERNELS, dryrun.F32X)):
                launched(f"mesh (c) {backend} {run_name} rank {r}",
                         counts[run_name], kernels,
                         res[run_name]["stats"], opts)
            for ph in ("estimation", "m13"):
                check(not any(counts[ph].values()),
                      f"mesh (c) {backend}: {ph} launched a kernel")
    say(f"mesh: phase wall {time.perf_counter() - t_phase:.3f} s")
    return total


def newton_system(torch, np, b, device):
    """(f, r, member) of b independent cubic systems x**3 + p x + C x = q
    in NEWTON_N unknowns (numpy seed SEED; p > 0 per member, C a shared
    positive semidefinite coupling, so the root r is unique) on device:
    f(x (b, n)) the batched residual, member(i) member i's f(x (n,))."""
    rng = np.random.default_rng(SEED)
    on = lambda a: torch.as_tensor(a, device=device)
    p = on(rng.uniform(0.5, 2.0, (b, NEWTON_N)))
    L = 0.3 * rng.standard_normal((NEWTON_N, NEWTON_N))
    C = on(L @ L.T)
    r = on(rng.uniform(-2.0, 2.0, (b, NEWTON_N)))
    q = r ** 3 + p * r + r @ C

    def f(x):
        return x ** 3 + p * x + x @ C - q

    def member(i):
        return lambda x: x ** 3 + p[i] * x + x @ C - q[i]

    return f, r, member


def est_phase(torch, np, bench_est, counts, dev):
    """Adjoint-gradient estimation and Newton on the card (see the module
    docstring, phase 9): every check exits nonzero; no kernel may
    launch."""
    from rmt_tpu_torch.parallel import (outlet_mole_fractions,
                                        simulate_n2_implicit)
    from rmt_tpu_torch.solvers import newton

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.max(np.abs(got - want) / np.abs(want)))

    def vals(d):
        return np.array([float(d[k]) for k in bench_est.THETA0])

    def step_on(device, b):
        step, theta0, params, spec = bench_est.build(b, device)
        loss, grads, mf = step.value_and_grad(theta0, params)
        new = {k: theta0[k] - step.lr * grads[k] for k in theta0}
        return dict(loss=float(loss), grads=vals(grads), theta_new=vals(new),
                    mf=mf.cpu().numpy(), theta0=theta0, params=params,
                    spec=spec)

    reset_counts(counts)
    t_phase = time.perf_counter()
    step, theta0, params, spec = bench_est.build(EST_B, dev)
    step.value_and_grad(theta0, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads, mf = step.value_and_grad(theta0, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g = vals(grads)
    say(f"est: estimation step B {EST_B} (n {spec.var_no_n2 * spec.z_no}, "
        f"{bench_est.N_STEPS} steps): wall {wall:.3f} s, members/s "
        f"{EST_B / wall:.3f} (forward and adjoint), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; loss "
        f"{float(loss):.12e}, gradients {g.tolist()}")
    check(np.isfinite(float(loss)) and np.isfinite(g).all(),
          "est: non-finite loss or gradient at B = 512")

    # the B = 8 sweep's inlet temperatures are these rows' (511 = 7 x 73)
    rows = np.arange(0, EST_B, (EST_B - 1) // (EST_REF_B - 1))
    check(np.array_equal(bench_est.inlet_temperatures(EST_B)[rows],
                         bench_est.inlet_temperatures(EST_REF_B)),
          "est: the B = 8 members are not members of the B = 512 sweep")
    card8 = step_on(dev, EST_REF_B)
    d_b = rel(mf[rows].cpu().numpy(), card8["mf"])
    cpu8 = step_on(torch.device("cpu"), EST_REF_B)
    d_cpu = max(rel(card8["loss"], cpu8["loss"]),
                rel(card8["theta_new"], cpu8["theta_new"]))
    with np.load(os.path.join(ROOT, "estimation_ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    d_ref = {"loss": rel(card8["loss"], ref["loss"]),
             "grads": rel(card8["grads"], ref["grads"]),
             "outlet": rel(card8["mf"], ref["outlet"]),
             "theta_new": rel(card8["theta_new"], ref["theta_new"])}
    say(f"est: B {EST_REF_B} members (rows {rows[1]} apart of the B = "
        f"{EST_B} sweep): outlet mole fractions against their B = {EST_B} "
        f"rows {d_b:.4e} (bar 1e-10); loss and theta_new against the same "
        f"step on the CPU {d_cpu:.4e} (bar 1e-9); against "
        f"estimation_ref.npz (rmt_tpu, CPU float64) {json.dumps(d_ref)} "
        f"(bar 1e-8)")
    check(d_b <= 1e-10, f"est: a member differs from its B = {EST_B} row "
          f"by {d_b}")
    check(d_cpu <= 1e-9, f"est: card and CPU steps differ by {d_cpu}")
    check(max(d_ref.values()) <= 1e-8,
          f"est: the step differs from estimation_ref.npz: {d_ref}")

    # the adjoint gradient in K1 of one member against central differences
    spec, base = card8["spec"], card8["params"]
    one = dict(base, T0=base["T0"][0])
    w = torch.arange(1.0, spec.n_comp + 1, dtype=torch.float64, device=dev)

    def functional(theta_log):
        yf = simulate_n2_implicit(
            spec, one, {k: torch.exp(v) for k, v in theta_log.items()},
            bench_est.N_STEPS)
        return torch.sum(w * outlet_mole_fractions(spec, yf))

    th = {k: v.clone().requires_grad_() for k, v in card8["theta0"].items()}
    ad = float(torch.autograd.grad(functional(th), [th["K1"]])[0])
    eps = 1e-4
    k1 = card8["theta0"]["K1"]
    with torch.no_grad():
        side = [float(functional(dict(card8["theta0"], K1=k1 + sgn * eps)))
                for sgn in (1.0, -1.0)]
    fd = (side[0] - side[1]) / (2 * eps)
    d_fd = abs(ad - fd) / max(abs(fd), abs(ad), 1e-3)
    say(f"est: d/dK1 of one member's weighted outlet functional: adjoint "
        f"{ad:.10e}, central difference {fd:.10e}, relative {d_fd:.4e} "
        f"(bar 2e-4)")
    check(d_fd <= 2e-4, f"est: adjoint and central difference differ by "
          f"{d_fd}")

    # Newton to a residual of 1e-12 (the default 1e-10 stops up to 5e-10
    # from the root); errors against the root over max(|r|, 1)
    def root_err(x, r):
        return float(((x.cpu() - r).abs() / r.abs().clamp(min=1.0)).max())

    t0 = time.perf_counter()
    f, r, member = newton_system(torch, np, SEQ_B, dev)
    nb = newton.root_batched(f, torch.zeros_like(r), tol=1e-12)
    torch.cuda.synchronize()
    t_newton = time.perf_counter() - t0
    f_h, r_h, _ = newton_system(torch, np, SEQ_B, torch.device("cpu"))
    nh = newton.root_batched(f_h, torch.zeros_like(r_h), tol=1e-12)
    e_root = root_err(nb.x, r_h)
    e_cpu = float((nb.x.cpu() - nh.x).abs().max())
    same_it = torch.equal(nb.iterations.cpu(), nh.iterations)
    n1 = newton.root(member(0), torch.zeros_like(r[0]), tol=1e-12)
    e_one = root_err(n1.x, r_h[0])
    say(f"est: root_batched B {SEQ_B}, n {NEWTON_N}: {t_newton:.3f} s, "
        f"converged {int(nb.converged.sum())}, iterations max "
        f"{int(nb.iterations.max())}, error against the closed form "
        f"{e_root:.4e} (bar 1e-10); against the CPU: states "
        f"{e_cpu:.4e} (bar 1e-12), equal iteration counts {same_it}; root "
        f"on member 0: {int(n1.iterations)} iterations (root_batched "
        f"{int(nb.iterations[0])}), converged {bool(n1.converged)}, "
        f"error {e_one:.4e} (bar 1e-10)")
    check(bool(nb.converged.all()), "est: a Newton member did not converge")
    check(e_root <= 1e-10, f"est: root_batched off the root by {e_root}")
    check(e_cpu <= 1e-12 and same_it,
          f"est: root_batched card and CPU differ ({e_cpu}, {same_it})")
    check(bool(n1.converged) and e_one <= 1e-10,
          f"est: root on one member off the root by {e_one}")

    launches = {k: v for table in counts for k, v in table.items()}
    say(f"est: kernel launches {launches} (the estimation path runs none)")
    check(not any(launches.values()),
          f"est: a kernel launched on the estimation path: {launches}")
    say(f"est: phase wall {time.perf_counter() - t_phase:.3f} s")


def start_host_phases(ref_n1_path):
    """A child process running phases 8 and 9 (seq and est: the float64
    paths bound by the host, which launch none of the kernels) on the
    card while this process works, the N1 reference at ref_n1_path
    (.npy); it prints their lines and, last, a JSON object of their
    walls."""
    code = "\n".join((
        f"import sys; sys.path[:0] = [{ROOT!r}, "
        f"{os.path.join(ROOT, 'scripts')!r}]",
        "import chip_smoke",
        f"chip_smoke.host_phases({ref_n1_path!r})"))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def host_phases(ref_n1_path):
    """Phases 8 and 9 in the child start_host_phases starts; a failing
    check exits nonzero."""
    import numpy as np
    import torch

    import bench_torch_estimation as bench_est
    import bench_torch_seq as bench_seq
    from rmt_tpu_torch.ops import cuda_block, cuda_ns, cuda_rhs

    dev = torch.device("cuda:0")
    counts = (cuda_block.LAUNCHES, cuda_rhs.LAUNCHES, cuda_ns.LAUNCHES)
    walls = {}
    for label, fn, args in (
            ("seq", seq_phase, (bench_seq, counts, dev,
                                np.load(ref_n1_path))),
            ("est", est_phase, (bench_est, counts, dev))):
        t0 = time.perf_counter()
        fn(torch, np, *args)
        walls[label] = time.perf_counter() - t0
    print(json.dumps(walls), flush=True)


def host_phases_result(proc):
    """The seq and est child's lines, printed here, and its phases' walls.
    A failed child exits this run nonzero."""
    t0 = time.perf_counter()
    sout, serr = proc.communicate(timeout=900)
    check(proc.returncode == 0, "seq/est: the child failed: "
          + serr.decode(errors="replace")[-2000:])
    lines = sout.decode().strip().splitlines()
    for line in lines[:-1]:
        say(line)
    say(f"seq/est: child ready (waited {time.perf_counter() - t0:.1f} s); "
        "its phase walls (s): " + json.dumps(
            {k: round(v, 1) for k, v in json.loads(lines[-1]).items()}))


def main():
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a card")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    import bench_torch_estimation as bench_est
    import bench_torch_n1 as bench_n1
    import bench_torch_seq as bench_seq
    import rmt_tpu_torch  # noqa: F401 (its import turns TF32 off: header)

    dev = torch.device("cuda:0")
    card = header(torch)
    ref_proc = start_n1_reference()
    children = [ref_proc]
    benches = SimpleNamespace(n1=bench_n1, seq=bench_seq, est=bench_est)
    store = tempfile.TemporaryDirectory()
    try:
        phases(torch, np, card, dev, benches, ref_proc, children, t_start,
               store.name)
    finally:
        for proc in children:
            if isinstance(proc, subprocess.Popen):
                if proc.poll() is None:
                    proc.kill()
                proc.communicate()
            else:  # the ranks of a dry run (dryrun.Launch)
                proc.stop()
        store.cleanup()


def phases(torch, np, card, dev, benches, ref_proc, children, t_start,
           store):
    from torch.func import vmap

    from rmt_tpu_torch.cases import ch4_case, dme_case
    from rmt_tpu_torch.kinetics.dsl import accurate_f32_math
    from rmt_tpu_torch.models import homo
    from rmt_tpu_torch.ops import _build, cuda_block, cuda_ns, cuda_rhs
    from rmt_tpu_torch.parallel import (dryrun, prepare_n2_ensemble,
                                        run_n2_ensemble_lockstep)
    from rmt_tpu_torch.parallel.ensemble import _cast
    from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

    mi = dme_case.make_model_input(model="N2")
    mi_ch4 = ch4_case.make_model_input(model="N2")
    ens = prepare_n2_ensemble(mi, {"T0": 523.0 + np.linspace(-5.0, 5.0, B)},
                              device=dev)
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        b_ch4 = len(z["ch4_offsets"])
        t0_ch4 = float(z["ch4_t_base"]) + z["ch4_offsets"]
    ens_ch4 = prepare_n2_ensemble(mi_ch4, {"T0": t0_ch4}, device=dev)
    with z_no_of(homo, WIDE_Z):
        ens30 = prepare_n2_ensemble(
            mi, {"T0": 523.0 + np.linspace(-5.0, 5.0, F32_WIDE_B)},
            device=dev)

    def fused(e, accurate_math=True):
        """The RHS functions of a chemistry: plain, df32 and, with
        accurate_math, the plain mode's accurate-math variant."""
        with accurate_f32_math(False):
            fns = {mode: cuda_rhs.build_n2_fused(
                e.spec, accurate_rates=mode, ko_keys=e.ko_keys)
                for mode in (False, "df32")}
        if accurate_math:
            with accurate_f32_math(True):
                fns["am"] = cuda_rhs.build_n2_fused(e.spec,
                                                    ko_keys=e.ko_keys)
        return fns

    rhs_fns, rhs_ch4 = fused(ens), fused(ens_ch4)
    rhs_30 = fused(ens30, accurate_math=False)
    # the mesh phase's dry run integrates phase 2's chunk at zNo 8: its
    # ranks load these libraries, none builds one
    with dryrun.n2_grid(8, 2):
        rhs_8 = fused(prepare_n2_ensemble(
            mi, dryrun.lockstep_sweep(2), device=dev), accurate_math=False)
    t0 = time.perf_counter()
    block_src = (_build.CSRC / "block.cu").read_text()
    _build.compile_sources(
        [("block", block_src), cuda_ns.build_job(), cuda_ns.wide_build_job()]
        + [(f.kernel_name, f.source())
           for f in (*rhs_fns.values(), *rhs_ch4.values(),
                     *rhs_30.values(), *rhs_8.values())])
    say(f"build: {time.perf_counter() - t0:.1f} s (nvcc, all sources at "
        f"once, into {_build.build_dir()})")
    # registers, spills and static shared memory of every kernel the paths
    # launch (the block kernels at the two chemistries' m = 7 and m = 4)
    for label, path in (("block.cu", _build.library_path("block", block_src)),
                        ("ns.cu", _build.library_path(*cuda_ns.build_job())),
                        ("ns_wide.cu",
                         _build.library_path(*cuda_ns.wide_build_job())),
                        *((f"{f.kernel_name} ({chem})",
                           _build.library_path(f.kernel_name, f.source()))
                          for chem, fns in (("dme", rhs_fns),
                                            ("ch4", rhs_ch4))
                          for f in fns.values())):
        for kern, regs, sst, sld, smem in _build.compiler_report(path):
            if label == "block.cu" and not re.search(r"<[47][,>]", kern):
                continue
            say(f"build: {label}: {kern}: {regs} registers, spill stores "
                f"{sst} B, spill loads {sld} B, static shared {smem} B")

    tableau = _transformed_tableau()
    res = block_phase(torch, np, cuda_block, tableau, dev)
    f64 = torch.float64
    rhs64_b = vmap(homo.make_n2_rhs(ens.spec), in_dims=(None, 0, ens.axes, 0))
    p64, d64 = _cast(ens.params, f64), _cast(ens.d, f64)
    res.update(rhs_phase(torch, np, cuda_rhs, rhs_fns, ens,
                         lambda y: rhs64_b(0.0, y.to(f64), p64, d64)))
    rhs_guard(torch, np, cuda_rhs, rhs_ch4, ens_ch4)

    # the f32 leg's Jacobian and first step, as the integrator forms them
    jacB = vmap(homo.make_n2_colored_jacobian(ens.spec),
                in_dims=(0, 0, ens.axes, 0))
    t_first = torch.full((B,), float(ens.ts[0]), device=dev)
    J = jacB(t_first, ens.y0, ens.params, ens.d).contiguous()
    j_norm = torch.amax(torch.sum(torch.abs(J), dim=-1), dim=-1)
    gamma = float(tableau[4][0].real)
    h0 = torch.clamp(0.05 / (gamma * j_norm + 1e-30),
                     max=1e-3 * float(ens.ts[-1] - ens.ts[0]))
    res.update(ns_phase(torch, np, cuda_ns, tableau, J, h0, dev))
    del J
    res["ns_fused_step"]["n1_shape"] = ns_n1_phase(
        torch, cuda_ns, tableau, n1_jacobians(torch, benches.n1, dev, gamma))
    # the wide route at the f32_wide leg's Jacobian and first step
    jac30 = vmap(homo.make_n2_colored_jacobian(ens30.spec),
                 in_dims=(0, 0, ens30.axes, 0))
    J30 = jac30(torch.full((F32_WIDE_B,), float(ens30.ts[0]), device=dev),
                ens30.y0, ens30.params, ens30.d).contiguous()
    h30 = torch.clamp(
        0.05 / (gamma * torch.amax(torch.sum(torch.abs(J30), dim=-1), dim=-1)
                + 1e-30), max=1e-3 * float(ens30.ts[-1] - ens30.ts[0]))
    res["ns_fused_step_wide"] = ns_wide_phase(torch, np, cuda_ns, tableau,
                                              J30, h30, dev)
    del J30
    for k, v in (*res.items(),
                 ("ns_fused_step (N1 shape)", res["ns_fused_step"]["n1_shape"]),
                 ("ns_fused_step_wide (n = 420)",
                  res["ns_fused_step_wide"]["n420"])):
        lib = ("none" if v["library_ms"] is None
               else f"{v['library_ms']:.4f} ms")
        say(f"time {k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} "
            f"ms, library {lib}, bound {v['bound_ms']:.4f} ms by "
            f"{v['bound_by']} ({v['bound_ms'] / v['ms']:.3f} of it; median "
            f"of {REPS} x {GROUP} calls); queued on the card "
            f"{v['card_ms']:.4f} ms; the wrapper's host time "
            f"{v['host_ms']:.4f} ms a call; on {card}")

    walls = {"header, build and kernels": time.perf_counter() - t_start}

    def phase(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[label] = time.perf_counter() - t0
        say(f"phase wall: {label} {walls[label]:.1f} s")
        return out

    counts = (cuda_block.LAUNCHES, cuda_rhs.LAUNCHES, cuda_ns.LAUNCHES)
    f32x_run, f32_run = {}, {}
    by_path = {
        "f32x": phase(
            "f32x sweep", sweep_phase, torch, np, mi,
            run_n2_ensemble_lockstep, counts, dev, name="f32x sweep",
            chem="dme", b=B, opts=F32X, bar=1e-6, kernels=F32X_KERNELS,
            keep=f32x_run),
        "f32": phase(
            "f32 sweep", sweep_phase, torch, np, mi,
            run_n2_ensemble_lockstep, counts, dev, name="f32 sweep",
            chem="dme", b=B, opts=F32, bar=5e-5, kernels=F32_KERNELS,
            keep=f32_run),
    }
    # from here on, the children run the host-bound work (sequential Radau
    # integrations and Newton solves of one state each, the float64 paths,
    # the dry runs' small batches) beside this process's phases: the card
    # then interleaves several processes' launches
    ref_n1 = n1_reference(np, ref_proc)
    ref_n1_path = os.path.join(store, "ref_n1.npy")
    np.save(ref_n1_path, ref_n1)
    host_proc = start_host_phases(ref_n1_path)
    steady_proc = start_steady_models()
    het_proc = start_hetero_models()
    dyn_procs = [start_dyn_models(calls) for calls in DYN_CHILDREN]
    children += [host_proc, steady_proc, het_proc, *dyn_procs]
    dry_runs = start_dry_runs(dev, store)
    children += dry_runs.values()
    by_path["ch4_f32x"] = phase(
        "ch4 guard", sweep_phase, torch, np, mi_ch4,
        run_n2_ensemble_lockstep, counts, dev, name="ch4 guard",
        chem="ch4", b=b_ch4, opts=F32X, bar=1e-6, kernels=F32X_KERNELS)
    by_path["n1"] = phase("n1 sweep", n1_phase, torch, np, benches.n1,
                          counts, dev, ref_n1)
    phase("microbatch", microbatch_phase, torch, np, mi,
          run_n2_ensemble_lockstep, dev)
    wide = phase("f32_wide", f32_wide_phase, torch, np, homo, mi,
                 run_n2_ensemble_lockstep, counts, dev)
    by_path["f32_wide_f32x"], by_path["f32_wide_f32"] = wide["f32x"], \
        wide["f32"]
    by_path["m2"] = phase("models", models_phase, torch, np, benches.seq,
                          counts, dev)
    # the mesh phase's own runs on this process: phase 4's sweep on the
    # ranks' blocks and the dry runs' estimation step
    mesh_prep = phase("mesh prep", lambda: {
        "blocks": rank_blocks(torch, np, mi, run_n2_ensemble_lockstep, dev),
        "est_ref": {b: estimation_reference(torch, dev, b)
                    for b in (2 * n for n in DRY_RUNS.values())}})
    by_path["n2_opts"] = phase("n2_opts", n2_opts_phase, torch, np, mi,
                               run_n2_ensemble_lockstep, counts, dev)
    # the children's results, then the mesh phase alone on the card
    phase("seq and est results", host_phases_result, host_proc)
    phase("models results", models_children, steady_proc)
    phase("steady_het", steady_het_phase, torch, np, benches.seq, counts,
          dev, het_proc)
    phase("dyn_het", dyn_het_phase, torch, np, benches.seq, counts, dev,
          dyn_procs)
    by_path["mesh"] = phase("mesh", mesh_phase, torch, np, dev, f32x_run,
                            f32_run, store, dry_runs, mesh_prep)
    say("phase walls (s): " + json.dumps(
        {k: round(v, 1) for k, v in walls.items()}))
    say(f"whole run: {time.perf_counter() - t_start:.1f} s")

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
        "n2_rhs_plain_am": ("rmt_tpu_torch/ops/cuda_rhs.py",
                            "rmt_tpu/ops/pallas_rhs.py:340"),
        "ns_fused_step": ("rmt_tpu_torch/csrc/ns.cu",
                          "rmt_tpu/ops/pallas_ns.py:112"),
        "ns_fused_step_wide": ("rmt_tpu_torch/csrc/ns_wide.cu",
                               "rmt_tpu/ops/pallas_ns.py:112"),
    }
    # launches: the main paths' runs together (the two DME legs' timed
    # runs, the N1 sweep, both f32_wide legs, rmtExe M2, the n2_opts
    # checks and the mesh phase's ranks); each path's own count rides
    # along (the CH4 guard's too)
    main_paths = ("f32x", "f32", "n1", "f32_wide_f32x", "f32_wide_f32", "m2",
                  "n2_opts", "mesh")
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=sum(by_path[p][k] for p in main_paths),
                    launches_by_path={p: v[k] for p, v in by_path.items()},
                    **res[k])
               for k, (src, rep) in sources.items()]
    say(json.dumps({"kernels": kernels}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
