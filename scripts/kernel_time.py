#!/usr/bin/env python3
"""Time the port's kernels alone, one tree at a time, on one CUDA card.

    python3 scripts/kernel_time.py [--root DIR] [--label NAME]
        [--only rhs block ns] [--ns-alt OTHER.cu ...] [--sass] [--profile]
        [--B 4096] [--n 140]

Imports rmt_tpu_torch from --root (default: this repository) and calls
only its public wrappers, with the operands and timers of this
repository's chip_smoke.py. So another tree (a parent commit unpacked
with ``git archive`` into a git-ignored directory, or a copy with an
experiment in it) is timed the same way as this one: run the script once
per tree, in turns (parent, change, change, parent), each with its own
RMT_TORCH_BUILD_DIR, inside one call on one card. Builds only the
libraries of the chosen kernels, all nvcc processes at once, and prints
the compiler's registers and spills of each.

  rhs    the DME fused RHS wrappers, plain and df32, at M = 3B rows of
         chip_smoke's perturbed state, each first held bit for bit to its
         twin (also at the ragged M = 300 rows);
  block  block_factor, block_apply and block_apply_real on chip_smoke's
         random stiff systems, each held bit for bit to its twin at B
         and at the ragged B = 100;
  ns     ns_fused_step at B members of edge n on random stiff Jacobians,
         with iterates three twin steps past the cold seed, held to its
         twin (2e-5 on the iterates, scaled by 1 + |twin|, and on rho
         relative), through the route cuda_ns.route(n) picks: csrc/ns.cu
         up to n = 160, csrc/ns_wide.cu above (its geometry, resident
         blocks a SM where the tree's library reports them, registers and
         spills are printed); and so each --ns-alt source (another kernel
         with the C interface of csrc/ns.cu: ns_fused_step_launch and
         ns_fused_step_blocks_per_sm), which only the one-block route's
         widths take; the script stops if the tree's kernel fails and
         exits nonzero at the end if an alt did.

rhs and block are timed with chip_smoke.time_ms (median of 25 samples of
5 back-to-back calls between CUDA events: chip_smoke's "ms"),
chip_smoke.card_time_ms (the same with the calls queued behind a sleep of
the card: the card's work) and chip_smoke.host_ms (the wrapper's host
time a call); block_factor and block_apply_real also with cold_ms (one
call a sample, queued behind a 128 MB write that evicts the L2: their
operands fit it, so back-to-back calls may read them from there). ns
times, in turns, the kernel, each alt, the three-bmm formulation twice,
each alt and the kernel again (time_ms), and prints
TFLOP/s of the 8 * 2 n^3 operations a member needs and the share of the
roofline bound (chip_smoke.bound). With --profile, torch.profiler sums
the device time of each kernel that 20 calls of each rhs and block
wrapper launch (a wrapper that copies its operands shows the copy beside
the kernel). With --sass, cuobjdump counts each library's instructions by
kernel and its most frequent opcodes (the listing goes beside the
library, as .sass). Prints the card's name and power limit first and one
JSON line last.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_counts(lib_path):
    """{kernel: (instructions, Counter of base opcodes)} from cuobjdump;
    the listing is written beside the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    lib_path.with_suffix(".sass").write_text(text)
    res, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            res[fn] = [0, collections.Counter()]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and fn:
            res[fn][0] += 1
            res[fn][1][m.group(1)] += 1
    return res


def cold_ms(cs, torch, fn, flush):
    """Median over cs.REPS samples of one call's milliseconds between CUDA
    events, each call queued behind a write of `flush` (more than the
    H100's 50 MB L2) and a sleep of the card: the card's time for a call
    that reads its operands from device memory."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(cs.REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(cs.SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# block_factor's and block_apply_real's operands (64 and 37 MB) fit the
# 50 MB L2, so their back-to-back calls may read them from there
COLD = ("block_factor", "block_apply_real")


def wrapper_times(cs, torch, calls):
    """{name: chip_smoke.kernel_times} of each wrapper call, and cold_ms
    for the names in COLD."""
    res, flush = {}, None
    for name, fn in calls.items():
        res[name] = cs.kernel_times(torch, fn, host_calls=200)
        if name in COLD:
            if flush is None:
                flush = torch.empty(32 << 20, device="cuda")  # 128 MB
            res[name]["cold_ms"] = cold_ms(cs, torch, fn, flush)
    return res


def rhs_calls(cs, torch, np, cuda_rhs, fns, ens):
    """The RHS wrappers at M = 3B, each held bit for bit to its twin at
    M = 3B and the ragged M = 300 first."""
    y = cs.perturbed_state(torch, np, ens)
    y3 = torch.cat([y, y * 1.01, y * 0.99], dim=0)
    for mode, f in fns.items():
        for yy, l1, l2 in ((y3, ens.leaves1, ens.leaves2),
                           cs.ragged_rows(torch, y, ens)):
            got = f(yy, l1, l2)
            want = cuda_rhs.n2_rhs_twin(ens.spec, mode == "df32",
                                        ens.ko_keys, yy, l1, l2)
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            cs.say(f"check {f.kernel_name}: M = {yy.shape[0]}: max_abs_err "
                   f"{diff} against its twin")
            cs.check(diff == 0.0, f"{f.kernel_name} differs from its twin")
    return {f.kernel_name: (lambda f=f: f(y3, ens.leaves1, ens.leaves2))
            for f in fns.values()}


def block_calls(cs, torch, np, cuda_block, tableau, dev):
    """The three block wrappers at B members, each held bit for bit to its
    twin at B and at the ragged B = 100 first."""
    x = cs.block_inputs(torch, np, cuda_block, tableau, dev)
    kw, coef = x.kw, x.coef
    fk = cuda_block.block_factor(x.Jd_t, x.h_t, **kw)
    # name: (wrapper, twin, operands)
    pairs = {
        "block_factor": (
            lambda *a: cuda_block.block_factor(*a, **kw),
            lambda *a: cuda_block.block_factor_twin(
                *a, kw["gamma"], kw["mu_r"], kw["mu_i"]),
            (x.Jd_t, x.h_t)),
        "block_apply": (
            lambda *a: cuda_block.block_apply(*a, coef=coef),
            lambda *a: cuda_block.block_apply_twin(*a, coef),
            (x.R_t, *fk, x.Jl_t, x.h_t)),
        "block_apply_real": (
            lambda *a: cuda_block.block_apply_real(*a, gamma=kw["gamma"]),
            lambda *a: cuda_block.block_apply_real_twin(*a, kw["gamma"]),
            (x.e_t, fk[0], x.Jl_t, x.h_t)),
    }
    cut = lambda t: t[..., :cs.RAGGED_B].contiguous()
    for name, (kern, twin, args) in pairs.items():
        for a in (args, tuple(map(cut, args))):
            got, want = kern(*a), twin(*a)
            torch.cuda.synchronize()
            if name != "block_factor":
                got, want = (got,), (want,)
            diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
            cs.say(f"check {name}: B = {a[0].shape[-1]}: max_abs_err {diff} "
                   f"against its twin")
            cs.check(diff == 0.0, f"{name} differs from its twin")
    return {name: (lambda kern=kern, args=args: kern(*args))
            for name, (kern, _, args) in pairs.items()}


def profile_split(torch, calls):
    """{call: {device kernel: ms a call}} over 20 calls of each."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
                continue
            dt = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
            if dt > 0 and evt.count:
                res.setdefault(name, {})[evt.key[:70]] = dt / 1e3 / 20
    return res


def ns_times(cs, torch, cuda_ns, libs, B, n, dev):
    """ns_fused_step of each library held to its twin and timed in turns
    with the three-bmm formulation; returns (times, failed alts)."""
    from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

    w = _transformed_tableau()[4]
    eig = dict(gamma=float(w[0].real), mu_r=float(w[1].real),
               mu_i=float(w[1].imag))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    diag = 1.0 + 49.0 * torch.rand((B, 1, 1), generator=gen, device=dev)
    J = (-torch.eye(n, device=dev) * diag
         + 0.3 * torch.randn((B, n, n), generator=gen, device=dev))
    h = 0.005 + 0.015 * torch.rand((B,), generator=gen, device=dev)
    P = cuda_ns.ns_cold_start(J, h, **eig)
    for _ in range(3):
        *P, _ = cuda_ns.ns_fused_step_twin(J, *P, h, *eig.values())
    P = tuple(p.contiguous() for p in P)
    want = cuda_ns.ns_fused_step_twin(J, *P, h, *eig.values())
    ws = cuda_ns.Workspace(B, n, dev)

    failed = []
    for name, lib in libs.items():
        got = cuda_ns.ns_fused_step(J, *P, h, **eig, workspace=ws, lib=lib)
        torch.cuda.synchronize()
        err = max(float(((g.double() - t.double()).abs()
                         / (1.0 + t.double().abs())).max())
                  for g, t in zip(got[:3], want[:3]))
        rho_rel = float(((got[3] - want[3]).abs()
                         / want[3].abs().clamp(min=1e-3)).max())
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ok = finite and err <= 2e-5 and rho_rel <= 2e-5
        cs.say(f"check {name}: {err:.3e} from the twin (bar 2e-5), rho rel "
               f"{rho_rel:.3e} (bar 2e-5), finite {finite}: "
               f"{'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(name)
    main_name = next(iter(libs))
    if main_name in failed:
        raise SystemExit(f"kernel_time: the kernel of csrc/{main_name} "
                         "differs from its twin")

    def three_bmm():
        Pr, Pcr, Pci = P
        hh = h[:, None, None]
        JP = torch.bmm(J, torch.cat([Pr, Pcr, Pci], dim=-1))
        MPr = Pr - (eig["gamma"] * hh) * JP[..., :n]
        MPc_r = Pcr - hh * (eig["mu_r"] * JP[..., n:2 * n]
                            - eig["mu_i"] * JP[..., 2 * n:])
        MPc_i = Pci - hh * (eig["mu_r"] * JP[..., 2 * n:]
                            + eig["mu_i"] * JP[..., n:2 * n])
        Mc = torch.cat([MPc_r, MPc_i], dim=-1)
        Ar, Ai = torch.bmm(Pcr, Mc), torch.bmm(Pci, Mc)
        return (2 * Pr - torch.bmm(Pr, MPr), 2 * Pcr - (Ar[..., :n]
                                                         - Ai[..., n:]),
                2 * Pci - (Ai[..., :n] + Ar[..., n:]))

    def kernel(lib):
        return lambda: cuda_ns.ns_fused_step(J, *P, h, **eig, workspace=ws,
                                             lib=lib)

    # an alt that fails its check is timed all the same (an experiment
    # may compute something else on purpose) and reported as failed
    order = ([(k, kernel(lib)) for k, lib in libs.items()]
             + [("three bmm", three_bmm)] * 2
             + [(k, kernel(lib)) for k, lib in reversed(libs.items())])
    times = {}
    for name, fn in order:
        times.setdefault(name, []).append(cs.time_ms(torch, fn))
    return times, failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose rmt_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", nargs="+", choices=("rhs", "block", "ns"),
                    default=("rhs", "block", "ns"))
    ap.add_argument("--ns-alt", action="append", default=[],
                    help="another ns.cu source with the same C interface")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--B", type=int, default=4096,
                    help="members of the ns kernel's operands")
    ap.add_argument("--n", type=int, default=140,
                    help="edge of the ns kernel's operands")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_time: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.root))
    import rmt_tpu_torch
    from rmt_tpu_torch.cases import dme_case
    from rmt_tpu_torch.ops import _build, cuda_block, cuda_ns, cuda_rhs
    from rmt_tpu_torch.parallel import prepare_n2_ensemble
    from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

    got_root = os.path.dirname(os.path.dirname(rmt_tpu_torch.__file__))
    if os.path.realpath(got_root) != os.path.realpath(args.root):
        raise SystemExit(f"imported rmt_tpu_torch from {got_root}, not "
                         f"{args.root}")
    dev = torch.device("cuda:0")
    card = cs.header(torch)
    result = {"label": args.label, "card": card}

    jobs, fns, ens = [], {}, None
    if "rhs" in args.only:
        ens = prepare_n2_ensemble(dme_case.make_model_input(model="N2"),
                                  {"T0": 523.0 + np.linspace(-5.0, 5.0,
                                                             cs.B)},
                                  device=dev)
        fns = {mode: cuda_rhs.build_n2_fused(ens.spec, accurate_rates=mode,
                                             ko_keys=ens.ko_keys)
               for mode in (False, "df32")}
        jobs += [(f.kernel_name, f.source()) for f in fns.values()]
    if "block" in args.only:
        jobs.append(("block", (_build.CSRC / "block.cu").read_text()))
    ns_names = []
    wide = "ns" in args.only and cuda_ns.route(args.n) == "wide"
    if wide and args.ns_alt:
        raise SystemExit(
            f"kernel_time: --ns-alt takes sources with csrc/ns.cu's C "
            f"interface, which holds n <= {cuda_ns.ONE_BLOCK_MAX_N}; n = "
            f"{args.n} takes the wide route (csrc/ns_wide.cu)")
    if "ns" in args.only:
        jobs.append(cuda_ns.wide_build_job() if wide else cuda_ns.build_job())
        ns_names.append("ns_wide.cu" if wide else "ns.cu")
        for path in args.ns_alt:
            stem = os.path.splitext(os.path.basename(path))[0]
            with open(path) as f:
                jobs.append((f"ns_alt_{stem}", f.read(),
                             _build.NVCC_FLAGS_FMA))
            ns_names.append(os.path.basename(path))
    t0 = time.perf_counter()
    paths = _build.compile_sources(jobs)
    cs.say(f"build: {time.perf_counter() - t0:.1f} s")
    for (name, *_), path in zip(jobs, paths):
        for line in path.with_suffix(".log").read_text().splitlines():
            if re.search("Compiling entry function|registers|spill", line):
                cs.say(f"build: {name}: {line.strip()}")
        if args.sass:
            for kern, (count, ops) in sass_counts(path).items():
                top = ", ".join(f"{k} {v}" for k, v in ops.most_common(14))
                cs.say(f"sass: {name}: {kern}: {count} instructions; {top}")
                result.setdefault("sass", {})[f"{name}:{kern}"] = count

    calls = {}
    if "rhs" in args.only:
        calls.update(rhs_calls(cs, torch, np, cuda_rhs, fns, ens))
    if "block" in args.only:
        calls.update(block_calls(cs, torch, np, cuda_block,
                                 _transformed_tableau(), dev))
    result["times"] = wrapper_times(cs, torch, calls)
    for name, t in result["times"].items():
        cold = (f", cold_ms {t['cold_ms']:.4f}" if "cold_ms" in t else "")
        cs.say(f"time {args.label}: {name}: ms {t['ms']:.4f}, card_ms "
               f"{t['card_ms']:.4f}{cold}, host_ms {t['host_ms']:.4f} on "
               f"{card}")
    if args.profile:
        result["profile"] = profile_split(torch, calls)
        for name, split in result["profile"].items():
            for kern, ms in split.items():
                cs.say(f"profile {args.label}: {name}: {kern}: {ms:.4f} ms "
                       f"of device time a call")

    failed = []
    if "ns" in args.only:
        B, n = args.B, args.n
        geo = cuda_ns.wide_geometry(n) if wide else cuda_ns.geometry(n)
        cs.say(f"ns geometry ({cuda_ns.route(n)}): {geo}")
        result["ns_geometry"] = geo._asdict()
        libs = {}
        for name, path in zip(ns_names, paths[len(paths) - len(ns_names):]):
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, "ns_wide_blocks_per_sm" if wide
                         else "ns_fused_step_blocks_per_sm", None)
            if fn is None or not hasattr(geo, "smem_bytes"):
                cs.say(f"build: {name}: this tree reports no resident blocks")
            else:
                fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
                blocks = fn(geo.threads, geo.smem_bytes)
                result.setdefault("ns_blocks_per_sm", {})[name] = blocks
                cs.say(f"build: {name}: {blocks} resident block(s) per SM "
                       f"at {geo.threads} threads, {geo.smem_bytes} bytes "
                       f"of dynamic shared memory")
            # the wrapper takes the wide route itself (lib=None)
            libs[name] = None if wide else cuda_ns.bind(lib)
        times, failed = ns_times(cs, torch, cuda_ns, libs, B, n, dev)
        ops = 16 * n ** 3 * B
        bnd = cs.bound(4 * (7 * B * n * n + 2 * B), ops)
        cs.say(f"ns bound: {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            tag = " (FAILED its check)" if name in failed else ""
            cs.say(f"time {args.label}: {name}{tag}: "
                   f"{' '.join(f'{t:.4f}' for t in ts)} ms -> {ms:.4f} ms, "
                   f"{ops / ms * 1e-9:.2f} TFLOP/s, "
                   f"{bnd['bound_ms'] / ms:.3f} of the bound (B = {B}, "
                   f"n = {n}) on {card}")
        result["ns_ms"] = times
    cs.say(card)
    print(json.dumps(result), flush=True)
    if failed:
        raise SystemExit(f"kernel_time: {failed} differ from the twin")


if __name__ == "__main__":
    main()
