#!/usr/bin/env python3
"""Time the Newton-Schulz kernel (rmt_tpu_torch/csrc/ns.cu) alone, on one
CUDA card.

    python3 scripts/ns_kernel_time.py [--alt OTHER.cu ...] [--B 4096] [--n 140]

Builds only csrc/ns.cu (and each --alt source: another kernel with the
same C interface, ns_fused_step_launch and ns_fused_step_blocks_per_sm),
all nvcc processes at once, and prints each build's registers and spills.
On random stiff Jacobians at B members of edge n (the f32 leg's shape by
default), with iterates three twin steps past the cold seed, every
kernel is held to the plain PyTorch twin (2e-5 on the iterates, scaled
by 1 + |twin|, and on rho relative); the script stops if the kernel of
csrc/ns.cu is not, and exits nonzero at the end if an alt was not. Then it times, in turns inside this
process, the kernel, each alt, the three-bmm formulation twice, each alt
and the kernel again (chip_smoke.time_ms: median of 25 samples of 5
back-to-back calls between CUDA events), and prints ms, TFLOP/s of the
8 * 2 n^3 operations a member needs, and the share of the roofline bound
(chip_smoke.bound). Prints the card's name and power limit first.
"""

import argparse
import ctypes
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alt", action="append", default=[],
                    help="another .cu source with the same C interface")
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--n", type=int, default=140)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ns_kernel_time: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from rmt_tpu_torch.ops import _build, cuda_ns
    from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

    dev = torch.device("cuda:0")
    card = chip_smoke.header(torch)
    B, n = args.B, args.n
    geo = cuda_ns.geometry(n)
    print(f"geometry: {geo}", flush=True)

    jobs = [cuda_ns.build_job()]
    for path in args.alt:
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            jobs.append((f"ns_alt_{stem}", f.read(), _build.NVCC_FLAGS_FMA))
    t0 = time.perf_counter()
    paths = _build.compile_sources(jobs)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    names = ["ns.cu"] + [os.path.basename(p) for p in args.alt]
    libs = {}
    for name, path in zip(names, paths):
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)
        lib = cuda_ns.bind(ctypes.CDLL(str(path)))
        fn = lib.ns_fused_step_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
        print(f"build: {name}: {fn(geo.threads, geo.smem_bytes)} resident "
              f"block(s) per SM at {geo.threads} threads, "
              f"{geo.smem_bytes} bytes of dynamic shared memory",
              flush=True)
        libs[name] = lib

    w = _transformed_tableau()[4]
    eig = dict(gamma=float(w[0].real), mu_r=float(w[1].real),
               mu_i=float(w[1].imag))
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
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
        print(f"check {name}: {err:.3e} from the twin (bar 2e-5), rho rel "
              f"{rho_rel:.3e} (bar 2e-5), finite {finite}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(name)
    if "ns.cu" in failed:
        raise SystemExit("ns_kernel_time: the kernel of csrc/ns.cu differs "
                         "from its twin")

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
        times.setdefault(name, []).append(chip_smoke.time_ms(torch, fn))
    ops = 16 * n ** 3 * B
    bnd = chip_smoke.bound(4 * (7 * B * n * n + 2 * B), ops)
    print(f"bound: {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}", flush=True)
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        tag = " (FAILED its check)" if name in failed else ""
        print(f"time {name}{tag}: {' '.join(f'{t:.4f}' for t in ts)} ms -> "
              f"{ms:.4f} ms, {ops / ms * 1e-9:.2f} TFLOP/s, "
              f"{bnd['bound_ms'] / ms:.3f} of the bound (B = {B}, n = {n}) "
              f"on {card}", flush=True)
    if failed:
        raise SystemExit(f"ns_kernel_time: {failed} differ from the twin")


if __name__ == "__main__":
    main()
