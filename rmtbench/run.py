#!/usr/bin/env python3
"""Run one cell of the benchmark of rmt_tpu_torch once, on this machine.

    python3 rmtbench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, this folder and
rmt_tpu_torch. The program's kernels are built into .rmtbench_cache/ in
the checkout (the first run of a checkout builds them; later runs load
them). With --trace 0 the last line of standard output is the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, each as one
JSON object with correct, attempted, failed, metrics and device (and
breakdown with --trace 1), and checks last: each number compared with
its limit, also printed as the last lines of standard error. Exits
nonzero, printing no result, without a CUDA card (or with fewer than
the cell asks for), when the cell's files are missing, or when jax,
jaxlib, flax or rmt_tpu were loaded by the end of the window.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".rmtbench_cache")


def pin_caches():
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths."""
    os.environ["RMT_TORCH_BUILD_DIR"] = os.path.join(CACHE, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    pin_caches()
    sys.path.insert(0, ROOT)
    from rmtbench import harness

    try:
        cell = harness.load_cell(args.workload, ROOT)
    except (OSError, KeyError, ValueError, harness.CellError) as e:
        sys.exit(f"rmtbench: {type(e).__name__}: {e}")
    import torch

    chips = int(cell.workload["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        sys.exit(f"rmtbench: {args.workload} needs {chips} CUDA card(s); "
                 f"this machine has {have}")
    try:
        res = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace), ROOT,
            "cuda:0", t_process=T_PROCESS,
            card=torch.cuda.get_device_name(0))
    except Exception:
        traceback.print_exc()
        sys.exit("rmtbench: the run failed; no result")
    found = harness.forbidden_modules()
    if found:
        sys.exit(f"rmtbench: loaded {', '.join(found)}; no result")
    print(f"card: {power_limit()}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
