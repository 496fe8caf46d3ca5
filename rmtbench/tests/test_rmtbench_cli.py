"""run.py exits nonzero and prints no result without a CUDA card, and in
a directory that holds only BENCHMARK.json and the benchmark's folder."""

import os
import subprocess
import sys

import pytest

from conftest import ROOT, copy_benchmark

ARGS = ["--workload", "dme_f32x_b131072", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def run(root):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "rmtbench/run.py", *ARGS],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    root = copy_benchmark(tmp_path)
    out = run(root)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_no_result():
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "rmtbench/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
