"""Fixtures of the benchmark's tests: the repository on sys.path, the
`card` marker, and a temporary copy of the benchmark with a cell small
enough for the CPU (ch4_tiny: four CH4 members, the f32x options)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = "ch4_tiny"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def copy_benchmark(dest):
    """BENCHMARK.json and the benchmark's folder under ``dest``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "rmtbench"),
                    os.path.join(dest, "rmtbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return str(dest)


def add_tiny_cell(root):
    """Add the cell ch4_tiny to the copy at ``root`` by new files and
    entries alone: its mix, its limits (the CH4 cell's), its workload."""
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    here = os.path.join(root, "rmtbench")
    with open(os.path.join(here, "traffic", "f32x_b131072.json")) as f:
        mix = json.load(f)
    mix.update(members=4, recorded_per_sweep=2, check_members=2,
               warm_attempts=4)
    with open(os.path.join(here, "traffic", "tiny.json"), "w") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(here, "limits", "ch4_f32x_b131072.json"),
                os.path.join(here, "limits", f"{TINY}.json"))
    bench["workloads"].append(dict(
        name=TINY, config="ch4_n2", traffic="tiny", chips=1,
        why="four CH4 members on the CPU"))
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(TINY)
    with open(bench_path, "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("checkout"))
    add_tiny_cell(root)
    return root


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
