# How the test suite runs, set before tests/conftest.py imports jax and
# torch (pytest loads this file first).
#
# Threads: every test process runs torch, OpenMP, MKL and OpenBLAS on one
# thread, and the child processes it starts inherit that through the
# environment. Idle OpenBLAS and OpenMP threads spin, so six xdist workers
# each spinning on every core starve each other, and torch's multithreaded
# batched float64 LU can hang with four threads or more.
#
# Clock: every test phase fails past tests/clock.py's TEST_LIMIT_S.
#
# Order: under --dist loadfile xdist hands out the files with the most
# tests first, which leaves a file of a few long tests to the end of the
# run. FIRST_FILES, the longest of the suite or a few long tests each,
# go out first, the rest in xdist's own order.

import collections
import os
import sys

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))

from clock import TEST_LIMIT_S, Clock  # noqa: E402

FIRST_FILES = ("test_ensemble.py", "test_mesh.py", "test_torch_sweep_m13.py")


def pytest_configure(config):
    config.pluginmanager.register(Clock(TEST_LIMIT_S), "clock")
    # xdist then hands out the files in the order sorted below
    config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    counts = collections.Counter(item.path for item in items)

    def rank(item):
        name = item.path.name
        first = FIRST_FILES.index(name) if name in FIRST_FILES else len(FIRST_FILES)
        return first, -counts[item.path]

    items.sort(key=rank)
