"""Whether the sweeps of a run are correct: every member finished, every
final state finite, and a sample of the recorded trajectories within a
limit of the float64 reference.

The sample is drawn from the seed among all members that the window's
sweeps recorded. The reference (reference/n2.py with the chemistry of
configs/<config>.py) integrates each sampled member's inlet temperature
again, in worker processes on the host, once the window has closed.
The number compared is bench.py's: the largest
|program - reference| / max(|reference|, 1e-7) over the sampled members'
states at every output time.
"""

from __future__ import annotations

import importlib.util
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import traffic

FLOOR = 1e-7
# the worker processes: one BLAS thread each
_SINGLE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                  "MKL_NUM_THREADS")


def reference_member(chem_path, config, t0):
    """The reference's states of one member, (t_no + 1, n), with the
    chemistry of the file at ``chem_path``."""
    from .reference import n2

    spec = importlib.util.spec_from_file_location(
        f"rmtbench_chemistry_{config['name']}", chem_path)
    chem = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chem)
    return n2.integrate(chem.CHEMISTRY, config, t0)


def reference_states(chem_path, config, t0s, workers=None):
    """The reference at each inlet temperature, (len(t0s), t_no + 1, n),
    over a pool of worker processes."""
    workers = min(workers or os.cpu_count() or 1, len(t0s))
    saved = {k: os.environ.get(k) for k in _SINGLE_THREAD}
    os.environ.update({k: "1" for k in _SINGLE_THREAD})
    try:
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futs = [pool.submit(reference_member, chem_path, config,
                                float(t))
                    for t in t0s]
            out = [f.result() for f in futs]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return np.stack(out)


def sample(seed, n_recorded, size):
    """Which of the run's recorded members to compare: `size` of them,
    drawn from the seed."""
    size = min(size, n_recorded)
    return np.sort(traffic.rng(seed, 1).choice(n_recorded, size=size,
                                               replace=False))


def max_rel_err(got, want):
    rel = np.abs(got - want) / np.maximum(np.abs(want), FLOOR)
    return float(rel.max())
