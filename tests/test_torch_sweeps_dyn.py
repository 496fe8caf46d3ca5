# The design sweeps of the coupled dynamic heterogeneous models on the
# port (rmt_tpu_torch/parallel/ensemble.py: run_m10_sweep, run_m11_sweep,
# run_m12_sweep) at B = 2 on the CPU in float64, with the inputs of
# rmt_tpu's tests/test_ensemble.py (T0 and T0 + 8 K) at small grids:
# member 0 equals the port's rmtExe at its inlet temperature to 1e-9
# relative (rmtExe is held to rmt_tpu's in test_torch_rmtexe_dyn.py; the
# sweep is jax.vmap of that run in rmt_tpu, and rmt_tpu's own M11 sweep
# takes a quarter of an hour of CPU at this grid), the hotter member
# differs, every member reaches its output times; M12's explicit shared y0
# equals its default to 1e-12; a refined mesh raises for M10/M12.

import numpy as np
import pytest
import torch

from rmt_tpu_torch import rmtExe as t_exe
from rmt_tpu_torch.cases import hetero_case
from rmt_tpu_torch.parallel import run_m10_sweep, run_m11_sweep, run_m12_sweep

T0 = 523.0
SWEEP = {"T0": np.asarray([T0, T0 + 8.0])}


def _close(got, want, rtol=1e-9):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


CASES = {
    # model: (grid, period, sweep runner)
    "M10": (dict(zNo=4, tNo=2), 0.02, run_m10_sweep),
    "M11": (dict(zNo=4, rNo=3, tNo=2), 0.05, run_m11_sweep),
    "M12": (dict(zNo=4, tNo=2), 4e-3, run_m12_sweep),
}


@pytest.mark.parametrize("model", sorted(CASES))
def test_sweep_members_equal_their_single_runs(model):
    grid, period, run = CASES[model]
    mi = hetero_case.dyn_model_input(model, grid, period)
    ys, stats = run(mi, SWEEP, device="cpu")
    assert ys.shape[:2] == (2, grid["tNo"] + 1)
    assert bool(torch.isfinite(ys).all())
    assert not stats.n_unreached.any()
    if model == "M12":
        # the sweep's default start, through the public resume path
        mi["resume-state"] = hetero_case.m12_physical_resume(grid["zNo"])
    single = t_exe(mi, device="cpu")["resModel"]
    _close(ys[0, -1].numpy(), single["checkpoint"]["state"])
    assert int(stats.n_accepted[0] + stats.n_rejected[0]) == (
        single["solverStats"]["n_accepted"]
        + single["solverStats"]["n_rejected"])
    assert float((ys[1] - ys[0]).abs().max()) > 1e-6
    if model == "M12":
        y0 = hetero_case.m12_physical_resume(grid["zNo"])["state"]
        ys2, _ = run(mi, SWEEP, y0=y0, device="cpu")
        _close(ys2.numpy(), ys.numpy(), 1e-12)


@pytest.mark.parametrize("run", [run_m10_sweep, run_m12_sweep])
def test_sweep_refuses_the_refined_mesh(run):
    mi = hetero_case.dyn_model_input("M12", dict(zNo=4, tNo=2))
    mi["solver-config"]["mesh"] = "refined"
    with pytest.raises(ValueError, match="normal mesh"):
        run(mi, SWEEP, device="cpu")
