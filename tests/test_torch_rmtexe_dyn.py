# rmtExe M10, M11, M12 and M13 of the port (rmt_tpu_torch/api/rmt.py on
# models/hetero_dyn.py) against rmt_tpu's rmtExe on the CPU in float64,
# on rmt_tpu's own end-to-end inputs (tests/test_m10.py, test_m11.py,
# test_m12.py, test_m13.py; rmt_tpu_torch/cases/hetero_case.py) at small
# grids: every dataPack row within 1e-10 relative (the floor 1e-10 of the
# row's largest entry), the checkpoint state too, and the integrator's
# statistics equal; M13's chained checkpoint/resume equal to one run at
# 1e-10 (rmt_tpu's tests/test_m13.py bar is 1e-6); a resume-state of
# another grid raises.

import numpy as np
import pytest

from rmt_tpu import rmtExe as j_exe
from rmt_tpu_torch import rmtExe as t_exe
from rmt_tpu_torch.cases import hetero_case

ROWS = ("dataYCon", "dataYTemp", "dataYs", "dataYCons", "dataYTemps")


def _close(got, want, rtol=1e-10):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _dyn_input(model, **grid):
    period = {"M10": 0.02, "M11": 0.5, "M12": 4e-3}.get(model)
    mi = hetero_case.dyn_model_input(model, grid, period)
    if model in ("M11", "M12"):
        # the physical startup state (M11's rows: rNo + 1 = 4 here)
        ck = hetero_case.m12_physical_resume(grid["zNo"])
        if model == "M11":
            y = np.asarray(ck["state"]).reshape(7, 8, grid["zNo"])
            ck = {"model": "M11", "t": 0.0,
                  "state": y[:, :grid["rNo"] + 1].reshape(-1)}
        mi["resume-state"] = ck
    return mi


# rmt_tpu's end-to-end grids (M10, M12); M11 at zNo 4, rNo 3 over 0.5 s
# from the physical startup state (its seed transient is the sweep
# tests' part, tests/test_torch_sweeps_dyn.py); M13 at zNo 4, rNo 3 over
# two intervals of 0.25 s; each within a CPU minute
GRIDS = {"M10": dict(zNo=4, tNo=2), "M11": dict(zNo=4, rNo=3, tNo=2),
         "M12": dict(zNo=4, tNo=2), "M13": dict(zNo=4, rNo=3, tNo=2)}
M13_PERIOD = 0.5


@pytest.fixture(scope="module")
def m13_full():
    """rmtExe M13 of the port at GRIDS["M13"] over M13_PERIOD."""
    mi = hetero_case.dyn_model_input("M13", GRIDS["M13"], M13_PERIOD)
    return mi, t_exe(mi, device="cpu")["resModel"]


@pytest.mark.parametrize("model", sorted(GRIDS))
def test_rmtexe_dyn_matches_jax(model, request):
    if model == "M13":
        mi, got = request.getfixturevalue("m13_full")
    else:
        mi = _dyn_input(model, **GRIDS[model])
        got = t_exe(mi, device="cpu")["resModel"]
    want = j_exe(mi)["resModel"]
    assert len(got["dataPack"]) == len(want["dataPack"])
    for g, w in zip(got["dataPack"], want["dataPack"]):
        assert g["successStatus"]
        assert g["dataTime"] == pytest.approx(float(w["dataTime"]),
                                              rel=1e-14)
        for k in ROWS:
            _close(g[k], w[k])
    for k in want["checkpoint"]:
        if k == "model":
            assert got["checkpoint"][k] == model
        else:
            _close(got["checkpoint"][k], want["checkpoint"][k])
    if model != "M13":
        assert got["solverStats"] == {
            k: int(np.asarray(v)) for k, v in want["solverStats"].items()}
    for (_, gy), (_, wy) in zip(got["XYList"], want["XYList"]):
        _close(gy, wy)


def test_m13_checkpoint_resume_matches_single_run(m13_full):
    """Two chained half periods (save -> resume) land on one run's state:
    every interval restarts the gas integrator and the solid Newton from
    the carried state alone."""
    _, full = m13_full
    grid, half = dict(GRIDS["M13"], tNo=1), M13_PERIOD / 2
    res_a = t_exe(hetero_case.dyn_model_input("M13", grid, half),
                  device="cpu")["resModel"]
    ck = res_a["checkpoint"]
    assert ck["model"] == "M13" and ck["t"] == pytest.approx(half, abs=1e-14)
    mi_b = hetero_case.dyn_model_input("M13", grid, half)
    mi_b["resume-state"] = ck
    res_b = t_exe(mi_b, device="cpu")["resModel"]
    assert res_b["dataPack"][-1]["dataTime"] == pytest.approx(M13_PERIOD,
                                                              abs=1e-12)
    for k in ("gas", "solid"):
        _close(res_b["checkpoint"][k], full["checkpoint"][k])


@pytest.mark.parametrize("model, key", [("M11", "state"), ("M13", "gas"),
                                        ("M13", "solid")])
def test_resume_state_of_another_grid_raises(model, key):
    mi = hetero_case.dyn_model_input(model, dict(zNo=4, rNo=3, tNo=1))
    ck = {"model": model, "t": 0.0, "state": np.zeros(5),
          "gas": np.zeros(28), "solid": np.zeros((7, 3, 4))}
    ck[key] = np.zeros(3)
    with pytest.raises(ValueError, match="grid needs"):
        t_exe(dict(mi, **{"resume-state": ck}), device="cpu")
