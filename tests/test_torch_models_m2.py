# The port's dynamic packed-bed model M2 end to end against rmt_tpu on the
# CPU in float64: rmtExe (the lockstep integrator at B = 1 in block mode,
# its blocks extracted from the dense colored Jacobian, its stage solves
# the block kernels' twins here) at zNo 20, and its checkpoint/resume.
# The input is rmt_tpu's own tests/test_m2.py's (rmt_tpu_torch/cases/
# pb_case.py); the default grid (zNo 100) runs on the card (chip_smoke.py,
# against models_ref.npz). M9: tests/test_torch_models_m9.py.

import numpy as np
import pytest

import rmt_tpu
import rmt_tpu_torch
from rmt_tpu_torch.cases import pb_case


def _attempts(stats):
    return sum(stats["n_accepted"]) + sum(stats["n_rejected"])


def test_rmtexe_m2_matches_jax():
    """M2 at zNo 20, tNo 10: dataPacktime and the final state within 1e-5
    of rmt_tpu's, attempts within 1.25 times, and the result layout."""
    want = rmt_tpu.rmtExe(pb_case.m2_model_input(z_no=20))["resModel"]
    got = rmt_tpu_torch.rmtExe(pb_case.m2_model_input(z_no=20),
                               device="cpu")["resModel"]
    assert set(got) == set(want)
    assert set(got["solverStats"]) >= set(want["solverStats"])
    assert len(got["dataPack"]) == len(want["dataPack"]) == 10
    for g, w in zip(got["dataPack"], want["dataPack"]):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["dataTime"], w["dataTime"], rtol=1e-12)
    assert got["dataPacktime"].shape == (7, 10, 20)
    np.testing.assert_allclose(got["dataPacktime"], want["dataPacktime"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["checkpoint"]["state"],
                               want["checkpoint"]["state"], rtol=1e-5)
    a_got, a_want = _attempts(got["solverStats"]), _attempts(
        want["solverStats"])
    assert a_want / 1.25 <= a_got <= 1.25 * a_want, (a_got, a_want)
    assert got["solverStats"]["seg"] == [10]


def test_rmtexe_m2_resume_matches_single_run():
    """Two chained half-period runs land on the full-period state (the
    checkpoint contract of rmt_tpu's tests/test_m2.py), here at zNo 10,
    tNo 4 and a period of 2 s."""
    def mi_with(period):
        mi = pb_case.m2_model_input(z_no=10)
        mi["solver-config"]["tNo"] = 4
        mi["operating-conditions"]["period"] = period
        return mi

    def run(mi):
        return rmt_tpu_torch.rmtExe(mi, device="cpu")["resModel"]

    full = run(mi_with(2.0))
    a = run(mi_with(1.0))
    ck = a["checkpoint"]
    assert ck["model"] == "M2" and abs(ck["t"] - 1.0) < 1e-12
    mi_b = mi_with(1.0)
    mi_b["resume-state"] = ck
    b = run(mi_b)
    assert abs(b["dataPack"][-1]["dataTime"] - 2.0) < 1e-9
    np.testing.assert_allclose(b["checkpoint"]["state"],
                               full["checkpoint"]["state"], rtol=1e-5,
                               atol=1e-8)
    mi_b["resume-state"] = dict(ck, model="M9")
    with pytest.raises(ValueError, match="resume-state is for model"):
        run(mi_b)
