# The port's M14 (rmt_tpu_torch/models/hetero.py) through rmtExe and its
# design sweep (parallel/ensemble.py::run_m14_sweep) against rmt_tpu on
# the CPU in float64: rmtExe M14 at zNo 10, with rampList [0.25, 0.5, 1.0]
# and on the two-zone mesh within 1e-6 relative on every output row;
# run_m14_sweep at B = 3 against rmt_tpu's sweep and the single run. The
# port's zNo-10 rmtExe run is made once (m14_single) for both.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmt_tpu
import rmt_tpu_torch
from rmt_tpu.parallel import run_m14_sweep as j_run_m14_sweep
from rmt_tpu_torch.cases import hetero_case
from rmt_tpu_torch.parallel import Mesh, run_m14_sweep
from test_torch_hetero import _assert_results_close

RMTEXE = {
    "M14 zNo 10": lambda: hetero_case.m14_model_input(z_no=10),
    "M14 rampList": lambda: hetero_case.m14_model_input(
        z_no=10, ramp_list=[0.25, 0.5, 1.0]),
    "M14 two-zone": lambda: hetero_case.m14_model_input(mesh="refined"),
}


@pytest.fixture(scope="module")
def m14_single():
    return rmt_tpu_torch.rmtExe(hetero_case.m14_model_input(z_no=10),
                                device="cpu")["resModel"]


@pytest.mark.parametrize("case", sorted(RMTEXE))
def test_rmtexe_matches_jax(case, request):
    """rmtExe against rmt_tpu's: the same result keys and legends, every
    output row within 1e-6 relative."""
    want = rmt_tpu.rmtExe(RMTEXE[case]())["resModel"]
    if case == "M14 zNo 10":
        got = request.getfixturevalue("m14_single")
    else:
        got = rmt_tpu_torch.rmtExe(RMTEXE[case](), device="cpu")["resModel"]
    _assert_results_close(got, want)


def test_m14_iso_thermal_raises():
    mi = hetero_case.m14_model_input(z_no=10)
    mi["operating-conditions"]["process-type"] = "iso-thermal"
    with pytest.raises(NotImplementedError, match="iso-thermal"):
        rmt_tpu_torch.rmtExe(mi, device="cpu")


def test_m14_sweep_matches_jax_and_single(m14_single):
    """run_m14_sweep over T0, T0 + 10, T0 + 20 (zNo 10): every member
    converged, equal to rmt_tpu's run_m14_sweep at 1e-6, member 0 within
    1e-6 of the single rmtExe, and the hotter feed shifting the steady
    state (rmt_tpu's tests/test_ensemble.py checks)."""
    mi = hetero_case.m14_model_input(z_no=10)
    T0 = float(mi["operating-conditions"]["temperature"])
    sweep = np.asarray([T0, T0 + 10.0, T0 + 20.0])
    timings = {}
    got = run_m14_sweep(mi, {"T0": sweep}, device="cpu", timings=timings)
    want = j_run_m14_sweep(mi, {"T0": jnp.asarray(sweep)})
    assert got["states"].shape == (3, 7, 2, 10)
    assert bool(got["converged"].all()), got["res_norm"]
    assert set(timings) == {"jacobian", "lu", "newton", "other", "polish"}
    np.testing.assert_allclose(got["states"].numpy(),
                               np.asarray(want["states"]), rtol=1e-6)
    c_max = float(np.max(np.asarray(mi["feed"]["concentration"])))
    np.testing.assert_allclose(
        got["states"][0, :6, 0].numpy() * c_max,
        m14_single["dataPack"][0]["dataYCoGas"], rtol=1e-6, atol=1e-12)
    assert float((got["states"][2] - got["states"][0]).abs().max()) > 1e-4


def test_m14_sweep_kinetic_override():
    """Kinetic constants are sweepable leaves: zeroing the methanol rate
    constant K1 changes the converged profile."""
    mi = hetero_case.m14_model_input(z_no=10)
    out = run_m14_sweep(mi, {"K1": np.asarray([35.45, 1e-6])}, device="cpu")
    assert bool(out["converged"].all())
    assert float((out["states"][0] - out["states"][1]).abs().max()) > 1e-5


def test_m14_sweep_refuses_a_mesh():
    """A sweep whose size the mesh does not divide raises ValueError (as
    jax.device_put of a dp-sharded batch does), before any work."""
    with pytest.raises(ValueError, match="not divisible"):
        run_m14_sweep(hetero_case.m14_model_input(z_no=10),
                      {"T0": np.asarray([523.0])},
                      mesh=Mesh(None, 0, 2, torch.device("cpu")))
