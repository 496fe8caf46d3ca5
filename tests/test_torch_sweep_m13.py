# The M13 design sweep of the port (rmt_tpu_torch/parallel/ensemble.py::
# run_m13_sweep) at B = 2 on the CPU in float64, with the inputs of
# rmt_tpu's tests/test_ensemble.py (T0 and T0 + 8 K, zNo 5, rNo 4, tNo 3
# for the lockstep engine): the lockstep engine (the gas phase on the
# lockstep integrator in tridiagonal block mode, the particles on
# root_batched in tridiagonal block mode with the bulk-homotopy rescue)
# against rmt_tpu's lockstep engine at rtol 1e-5, atol 1e-9 (measured:
# 3e-11 absolute; rmt_tpu's bar between its two engines is 2e-4, the
# integrator truncation at rtol 1e-5), every member converged and no
# output time unreached, and the refined mesh refused; the vmap engine's
# member 0 equals the port's rmtExe M13 at its inlet temperature to 1e-9
# (zNo 4, rNo 3, tNo 2 over 0.5 s).

import jax.numpy as jnp
import numpy as np
import pytest

from rmt_tpu.parallel import run_m13_sweep as j_run_m13_sweep
from rmt_tpu_torch import rmtExe as t_exe
from rmt_tpu_torch.cases import hetero_case
from rmt_tpu_torch.parallel import run_m13_sweep

T0 = 523.0
SWEEP = {"T0": np.asarray([T0, T0 + 8.0])}


def test_lockstep_engine_matches_jax():
    mi = hetero_case.dyn_model_input("M13", dict(zNo=5, rNo=4, tNo=3))
    got = run_m13_sweep(mi, SWEEP, engine="lockstep", device="cpu")
    want = j_run_m13_sweep(mi, {"T0": jnp.asarray(SWEEP["T0"])},
                           engine="lockstep")
    assert bool(got["converged"].all())
    assert int(got["unreached"].sum()) == 0
    assert got["rescued"] <= 3
    for k in ("gas", "solid"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got["ts"].numpy(), np.asarray(want["ts"]),
                               rtol=1e-15)
    bad = hetero_case.dyn_model_input("M13", dict(zNo=5, rNo=4, tNo=3))
    bad["solver-config"]["mesh"] = "refined"
    with pytest.raises(ValueError, match="normal mesh"):
        run_m13_sweep(bad, SWEEP, engine="lockstep", device="cpu")


def test_vmap_engine_members_equal_their_single_runs():
    grid, period = dict(zNo=4, rNo=3, tNo=2), 0.5
    mi = hetero_case.dyn_model_input("M13", grid, period)
    out = run_m13_sweep(mi, SWEEP, device="cpu")
    assert bool(out["converged"].all())
    assert int(out["unreached"].sum()) == 0
    assert tuple(out["gas"].shape) == (2, 2, 7, 4)
    ck = t_exe(mi, device="cpu")["resModel"]["checkpoint"]
    for k, got in (("gas", out["gas"][0, -1].reshape(-1)),
                   ("solid", out["solid"][0, -1])):
        np.testing.assert_allclose(got.numpy(), ck[k], rtol=1e-9,
                                   atol=1e-9 * np.abs(ck[k]).max())
    assert float((out["gas"][1] - out["gas"][0]).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="shared period"):
        run_m13_sweep(mi, {"opT": np.asarray([1.0, 2.0])}, device="cpu")
