# The catalyst-particle models T1 and T2 of the port (rmt_tpu_torch/
# models/particle.py) and their rmtExe runners against rmt_tpu on the CPU
# in float64, on the inputs of rmt_tpu's own particle tests
# (rmt_tpu_torch/cases/hetero_case.py, held equal to tests/
# test_particle.py's here): build_params key by key; the T1 RHS (FDM, OC
# with raw and scaled sources, the recomputed OC surface values) and the
# T2 transport state and residuals (FDM, OC, OCFE) on perturbed states at
# 1e-10; rmtExe T2 by each method and T1 (period 0.5 s) at 1e-6 relative
# on every output row, T1's attempts, and T1's checkpoint and resume.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmt_tpu
import rmt_tpu_torch
from rmt_tpu_torch import convert
from rmt_tpu.models import particle as j_pt
from rmt_tpu_torch.cases import hetero_case
from rmt_tpu_torch.models import particle as t_pt
from test_particle import _t1_model_input, _t2_model_input


def _close(got, want, rtol=1e-10):
    """Equal to rtol, with the floor rtol * max|want| for entries that
    cancel to near zero."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _strip(mi):
    """modelInput without the kinetics lambdas."""
    return {k: v for k, v in mi.items() if k != "reaction-rates"}


def _assert_tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("model", ["T1", "T2"])
def test_case_inputs_equal_jax_fixtures(model):
    """hetero_case's particle inputs are rmt_tpu's test fixtures."""
    got, want = {"T1": (hetero_case.t1_model_input, _t1_model_input),
                 "T2": (hetero_case.t2_model_input, _t2_model_input)}[model]
    _assert_tree_equal(_strip(got()), _strip(want()))


@pytest.mark.parametrize("model", ["T1", "T2"])
def test_build_params_key_by_key(model):
    mi = hetero_case.model_input(model)
    want = j_pt.build_params(mi)
    got = t_pt.build_params(mi, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "kinetic_overrides":
            assert set(got[k]) == set(w)
            continue
        assert got[k].dtype == torch.float64, k
        assert got[k].shape == tuple(np.shape(w)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
    # rmt_tpu's parameters cross over to the same tensors
    crossed = convert.params_from_jax(want, device="cpu")
    _assert_tree_equal({k: v.numpy() if k != "kinetic_overrides" else v
                        for k, v in crossed.items()},
                       {k: v.numpy() if k != "kinetic_overrides" else v
                        for k, v in got.items()})


def _t1_pair():
    mi = hetero_case.t1_model_input()
    return (j_pt.build_spec(mi), t_pt.build_spec(mi), j_pt.build_params(mi),
            t_pt.build_params(mi, device="cpu"))


T1_RHS = {
    "fdm": lambda m, s: m.make_t1_rhs(s),
    "oc raw, clamped": lambda m, s: m.make_t1_rhs_oc(
        s, scaled_sources=False, clamp_interface=True),
    "oc scaled": lambda m, s: m.make_t1_rhs_oc(s),
}


@pytest.mark.parametrize("kind", sorted(T1_RHS))
def test_t1_rhs_matches_jax(kind):
    """The initial state, and the RHS on states perturbed as rmt_tpu's
    reference test perturbs them (the OC surface values too), at 1e-10."""
    js, ts, jp, tp = _t1_pair()
    y0 = np.asarray(j_pt.t1_initial_state(js, jp))
    np.testing.assert_array_equal(t_pt.t1_initial_state(ts, tp).numpy(), y0)
    j_rhs, t_rhs = T1_RHS[kind](j_pt, js), T1_RHS[kind](t_pt, ts)
    rng = np.random.default_rng(9)
    for _ in range(3):
        y = np.abs(y0 + rng.uniform(0.001, 0.5, y0.shape))
        y[-7:] = rng.uniform(-0.01, 0.05, 7)
        _close(t_rhs(0.1, torch.as_tensor(y), tp),
               j_rhs(0.1, jnp.asarray(y), jp))
        if kind != "fdm":
            _close(t_pt.t1_oc_surface_values(ts, tp, torch.as_tensor(y)),
                   j_pt.t1_oc_surface_values(js, jp, jnp.asarray(y)))


def test_t2_derived_matches_jax():
    """Chapman-Enskog, Wilke mixtures, film numbers and transfer
    coefficients of the steady particle's feed, key by key at 1e-12."""
    mi = hetero_case.t2_model_input()
    want = j_pt.t2_derived(j_pt.build_spec(mi), j_pt.build_params(mi))
    got = t_pt.t2_derived(t_pt.build_spec(mi),
                          t_pt.build_params(mi, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-12)


T2_RESIDUAL = {
    "fdm": (7, lambda m, s: m.make_t2_residual_fn(s)),
    "oc": (7, lambda m, s: m.make_t2_residual_oc(s)),
    "fem": (19, lambda m, s: m.make_t2_residual_ocfe(s, 6)),
}


@pytest.mark.parametrize("method", sorted(T2_RESIDUAL))
def test_t2_residual_matches_jax(method):
    """The T2 initial state and residual (FDM, OC, and OCFE at NuEl 6:
    rNo 19) on states perturbed by up to 20%, at 1e-10."""
    r_no, make = T2_RESIDUAL[method]
    mi = hetero_case.t2_model_input()
    js, ts = (j_pt.build_spec(mi, r_no=r_no), t_pt.build_spec(mi, r_no=r_no))
    jp, tp = j_pt.build_params(mi), t_pt.build_params(mi, device="cpu")
    jd, td = j_pt.t2_derived(js, jp), t_pt.t2_derived(ts, tp)
    y0 = np.asarray(j_pt.t2_initial_state(js, jp))
    np.testing.assert_array_equal(t_pt.t2_initial_state(ts, tp).numpy(), y0)
    j_res, t_res = make(j_pt, js), make(t_pt, ts)
    rng = np.random.default_rng(10)
    for _ in range(3):
        y = y0 * rng.uniform(0.8, 1.2, y0.shape) + rng.uniform(0, 0.05,
                                                               y0.shape)
        _close(t_res(torch.as_tensor(y), tp, td), j_res(jnp.asarray(y), jp, jd))


def _rows(res):
    return np.stack([np.asarray(xy[1], np.float64) for xy in res["XYList"]])


def _pack_rows(res):
    return np.stack([np.asarray(dp["dataY"], np.float64)
                     for dp in res["dataPack"]])


def _assert_results_close(got, want, rtol=1e-6):
    """The same result keys, legends and grid; XYList rows and every
    dataPack's dataY at rtol relative."""
    assert set(got) == set(want)
    assert ([d["leg"] for d in got["dataList"]]
            == [d["leg"] for d in want["dataList"]])
    np.testing.assert_array_equal(got["dataList"][0]["x"],
                                  want["dataList"][0]["x"])
    for g, w in ((_rows(got), _rows(want)),
                 (_pack_rows(got), _pack_rows(want))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol)


@pytest.mark.parametrize("method", [None, "oc", "fem"])
def test_rmtexe_t2_matches_jax(method):
    """rmtExe T2 by FDM (rNo 7), OC (the 7 collocation points) and OCFE
    (NuEl 6: rNo 19): every output row within 1e-6 relative."""
    want = rmt_tpu.rmtExe(hetero_case.t2_model_input(method))["resModel"]
    got = rmt_tpu_torch.rmtExe(hetero_case.t2_model_input(method),
                               device="cpu")["resModel"]
    _assert_results_close(got, want)


def _t1_input(period, resume=None):
    mi = hetero_case.t1_model_input()
    mi["operating-conditions"]["period"] = period
    if resume is not None:
        mi["resume-state"] = resume
    return mi


@pytest.fixture(scope="module")
def t1_runs():
    """rmtExe T1 over 0.5 s (rmt_tpu's end-to-end test's period) in both
    packages."""
    return (rmt_tpu.rmtExe(_t1_input(0.5))["resModel"],
            rmt_tpu_torch.rmtExe(_t1_input(0.5), device="cpu")["resModel"])


def test_rmtexe_t1_matches_jax(t1_runs):
    """Every output row and time, and the checkpoint, within 1e-6
    relative; the integrator's attempts within 1.25 times rmt_tpu's.

    The attempts are not equal: in the early transient (t ~ 5e-15 s,
    where the unscaled reaction term makes the model explosively
    unstable) a Newton iteration that converges at its eighth and last
    sweep in one package fails in the other, on inputs that agree to
    1e-11, and the step sequences part there (rmt_tpu itself gives 1428
    attempts through rmtExe and 1437 through another compilation of the
    same integrator call). The states after the transient agree to
    1e-13."""
    want, got = t1_runs
    _assert_results_close(got, want)
    assert len(got["dataPack"]) == 10
    np.testing.assert_allclose([dp["dataTime"] for dp in got["dataPack"]],
                               [dp["dataTime"] for dp in want["dataPack"]],
                               rtol=1e-14)
    np.testing.assert_allclose(got["checkpoint"]["state"],
                               want["checkpoint"]["state"], rtol=1e-6)
    assert got["checkpoint"]["t"] == pytest.approx(0.5, abs=1e-15)
    st_g, st_w = got["solverStats"], want["solverStats"]
    assert st_g["n_unreached"] == 0
    att_g = st_g["n_accepted"] + st_g["n_rejected"]
    att_w = st_w["n_accepted"] + st_w["n_rejected"]
    assert att_w / 1.25 <= att_g <= 1.25 * att_w, (st_g, st_w)


def test_rmtexe_t1_resume_matches_jax(t1_runs):
    """Resumed from the 0.5 s checkpoint for another 0.5 s, the port and
    rmt_tpu give the same rows at 1e-6 and the checkpoint time 1.0 s."""
    want0, _ = t1_runs
    ck = want0["checkpoint"]
    assert ck["model"] == "T1"
    want = rmt_tpu.rmtExe(_t1_input(0.5, ck))["resModel"]
    got = rmt_tpu_torch.rmtExe(_t1_input(0.5, ck), device="cpu")["resModel"]
    _assert_results_close(got, want)
    assert got["dataPack"][-1]["dataTime"] == pytest.approx(1.0, abs=1e-12)
    assert got["checkpoint"]["t"] == pytest.approx(1.0, abs=1e-12)
    np.testing.assert_allclose(got["checkpoint"]["state"],
                               want["checkpoint"]["state"], rtol=1e-6)
