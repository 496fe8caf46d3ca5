# The dynamic heterogeneous models of the port (rmt_tpu_torch/models/
# hetero_dyn.py: M10, M11, M12, M13) against rmt_tpu on the CPU in
# float64, on the inputs of rmt_tpu's own tests (rmt_tpu_torch/cases/
# hetero_case.py's dyn_model_input, held equal to tests/test_m13.py's
# here), at small grids (zNo 4-6, rNo 3-4): every RHS and residual at
# 1e-10 relative (with that fraction of the largest entry as the floor).
# What they run on (colorings, block solves, block modes, colored
# Jacobians): tests/test_torch_hetero_dyn_linalg.py.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmt_tpu.models import hetero_dyn as j_hd
from rmt_tpu.ops import stencils as j_st
from rmt_tpu_torch.cases import hetero_case
from rmt_tpu_torch.models import hetero_dyn as t_hd
from test_m13 import _m13_model_input

MESH = j_st.two_zone_mesh((15, 10), 1.0, 30, 1.001)


def _close(got, want, rtol=1e-10):
    """Equal to rtol, with the floor rtol * max|want| for entries that
    cancel to near zero."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _strip(mi):
    return {k: v for k, v in mi.items() if k != "reaction-rates"}


def _assert_tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("model", ["M10", "M11", "M12", "M13"])
def test_case_input_equals_jax_fixture(model):
    want = _m13_model_input()
    want["model"] = model
    _assert_tree_equal(_strip(hetero_case.dyn_model_input(model)),
                       _strip(want))


# ---------------------------------------------------------------------------
# the models' RHS and residuals
# ---------------------------------------------------------------------------

def _setup(model, z_no, r_no, mesh=None):
    mi = hetero_case.dyn_model_input(model)
    js = j_hd.m13_build_spec(mi, z_no=z_no, r_no=r_no)
    ts = t_hd.m13_build_spec(mi, z_no=z_no, r_no=r_no)
    if model == "M10":
        jp, tp = j_hd.m10_params(mi), t_hd.m10_params(mi, device="cpu")
        return js, ts, jp, tp, None, None
    jp, tp = j_hd.m13_params(mi), t_hd.m13_params(mi, device="cpu")
    jd, td = j_hd.m13_feed(js, jp), t_hd.m13_feed(ts, tp)
    return js, ts, jp, tp, jd, td


def test_params_and_feed_match_jax():
    js, ts, jp, tp, jd, td = _setup("M13", 5, 4)
    for k in jp:
        if k != "kinetic_overrides":
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert set(td) == set(jd)
    for k in jd:
        _close(td[k], jd[k], 1e-14)
    mp, tmp = j_hd.m10_params(hetero_case.dyn_model_input("M10")), \
        t_hd.m10_params(hetero_case.dyn_model_input("M10"), device="cpu")
    for k in mp:
        if k != "kinetic_overrides":
            np.testing.assert_array_equal(tmp[k].numpy(), np.asarray(mp[k]))
    np.testing.assert_array_equal(t_hd.m13_gas_initial_state(ts, tp).numpy(),
                                  j_hd.m13_gas_initial_state(js, jp))
    np.testing.assert_array_equal(
        t_hd.m13_solid_initial_state(ts, tp).numpy(),
        j_hd.m13_solid_initial_state(js, jp))
    np.testing.assert_array_equal(t_hd.m11_initial_state(ts, tp).numpy(),
                                  j_hd.m11_initial_state(js, jp))


def _gas_state(spec, p, rng):
    c_in = np.asarray(p["SpCoi0"]) / float(np.max(np.asarray(p["SpCoi0"])))
    c = c_in[:, None] * rng.uniform(0.3, 1.1, (spec.n_comp, spec.z_no))
    # a few entries below zero exercise the clamps
    c[1, 1] = -2e-4
    theta = rng.uniform(-0.02, 0.08, (1, spec.z_no))
    cs = c * rng.uniform(0.7, 1.0, c.shape)
    tsf = theta[0] + rng.uniform(0.0, 0.05, spec.z_no)
    return np.concatenate([c, theta]).reshape(-1), cs, tsf


@pytest.mark.parametrize("mesh, flux_sign, width", [
    (None, 1.0, 0.0), (None, -1.0, 0.0), (MESH, -1.0, 1e-3)])
def test_m13_gas_rhs_matches_jax(mesh, flux_sign, width):
    z_no = 6 if mesh is None else MESH["n_nodes"]
    js, ts, jp, tp, jd, td = _setup("M13", z_no, 4)
    rng = np.random.default_rng(5)
    j_rhs = j_hd.make_m13_gas_rhs(js, flux_sign, mesh, width)
    t_rhs = t_hd.make_m13_gas_rhs(ts, flux_sign, mesh, width)
    for _ in range(2):
        y, cs, tsf = _gas_state(js, jp, rng)
        _close(t_rhs(0.1, *(torch.as_tensor(a) for a in (y,)), tp, td,
                     torch.as_tensor(cs), torch.as_tensor(tsf)),
               j_rhs(0.1, jnp.asarray(y), jp, jd, jnp.asarray(cs),
                     jnp.asarray(tsf)))


def _solid_state(spec, p, rng):
    c_in = np.asarray(p["SpCoi0"]) / float(np.max(np.asarray(p["SpCoi0"])))
    y3 = c_in[:, None, None] * rng.uniform(
        0.3, 1.1, (spec.n_comp, spec.r_no, spec.z_no))
    y3[2, 0, 1] = -1e-5
    ts = rng.uniform(-0.02, 0.08, (1, spec.r_no, spec.z_no))
    cb = c_in[:, None] * rng.uniform(0.8, 1.2, (spec.n_comp, spec.z_no))
    tb = rng.uniform(-0.01, 0.05, spec.z_no)
    return np.concatenate([y3, ts], axis=0), cb, tb


def test_m13_solid_residuals_match_jax():
    """The residual over every node and one node's residual."""
    js, ts, jp, tp, jd, td = _setup("M13", 5, 4)
    rng = np.random.default_rng(7)
    y3, cb, tb = _solid_state(js, jp, rng)
    want = j_hd.make_m13_solid_residual(js)(
        jnp.asarray(y3), jnp.asarray(cb), jnp.asarray(tb), jp, jd)
    got = t_hd.make_m13_solid_residual(ts)(
        *(torch.as_tensor(a) for a in (y3, cb, tb)), tp, td)
    _close(got, want)
    node = t_hd.make_m13_solid_node_residual(ts)
    for z in (0, 3):
        _close(node(torch.as_tensor(y3[:, :, z]), torch.as_tensor(cb[:, z]),
                    torch.as_tensor(tb[z]), tp, td), np.asarray(want)[..., z])


def _dyn_state(spec, p, rng, real_units=False):
    """rmt_tpu's tests' perturbed M10-M12 states (tests/test_m11.py and
    test_m10.py::_random_state)."""
    if real_units:
        c0 = np.asarray(p["SpCoi0"])
        c_gas = c0[:, None, None] * rng.uniform(0.9, 1.05,
                                                (spec.n_comp, 1, spec.z_no))
        c_sol = c_gas * rng.uniform(0.995, 1.005,
                                    (spec.n_comp, spec.r_no, spec.z_no))
        t_all = float(p["T0"]) * rng.uniform(
            0.995, 1.01, (1, spec.r_no + 1, spec.z_no))
    else:
        c_in = np.asarray(p["SpCoi0"]) / float(np.max(np.asarray(
            p["SpCoi0"])))
        c_gas = c_in[:, None, None] * rng.uniform(0.3, 1.1,
                                                  (spec.n_comp, 1, spec.z_no))
        c_sol = c_in[:, None, None] * rng.uniform(
            0.2, 1.0, (spec.n_comp, spec.r_no, spec.z_no))
        c_sol[1, -1, 0] = -3e-4
        t_all = rng.uniform(-0.02, 0.08, (1, spec.r_no + 1, spec.z_no))
    return np.concatenate([np.concatenate([c_gas, c_sol], axis=1), t_all],
                          axis=0).reshape(-1)


def _dyn_rhs(model, js, ts, mesh, variant):
    if model == "M11":
        return (j_hd.make_m11_rhs(js, scaled_sources=variant, mesh=mesh),
                t_hd.make_m11_rhs(ts, scaled_sources=variant, mesh=mesh))
    if model == "M12":
        kw = dict(cp_at_real_temperature=variant, clamp_interface=variant,
                  mesh=mesh)
        return j_hd.make_m12_rhs(js, **kw), t_hd.make_m12_rhs(ts, **kw)
    return (j_hd.make_m10_rhs(js, clamp_interface=variant),
            t_hd.make_m10_rhs(ts, clamp_interface=variant))


DYN_CASES = [("M11", None, True), ("M11", None, False), ("M11", MESH, True),
             ("M12", None, True), ("M12", None, False), ("M12", MESH, True),
             ("M10", None, True), ("M10", None, False)]


@pytest.mark.parametrize("model, mesh, variant", DYN_CASES)
def test_dyn_rhs_matches_jax(model, mesh, variant):
    """M11 (scaled and the reference's raw sources, the two-zone mesh),
    M12 (the driver's options and the reference's quirks) and M10 at zNo 5
    (rNo 3 for M11; the 7-point OC basis for M10/M12) at 1e-10 on two
    perturbed states each; M12's surface values too."""
    z_no = MESH["n_nodes"] if mesh is not None else 5
    r_no = 3 if model == "M11" else 7
    js, ts, jp, tp, jd, td = _setup(model, z_no, r_no)
    j_rhs, t_rhs = _dyn_rhs(model, js, ts, mesh, variant)
    rng = np.random.default_rng(17)
    args_j = (jp,) if model == "M10" else (jp, jd)
    args_t = (tp,) if model == "M10" else (tp, td)
    for _ in range(2):
        y = _dyn_state(js, jp, rng, real_units=model == "M10")
        _close(t_rhs(0.0, torch.as_tensor(y), *args_t),
               j_rhs(0.0, jnp.asarray(y), *args_j))
        if model == "M12":
            for g, w in zip(
                    t_hd.m12_surface_values(ts, tp, td, torch.as_tensor(y)),
                    j_hd.m12_surface_values(js, jp, jd, jnp.asarray(y))):
                _close(g, w)
