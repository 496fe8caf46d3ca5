# The steady axial-dispersion and heterogeneous models of the port (M5 and
# M14 in rmt_tpu_torch/models/hetero.py, T3 in models/homo.py) and their
# rmtExe runners against rmt_tpu on the CPU in float64, on the inputs of
# rmt_tpu's own tests (rmt_tpu_torch/cases/hetero_case.py, held equal to
# tests/test_t3.py's and tests/test_m14.py's here): build_params and feed
# scales key by key; the M5 RHS and the T3 and M14 residuals (uniform zNo
# 10 and the two-zone mesh, M14 at ramp 1.0 and 0.25) on perturbed states
# at 1e-10; rmtExe M5 and T3 (both meshes) within 1e-6 relative on every
# output row; and root_batched's like_root mode against root. rmtExe M14
# and its design sweep: tests/test_torch_hetero_m14.py.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmt_tpu
import rmt_tpu_torch
from rmt_tpu_torch import convert
from rmt_tpu.models import hetero as j_he
from rmt_tpu.models import homo as j_homo
from rmt_tpu.ops import stencils as j_st
from rmt_tpu_torch.cases import hetero_case, pb_case
from rmt_tpu_torch.models import hetero as t_he
from rmt_tpu_torch.models import homo as t_homo
from rmt_tpu_torch.solvers import newton
from test_m14 import _m14_model_input
from test_t3 import _t3_model_input

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


@pytest.mark.parametrize("model", ["T3", "M14"])
def test_case_inputs_equal_jax_fixtures(model):
    got, want = {"T3": (hetero_case.t3_model_input, _t3_model_input),
                 "M14": (hetero_case.m14_model_input, _m14_model_input)}[model]
    _assert_tree_equal(_strip(got()), _strip(want()))


PARAMS = {
    "M5": (j_he.build_params, t_he.build_params,
           lambda: pb_case.flow_model_input("M5")),
    "T3": (j_homo.t3_params, t_homo.t3_params, hetero_case.t3_model_input),
    "M14": (j_he.m14_params, t_he.m14_params, hetero_case.m14_model_input),
}


@pytest.mark.parametrize("model", sorted(PARAMS))
def test_build_params_key_by_key(model):
    j_fn, t_fn, mi = PARAMS[model]
    want = j_fn(mi())
    got = t_fn(mi(), device="cpu")
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


def test_m5_rhs_matches_jax():
    mi = pb_case.flow_model_input("M5")
    js, ts = j_he.build_spec(mi), t_he.build_spec(mi)
    jp, tp = j_he.build_params(mi), t_he.build_params(mi, device="cpu")
    y0 = np.asarray(j_he.m5_initial_state(js, jp))
    np.testing.assert_array_equal(t_he.m5_initial_state(ts, tp).numpy(), y0)
    j_rhs, t_rhs = j_he.make_m5_rhs(js), t_he.make_m5_rhs(ts)
    rng = np.random.default_rng(12)
    for _ in range(4):
        y = y0 * rng.uniform(0.7, 1.3, y0.shape)
        _close(t_rhs(0.3, torch.as_tensor(y), tp),
               j_rhs(0.3, jnp.asarray(y), jp))


def _grid(mesh):
    return (None, 10) if mesh == "uniform" else (MESH, MESH["n_nodes"])


@pytest.mark.parametrize("mesh", ["uniform", "two-zone"])
def test_t3_residual_matches_jax(mesh):
    """The feed scales key by key at 1e-12; the initial guess; the
    residual on guesses perturbed by up to 20% (rmt_tpu's reference test's
    states) at 1e-10."""
    m, z_no = _grid(mesh)
    mi = hetero_case.t3_model_input()
    js, ts = j_homo.build_spec(mi, z_no=z_no), t_homo.build_spec(mi,
                                                                  z_no=z_no)
    jp, tp = j_homo.t3_params(mi), t_homo.t3_params(mi, device="cpu")
    jd, td = j_homo.t3_feed(js, jp), t_homo.t3_feed(ts, tp)
    assert set(td) == set(jd)
    for k in jd:
        _close(td[k], jd[k], 1e-12)
    y0 = np.asarray(j_homo.t3_initial_guess(js))
    np.testing.assert_array_equal(
        t_homo.t3_initial_guess(ts, device="cpu").numpy(), y0)
    j_res, t_res = (j_homo.make_t3_residual(js, mesh=m),
                    t_homo.make_t3_residual(ts, mesh=m))
    rng = np.random.default_rng(7)
    for _ in range(3):
        y = y0 * rng.uniform(0.8, 1.2, y0.shape)
        _close(t_res(torch.as_tensor(y), tp, td), j_res(jnp.asarray(y), jp, jd))


@pytest.mark.parametrize("ramp", [1.0, 0.25])
@pytest.mark.parametrize("mesh", ["uniform", "two-zone"])
def test_m14_residual_matches_jax(mesh, ramp):
    """The feed scales and transfer coefficients key by key at 1e-12, the
    row scales, and the ramped residual on states perturbed by up to 15%
    (rmt_tpu's reference test's states) at 1e-10."""
    m, z_no = _grid(mesh)
    mi = hetero_case.m14_model_input()
    js, ts = (j_he.m14_build_spec(mi, z_no=z_no),
              t_he.m14_build_spec(mi, z_no=z_no))
    jp, tp = j_he.m14_params(mi), t_he.m14_params(mi, device="cpu")
    jd, td = j_he.m14_feed(js, jp), t_he.m14_feed(ts, tp)
    assert set(td) == set(jd)
    for k in jd:
        _close(td[k], jd[k], 1e-12)
    _close(t_he.m14_row_scales(ts, tp, td), j_he.m14_row_scales(js, jp, jd),
           1e-12)
    c_in = np.asarray(jp["SpCoi0"]) / float(np.max(np.asarray(jp["SpCoi0"])))
    base = np.concatenate([np.tile(c_in[:, None, None], (1, 2, z_no)),
                           np.full((1, 2, z_no), 0.05)], axis=0).reshape(-1)
    j_res, t_res = (j_he.make_m14_residual(js, mesh=m),
                    t_he.make_m14_residual(ts, mesh=m))
    rng = np.random.default_rng(11)
    for _ in range(3):
        y = base * rng.uniform(0.85, 1.15, base.shape)
        _close(t_res(torch.as_tensor(y), tp, td, ramp),
               j_res(jnp.asarray(y), jp, jd, ramp))


def _assert_results_close(got, want, rtol=1e-6):
    """The same result keys, legends and grid; XYList rows, dataYs and
    every dataPack array at rtol relative."""
    assert set(got) == set(want)
    assert ([d["leg"] for d in got["dataList"]]
            == [d["leg"] for d in want["dataList"]])
    np.testing.assert_allclose(got["dataList"][0]["x"],
                               want["dataList"][0]["x"], rtol=1e-14)
    pairs = [(np.stack([np.asarray(r[1], np.float64) for r in got["XYList"]]),
              np.stack([np.asarray(r[1], np.float64)
                        for r in want["XYList"]]))]
    if "dataYs" in want:
        pairs.append((got["dataYs"], want["dataYs"]))
    for g_pack, w_pack in zip(got.get("dataPack", []),
                              want.get("dataPack", [])):
        assert set(g_pack) == set(w_pack)
        pairs += [(g_pack[k], w_pack[k]) for k in w_pack
                  if k != "successStatus"]
    for g, w in pairs:
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, w, rtol=rtol)


RMTEXE = {
    "M5": lambda: pb_case.flow_model_input("M5"),
    "T3": hetero_case.t3_model_input,
    "T3 two-zone": lambda: hetero_case.t3_model_input("refined"),
}


@pytest.mark.parametrize("case", sorted(RMTEXE))
def test_rmtexe_matches_jax(case):
    """rmtExe against rmt_tpu's: the same result keys and legends, every
    output row within 1e-6 relative."""
    want = rmt_tpu.rmtExe(RMTEXE[case]())["resModel"]
    got = rmt_tpu_torch.rmtExe(RMTEXE[case](), device="cpu")["resModel"]
    _assert_results_close(got, want)


def test_root_batched_like_root_matches_root():
    """like_root=True: every member gets root's iterates alone -- its
    iteration count, state and residual -- including a member whose x0
    already solves its system (root still takes one iteration there,
    root_batched by default none)."""
    rng = np.random.default_rng(13)
    B, n = 5, 4
    p = torch.as_tensor(rng.uniform(0.5, 2.0, (B, n)))
    x0 = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, n)))
    q = torch.as_tensor(rng.uniform(-3.0, 3.0, (B, n)))
    q[2] = x0[2] ** 3 + p[2] * x0[2]              # member 2 starts at a root

    def f(x):
        return x ** 3 + p * x - q

    got = newton.root_batched(f, x0, max_iter=40, n_backtrack=8, tol=1e-12,
                              like_root=True)
    for b in range(B):
        want = newton.root(lambda x, b=b: x ** 3 + p[b] * x - q[b], x0[b],
                           max_iter=40, tol=1e-12)
        assert int(got.iterations[b]) == int(want.iterations), b
        assert bool(got.converged[b]) and bool(want.converged)
        torch.testing.assert_close(got.x[b], want.x, rtol=1e-14, atol=1e-14)
    default = newton.root_batched(f, x0, max_iter=40, tol=1e-12)
    assert int(default.iterations[2]) == 0 and int(got.iterations[2]) == 1


def test_models_ref_holds_the_slice_keys():
    """models_ref.npz (scripts/gen_models_ref.py) keeps the keys of the
    packed-bed models and holds those of T1, T2 (FDM, OC, OCFE), T3, M5,
    M14 and the M14 sweep at their shapes; the cheap rows (T2 by each
    method, M5) are rmt_tpu's rmtExe on hetero_case's inputs, at 1e-12."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "models_ref.npz")
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    shapes = {"t1_xy": (7, 7), "t1_state": (49,), "t1_attempts": (2,),
              "t2_xy": (7, 7), "t2_oc_xy": (7, 7), "t2_fem_xy": (7, 19),
              "t3_xy": (7, 10), "t3_data_ys": (7, 10), "m5_xy": (9, 25),
              "m14_xy": (14, 30), "m14_data_ys": (14, 30),
              "m14_sweep_t0": (3,), "m14_sweep_states": (3, 7, 2, 30),
              "m2_packtime": (7, 10, 100), "m2_state": (700,),
              "m2_attempts": (2,), "m0_xy": (7, 100), "m1_xy": (9, 25),
              "m1_data_ys": (7, 25), "m3_xy": (7, 101), "m4_xy": (7, 100),
              "m7_xy": (7, 30), "m7_data_ys": (7, 30), "m8_xy": (7, 25),
              "m8_data_ys": (7, 25)}
    assert {k: ref[k].shape for k in shapes} == shapes
    np.testing.assert_array_equal(ref["m14_sweep_t0"],
                                  [523.0, 523.0 + 20.0 * 128 / 255, 543.0])
    for key, mi in (("t2", hetero_case.t2_model_input()),
                    ("t2_oc", hetero_case.t2_model_input("oc")),
                    ("t2_fem", hetero_case.t2_model_input("fem")),
                    ("m5", pb_case.flow_model_input("M5"))):
        res = rmt_tpu.rmtExe(mi)["resModel"]
        _close(np.stack([np.asarray(r[1], np.float64)
                         for r in res["XYList"]]), ref[f"{key}_xy"], 1e-12)
