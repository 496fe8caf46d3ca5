# The packed-bed, plug-flow and batch models of the port (rmt_tpu_torch/
# models/pb.py, pf.py, batch.py) and their rmtExe runners against rmt_tpu
# on the CPU in float64: build_params key by key; the initial states and
# RHS of M0/M4, M1, M2, M3, M7 (pb.m3_*), M8 (pb.m4_*) and M9 on perturbed
# states; the colored Jacobian of M2 and M9 and its extracted blocks; and
# rmtExe M0, M1, M3, M4, M7 and M8. The inputs are rmt_tpu's own tests'
# (rmt_tpu_torch/cases/pb_case.py). M2 and M9 end to end:
# tests/test_torch_models_m2.py and tests/test_torch_models_m9.py.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rmt_tpu
import rmt_tpu_torch
from rmt_tpu.models import batch as j_batch
from rmt_tpu.models import pb as j_pb
from rmt_tpu.models import pf as j_pf
from rmt_tpu.ops import block_solve as j_bs
from rmt_tpu.ops import jacobian as j_jac
from rmt_tpu_torch.cases import pb_case
from rmt_tpu_torch.models import batch as t_batch
from rmt_tpu_torch.models import pb as t_pb
from rmt_tpu_torch.models import pf as t_pf
from rmt_tpu_torch.ops import block_solve as t_bs
from rmt_tpu_torch.ops import jacobian as t_jac

# (module pair, model input) of each model's build_params
PARAMS = {
    "pb flow (M1)": ((j_pb, t_pb), lambda: pb_case.flow_model_input("M1")),
    "pb conc (M7)": ((j_pb, t_pb), lambda: pb_case.conc_model_input("M7")),
    "pb kmol (M2)": ((j_pb, t_pb), pb_case.m2_model_input),
    "pf (M0)": ((j_pf, t_pf), lambda: pb_case.flow_model_input("M0")),
    "batch (M3)": ((j_batch, t_batch), pb_case.batch_model_input),
}


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_build_params_key_by_key(case):
    (jm, tm), mi = PARAMS[case]
    want = jm.build_params(mi())
    got = tm.build_params(mi(), device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "kinetic_overrides":
            assert set(got[k]) == set(w)
            continue
        g = got[k]
        assert g.dtype == torch.float64 and g.device.type == "cpu", k
        assert g.shape == tuple(np.shape(w)), k
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


def test_build_params_wants_the_card_by_default():
    """Without device= the parameters go to the CUDA card: on a host
    without one build_params raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for mod, mi in ((t_pb, pb_case.m2_model_input()),
                    (t_pf, pb_case.flow_model_input("M0")),
                    (t_batch, pb_case.batch_model_input())):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.build_params(mi)


def _steady(model):
    """(module pair, model input, initial-state name, RHS maker name)."""
    return {
        "M0": ((j_pf, t_pf), pb_case.flow_model_input("M0"),
               "initial_state", "make_rhs"),
        "M1": ((j_pb, t_pb), pb_case.flow_model_input("M1"),
               "m1_initial_state", "make_m1_rhs"),
        "M3": ((j_batch, t_batch), pb_case.batch_model_input(),
               "initial_state", "make_rhs"),
        "M7": ((j_pb, t_pb), pb_case.conc_model_input("M7"),
               "m3_initial_state", "make_m3_rhs"),
        "M8": ((j_pb, t_pb), pb_case.conc_model_input("M8"),
               "m4_initial_state", "make_m4_rhs"),
    }[model]


def _close(got, want, rtol=1e-12):
    """Equal to rtol, with the floor rtol * max|want| for entries that
    cancel to near zero."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("model", ["M0", "M1", "M3", "M7", "M8"])
def test_steady_rhs_matches_jax(model):
    """Initial state and RHS on states perturbed by up to 30%, at 1e-12
    (M0 stands for M4 too: both run pf.py)."""
    (jm, tm), mi, init, make = _steady(model)
    js, ts = jm.build_spec(mi), tm.build_spec(mi)
    jp, tp = jm.build_params(mi), tm.build_params(mi, device="cpu")
    y0 = np.asarray(getattr(jm, init)(js, jp))
    _close(getattr(tm, init)(ts, tp).numpy(), y0)
    j_rhs, t_rhs = getattr(jm, make)(js), getattr(tm, make)(ts)
    rng = np.random.default_rng(7)
    for _ in range(4):
        y = y0 * rng.uniform(0.7, 1.3, y0.shape)
        _close(t_rhs(0.3, torch.as_tensor(y), tp).numpy(),
               j_rhs(0.3, jnp.asarray(y), jp))


def _dynamic(model, z_no=20):
    mi = pb_case.conc_model_input(model, kmol=True)
    return (mi, j_pb.build_spec(mi, z_no=z_no), t_pb.build_spec(mi, z_no=z_no),
            j_pb.build_params(mi), t_pb.build_params(mi, device="cpu"))


FROZEN = {"M2": "frozen_pressure_jac", "M9": "frozen_march_jac"}


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("model", ["M2", "M9"])
def test_dynamic_rhs_matches_jax(model, frozen):
    """M2 and M9 (and their frozen-march variants) at zNo 20 on states
    perturbed by up to 2%, one state at a time and three as a batch, at
    1e-12."""
    _, js, ts, jp, tp = _dynamic(model)
    make = "make_m2_rhs" if model == "M2" else "make_m9_rhs"
    kw = {FROZEN[model]: True} if frozen else {}
    j_rhs, t_rhs = getattr(j_pb, make)(js, **kw), getattr(t_pb, make)(ts, **kw)
    init = "m2_initial_state" if model == "M2" else "m9_initial_state"
    y0 = np.asarray(getattr(j_pb, init)(js, jp))
    _close(getattr(t_pb, init)(ts, tp).numpy(), y0)
    rng = np.random.default_rng(41)
    ys = np.stack([y0 * rng.uniform(0.98, 1.02, y0.shape) for _ in range(3)])
    batched = t_rhs(0.1, torch.as_tensor(ys), tp).numpy()
    for y, got_b in zip(ys, batched):
        want = j_rhs(0.1, jnp.asarray(y), jp)
        _close(t_rhs(0.1, torch.as_tensor(y), tp).numpy(), want)
        _close(got_b, want)


@pytest.mark.parametrize("model", ["M2", "M9"])
def test_colored_jacobian_and_blocks_match_jax(model):
    """The dense colored Jacobian of the frozen-march RHS (the port's
    batched_colored_jacobian over a batch of two states) and its blocks
    (extract_bidiag_blocks) against rmt_tpu's colored_jacobian and
    extract_bidiag_blocks, at zNo 10, 1e-12."""
    z_no = 10
    _, js, ts, jp, tp = _dynamic(model, z_no)
    make = "make_m2_rhs" if model == "M2" else "make_m9_rhs"
    kw = {FROZEN[model]: True}
    j_rhs, t_rhs = getattr(j_pb, make)(js, **kw), getattr(t_pb, make)(ts, **kw)
    var_no = js.n_comp + 1
    y0 = np.asarray(j_pb.m2_initial_state(js, jp))
    rng = np.random.default_rng(3)
    ys = np.stack([y0 * rng.uniform(0.98, 1.02, y0.shape) for _ in range(2)])
    jac_j = j_jac.colored_jacobian(j_rhs, var_no, z_no)
    want = np.stack([np.asarray(jac_j(0.1, jnp.asarray(y), jp)) for y in ys])
    jac_t = t_jac.batched_colored_jacobian(
        lambda x: t_rhs(None, x, tp), t_jac.banded_coloring(var_no, z_no))
    got = jac_t(torch.as_tensor(ys))
    _close(got.numpy(), want)
    for g, w in zip(t_bs.extract_bidiag_blocks(got, var_no, z_no),
                    j_bs.extract_bidiag_blocks(jnp.asarray(want), var_no,
                                               z_no)):
        _close(g.numpy(), w)


def _result_rows(res):
    return np.stack([np.asarray(xy[1], np.float64) for xy in res["XYList"]])


@pytest.mark.parametrize("model", ["M0", "M1", "M3", "M4", "M7", "M8"])
def test_rmtexe_matches_jax(model):
    """rmtExe against rmt_tpu's: the same result keys and labels, the
    XYList rows and dataYs at 1e-6 relative."""
    want = rmt_tpu.rmtExe(pb_case.model_input(model))["resModel"]
    got = rmt_tpu_torch.rmtExe(pb_case.model_input(model),
                               device="cpu")["resModel"]
    assert set(got) == set(want)
    assert ([d["leg"] for d in got["dataList"]]
            == [d["leg"] for d in want["dataList"]])
    for g, w in ((_result_rows(got), _result_rows(want)),
                 *(((got["dataYs"], want["dataYs"]),) if "dataYs" in want
                   else ())):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, w, rtol=1e-6)
