# The rest of rmt_tpu's N2 ensemble options in the port, each held to
# rmt_tpu on the CPU: accurate_rates=True and "full" (make_n2_rhs with a
# float64 kinetics chain, the whole RHS in float64), the member-last RHS
# (homo.make_n2_rhs_b, make_n2_colored_jacobian_b), the lockstep entry
# point's colored_jacobian, fused_rhs, batched_rhs and float64 mode and
# its argument checks, odeint_ensemble's tuning arguments (rhs_noise,
# max_factor, predict_stages, theta_target, newton_h_barrier, args,
# batched=False), and the three props/thermo functions. The lockstep runs
# are short (period 0.002 s, B = 2) to keep the CPU time small; the JAX
# side runs in this x64 test process as tests/test_ensemble.py runs it.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import dme_case
from rmt_tpu.models import homo as jhomo
from rmt_tpu.parallel import batch_params as j_batch_params
from rmt_tpu.parallel import run_n2_ensemble_lockstep as j_run
from rmt_tpu.props import thermo as jthermo
from rmt_tpu.solvers import stiff_ensemble as j_se
from rmt_tpu_torch.cases.dme_case import make_model_input as t_input
from rmt_tpu_torch.convert import params_from_jax
from rmt_tpu_torch.models import homo as thomo
from rmt_tpu_torch.parallel import Mesh, prepare_n2_ensemble
from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep as t_run
from rmt_tpu_torch.parallel.ensemble import n2_mode_functions
from rmt_tpu_torch.props import thermo as tthermo
from rmt_tpu_torch.solvers import stiff_ensemble as t_se

T0 = 523.0 + np.array([0.0, 5.0])
PERIOD = 0.002
F32X = dict(max_steps=768, rtol=1e-5, atol=1e-7, newton_iters=5, j_every=8,
            accurate_rates="df32", exact_solve=True, cheap_sweeps=2)
F64 = dict(rtol=1e-7, atol=1e-10, max_steps=768, newton_iters=6)


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _attempts(st):
    return np.asarray(st.n_accepted) + np.asarray(st.n_rejected)


# ---------------------------------------------------------------------------
# props/thermo
# ---------------------------------------------------------------------------

def test_thermo_functions_match_jax():
    """enthalpy_change, concentration_ig and mole_fraction_from_
    concentration at float64 against rmt_tpu's, 1e-12 relative."""
    idx = np.array([0, 2, 4, 5])
    T = np.array([480.0, 523.0, 611.5])
    flows = np.array([[1.0, 2.0, 0.5, 0.1], [0.3, 0.2, 0.1, 4.0]])
    conc = np.array([[10.0, 3.0, 0.2, 1e-3], [0.5, 0.5, 8.0, 2.0]])
    pairs = (
        (tthermo.enthalpy_change(torch.as_tensor(T), idx),
         jthermo.enthalpy_change(jnp.asarray(T), idx)),
        (tthermo.enthalpy_change(torch.as_tensor(T), idx, T1=400.0),
         jthermo.enthalpy_change(jnp.asarray(T), idx, T1=400.0)),
        (tthermo.concentration_ig(torch.as_tensor(flows), 2.5),
         jthermo.concentration_ig(jnp.asarray(flows), 2.5)),
        (tthermo.mole_fraction_from_concentration(torch.as_tensor(conc)),
         jthermo.mole_fraction_from_concentration(jnp.asarray(conc))),
    )
    for got, want in pairs:
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the RHS variants
# ---------------------------------------------------------------------------

def _member(dtype=np.float64, seed=0):
    """One member's parameters, feed state and a state 5% off the initial
    one, the same numbers for both packages (tests/test_torch_homo.py)."""
    mi = dme_case.make_model_input(model="N2")
    jspec, tspec = jhomo.build_spec(mi), thomo.build_spec(mi)
    p = jhomo.build_params(mi)
    if dtype == np.float32:
        p = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float32)), p)
    d = jhomo.feed_state(jspec, p)
    if dtype == np.float32:
        d = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float32)), d)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    tp = params_from_jax(p, device="cpu", dtype=tdt)
    td = params_from_jax(d, device="cpu", dtype=tdt)
    y0 = np.asarray(jhomo.n2_initial_state(jspec, p, d), np.float64)
    rng = np.random.default_rng(seed)
    y = (y0 * (1 + 0.05 * rng.uniform(size=y0.shape))).astype(dtype)
    return jspec, tspec, p, d, tp, td, y


def test_rhs_accurate_rates_true_matches_jax():
    """make_n2_rhs(accurate_rates=True) on float32 parameters and state:
    the kinetics chain, nu@R and the heat of reaction in float64, the
    result float32. Within test_torch_homo.py::
    test_rhs_df32_matches_jax_df32's bar of rmt_tpu's (1e-6 of the
    scale), no further from the float64 RHS than twice rmt_tpu (or 2e-7
    of the scale, a few float32 ulps: the rest of the RHS is float32),
    and closer to it than the plain float32 RHS."""
    jspec, tspec, p, d, tp, td, y = _member(np.float32, seed=1)
    want = jax.jit(jhomo.make_n2_rhs(jspec, accurate_rates=True))(
        np.float32(0.0), jnp.asarray(y), p, d)
    got = thomo.make_n2_rhs(tspec, accurate_rates=True)(
        0.0, torch.as_tensor(y), tp, td)
    assert got.dtype == torch.float32
    assert _scaled(got.numpy(), want) < 1e-6
    up = lambda tree: {k: up(v) if isinstance(v, dict) else v.double()
                       for k, v in tree.items()}
    ref64 = thomo.make_n2_rhs(tspec)(0.0, torch.as_tensor(y).double(),
                                     up(tp), up(td)).numpy()
    plain = thomo.make_n2_rhs(tspec)(0.0, torch.as_tensor(y), tp, td)
    assert _scaled(got.numpy(), ref64) < max(2 * _scaled(want, ref64), 2e-7)
    assert _scaled(got.numpy(), ref64) < _scaled(plain.numpy(), ref64)
    with pytest.raises(ValueError, match="accurate_rates"):
        thomo.make_n2_rhs(tspec, accurate_rates="full")


def test_full_mode_rhs_is_float64_inside():
    """Under "full" the lockstep RHS and its Jacobian evaluate in float64
    on float64 parameters and feed state, although the state is float32
    and each member's parameters are 0-dim tensors under vmap (which do
    not promote a float32 tensor): the result equals the float64 RHS cast
    to float32 bit for bit, differs from the plain float32 RHS, and
    matches rmt_tpu's "full" RHS (float64 by promotion, cast to float32)
    within 2 float32 ulps of the scale."""
    mi = t_input(model="N2")
    sweep = {"T0": T0}
    e64 = prepare_n2_ensemble(mi, sweep, device="cpu",
                              rhs_dtype=torch.float64)
    e32 = prepare_n2_ensemble(mi, sweep, device="cpu")
    assert e64.params["T0"].dtype == e64.d["GaDe0"].dtype == torch.float64
    assert e64.y0.dtype == e64.ts.dtype == torch.float32
    rng = np.random.default_rng(2)
    y = (e32.y0.double() * (1 + 0.05 * torch.as_tensor(
        rng.uniform(size=tuple(e32.y0.shape))))).float()
    t = torch.zeros(2)
    rhs_full, jac_full, blocks_full = n2_mode_functions(e64.spec, "full")
    rhs32, jac32, _ = n2_mode_functions(e32.spec, False)
    axes = (0, 0, e64.axes, 0)
    got = vmap(rhs_full, in_dims=axes)(t, y, e64.params, e64.d)
    assert got.dtype == torch.float32
    ref64 = vmap(thomo.make_n2_rhs(e64.spec), in_dims=axes)(
        t.double(), y.double(), e64.params, e64.d)
    assert torch.equal(got, ref64.float())
    plain = vmap(rhs32, in_dims=axes)(t, y, e32.params, e32.d)
    assert not torch.equal(got, plain)
    assert _scaled(plain.numpy(), ref64.numpy()) > 10 * _scaled(
        got.numpy(), ref64.numpy())
    J = vmap(jac_full, in_dims=axes)(t, y, e64.params, e64.d)
    J64 = vmap(thomo.make_n2_colored_jacobian(e64.spec), in_dims=axes)(
        t.double(), y.double(), e64.params, e64.d)
    assert J.dtype == torch.float32 and torch.equal(J, J64.float())
    Jd, _ = vmap(blocks_full, in_dims=axes)(t, y, e64.params, e64.d)
    assert Jd.dtype == torch.float64
    # rmt_tpu's "full": float64 parameters and feed state, float32 state
    jspec = jhomo.build_spec(dme_case.make_model_input(model="N2"))
    jp, jaxes = j_batch_params(
        jhomo.build_params(dme_case.make_model_input(model="N2")),
        {"T0": jnp.asarray(T0)})
    jd = jax.vmap(lambda q: jhomo.feed_state(jspec, q), in_axes=(jaxes,))(jp)
    want = jax.jit(jax.vmap(jhomo.make_n2_rhs(jspec),
                            in_axes=(0, 0, jaxes, 0)))(
        jnp.zeros(2, jnp.float32), jnp.asarray(y.numpy()), jp, jd)
    assert want.dtype == jnp.float64
    assert _scaled(got.numpy(), np.asarray(want).astype(np.float32)) < 1.2e-7


@pytest.mark.parametrize("mode", ["plain-f64", "plain-f32", "df32-f32"])
def test_rhs_b_matches_jax(mode):
    """tests/test_batched_rhs.py's check on the port: the member-last RHS
    equals the vmapped per-member RHS, and here rmt_tpu's make_n2_rhs_b on
    the same leaves. float64: 1e-12 relative of the scale (the reference
    holds its own two layouts to rtol 1e-12; the port's core sums the
    pressure march and nu@R in node and reaction order, measured
    2.6e-15); float32: 5e-5 of the scale against rmt_tpu, the fused
    kernel's bar (tests/test_fused_rhs.py: summation order, PyTorch's
    number / tensor), and bit for bit against the fused kernel's twin
    (make_n2_rhs_b is its core); df32: 1e-6, the df32 RHS bar."""
    acc, dt = mode.split("-")
    acc = False if acc == "plain" else "df32"
    dtype = np.float64 if dt == "f64" else np.float32
    B = 3
    mi = dme_case.make_model_input(model="N2")
    jspec, tspec = jhomo.build_spec(mi), thomo.build_spec(mi)
    jp, jaxes = j_batch_params(jhomo.build_params(mi), {
        "T0": jnp.asarray(523.0 + np.linspace(-5, 5, B))})
    if dtype == np.float32:
        jp = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float32)),
                          jp)
    jd, jy0 = jax.vmap(lambda q: (jhomo.feed_state(jspec, q),
                                  jhomo.n2_initial_state(
                                      jspec, q, jhomo.feed_state(jspec, q))),
                       in_axes=(jaxes,))(jp)
    jpB = {k: ({kk: jnp.broadcast_to(jnp.asarray(vv), (B,))
                for kk, vv in v.items()} if k == "kinetic_overrides"
               else (v if jaxes[k] == 0 else jnp.broadcast_to(
                   jnp.asarray(v)[None], (B,) + jnp.asarray(v).shape)))
           for k, v in jp.items()}
    rng = np.random.default_rng(0)
    y = (np.asarray(jy0, np.float64) * (1 + 0.05 * rng.standard_normal(
        jy0.shape))).astype(dtype)
    jdB = jax.tree.map(lambda v: jnp.asarray(np.asarray(v, dtype)), jd)
    want = jax.jit(jhomo.make_n2_rhs_b(jspec, accurate_rates=acc))(
        jnp.zeros(B, dtype), jnp.asarray(y), jpB, jdB)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    tpB = params_from_jax(jpB, device="cpu", dtype=tdt)
    tdB = params_from_jax(jdB, device="cpu", dtype=tdt)
    yt = torch.as_tensor(y)
    got = thomo.make_n2_rhs_b(tspec, accurate_rates=acc)(
        torch.zeros(B, dtype=tdt), yt, tpB, tdB)
    assert got.dtype == tdt and tuple(got.shape) == y.shape
    bar = {"plain-f64": 1e-12, "plain-f32": 5e-5, "df32-f32": 1e-6}[mode]
    assert _scaled(got.numpy(), want) < bar
    per_member = vmap(thomo.make_n2_rhs(tspec, accurate_rates=acc),
                      in_dims=(0, 0, 0, 0))(torch.zeros(B, dtype=tdt), yt,
                                             tpB, tdB)
    assert _scaled(got.numpy(), per_member.numpy()) < bar
    if dt == "f32":
        from rmt_tpu_torch.ops import cuda_rhs
        leaves = cuda_rhs.pack_leaves(tpB, tdB)
        twin = cuda_rhs.n2_rhs_twin(tspec, acc == "df32", (), yt, *leaves)
        assert torch.equal(got, twin)


def test_colored_jacobian_b_matches_jax():
    """tests/test_batched_rhs.py::test_jacobian_b_matches_vmapped on the
    port, float64: the batched colored Jacobian of the member-last RHS
    against rmt_tpu's and against the port's vmapped per-member colored
    Jacobian, 1e-12 of the scale."""
    B = 3
    mi = dme_case.make_model_input(model="N2")
    jspec, tspec = jhomo.build_spec(mi), thomo.build_spec(mi)
    jp, jaxes = j_batch_params(jhomo.build_params(mi), {
        "T0": jnp.asarray(523.0 + np.linspace(-5, 5, B))})
    jd, jy0 = jax.vmap(lambda q: (jhomo.feed_state(jspec, q),
                                  jhomo.n2_initial_state(
                                      jspec, q, jhomo.feed_state(jspec, q))),
                       in_axes=(jaxes,))(jp)
    jpB = {k: ({kk: jnp.broadcast_to(jnp.asarray(vv), (B,))
                for kk, vv in v.items()} if k == "kinetic_overrides"
               else (v if jaxes[k] == 0 else jnp.broadcast_to(
                   jnp.asarray(v)[None], (B,) + jnp.asarray(v).shape)))
           for k, v in jp.items()}
    rng = np.random.default_rng(0)
    y = np.asarray(jy0) * (1.0 + 0.05 * rng.standard_normal(jy0.shape))
    want = np.asarray(jax.jit(jhomo.make_n2_colored_jacobian_b(jspec))(
        jnp.zeros(B), jnp.asarray(y), jpB, jd))
    tpB = params_from_jax(jpB, device="cpu", dtype=torch.float64)
    tdB = params_from_jax(jd, device="cpu", dtype=torch.float64)
    got = thomo.make_n2_colored_jacobian_b(tspec)(
        torch.zeros(B, dtype=torch.float64), torch.as_tensor(y), tpB, tdB)
    assert tuple(got.shape) == (B, 140, 140)
    assert _scaled(got.numpy(), want) < 1e-12
    per_member = vmap(thomo.make_n2_colored_jacobian(tspec))(
        torch.zeros(B, dtype=torch.float64), torch.as_tensor(y), tpB, tdB)
    assert _scaled(got.numpy(), per_member.numpy()) < 1e-12


# ---------------------------------------------------------------------------
# the lockstep entry point
# ---------------------------------------------------------------------------

# (options of both packages, the port's extra options, bar of the
# trajectories): tests/test_ensemble.py's 5e-4 for the float32 runs;
# float64 runs meet 1e-10 (measured 1.8e-13 to 2.5e-13). rmt_tpu in this
# x64 process integrates float64 states unless an accurate_rates mode is
# on, so batched_rhs is held to it in float64 (its float32 and df32 RHS
# are held to rmt_tpu's in test_rhs_b_matches_jax); fused_rhs=False rides
# with accurate_rates=True (its cheap sweeps then take the vmapped plain
# RHS instead of the fused kernel's twin). chip_smoke.py's n2_opts phase
# runs each option in its float32 mode on the card.
LOCKSTEP = {
    "accurate_rates_true_fused_rhs_false": (
        dict(F32X, accurate_rates=True, fused_rhs=False), {}, 5e-4),
    "accurate_rates_full": (dict(F32X, accurate_rates="full"), {}, 5e-4),
    "float64": (F64, {"dtype": torch.float64}, 1e-10),
    "float64_batched_rhs": (dict(F64, batched_rhs=True),
                            {"dtype": torch.float64}, 1e-10),
    "float64_colored_jacobian_false": (
        dict(F64, colored_jacobian=False), {"dtype": torch.float64}, 1e-10),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_lockstep_option_matches_jax(case):
    """run_n2_ensemble_lockstep with each option against rmt_tpu's at
    B = 2 (period 0.002 s): every member finishes, trajectories within the
    case's bar (relative, denominator max(|ref|, 1e-7)), attempts within
    1.25 times rmt_tpu's, the states' dtype the run's."""
    opts, extra, bar = LOCKSTEP[case]
    ys_j, st_j = j_run(dme_case.make_model_input(model="N2",
                                                 op_period=PERIOD),
                       {"T0": jnp.asarray(T0)}, **opts)
    ys_t, st_t = t_run(t_input(model="N2", op_period=PERIOD), {"T0": T0},
                       device="cpu", **opts, **extra)
    assert ys_t.dtype == extra.get("dtype", torch.float32)
    assert np.asarray(ys_j).dtype == (np.float64 if extra else np.float32)
    assert int(torch.sum(st_t.seg < ys_t.shape[0] - 1)) == 0
    assert bool(torch.isfinite(ys_t).all())
    ys_j = np.asarray(ys_j, np.float64)
    rel = np.abs(ys_t.double().numpy() - ys_j) / np.maximum(np.abs(ys_j),
                                                           1e-7)
    assert float(rel.max()) < bar, float(rel.max())
    assert _attempts(st_t).max() <= 1.25 * _attempts(st_j).max()


# every error rmt_tpu raises for these options, with its type and message
BAD_OPTIONS = {
    "cheap_sweeps_without_accurate_rates": (dict(cheap_sweeps=2),
                                            "cheap_sweeps only makes sense"),
    "cheap_sweeps_with_batched_rhs": (
        dict(accurate_rates="df32", cheap_sweeps=2, batched_rhs=True),
        "cheap_sweeps \\+ batched_rhs not supported"),
    "exact_solve_without_colored_jacobian": (
        dict(exact_solve=True, colored_jacobian=False),
        "exact_solve requires colored_jacobian=True"),
    "batched_rhs_with_accurate_rates_true": (
        dict(accurate_rates=True, batched_rhs=True),
        "batched_rhs supports plain f32"),
    "batched_rhs_with_full": (dict(accurate_rates="full", batched_rhs=True),
                              "batched_rhs supports plain f32"),
    "fused_rhs_with_accurate_rates_true": (
        dict(accurate_rates=True, fused_rhs=True),
        "fused_rhs supports plain f32"),
    "fused_rhs_with_full": (dict(accurate_rates="full", fused_rhs=True),
                            "fused_rhs supports plain f32"),
    "fused_rhs_and_batched_rhs": (dict(fused_rhs=True, batched_rhs=True),
                                  "fused_rhs and batched_rhs are exclusive"),
}


@pytest.mark.parametrize("case", list(BAD_OPTIONS))
def test_option_errors_match_jax(case):
    opts, msg = BAD_OPTIONS[case]
    sweep_j, sweep_t = {"T0": jnp.asarray(T0)}, {"T0": T0}
    with pytest.raises(ValueError, match=msg):
        j_run(dme_case.make_model_input(model="N2", op_period=PERIOD),
              sweep_j, **opts)
    with pytest.raises(ValueError, match=msg):
        t_run(t_input(model="N2", op_period=PERIOD), sweep_t,
              device="cpu", **opts)


def test_port_only_option_errors():
    """The float64 mode takes no accurate_rates mode and no fused kernel;
    mesh= with microbatch raises ValueError (rmt_tpu's error)."""
    mi, sweep = t_input(model="N2", op_period=PERIOD), {"T0": T0}
    with pytest.raises(ValueError, match="float32 states"):
        t_run(mi, sweep, device="cpu", dtype=torch.float64,
              accurate_rates="df32")
    with pytest.raises(ValueError, match="float32 only"):
        t_run(mi, sweep, device="cpu", dtype=torch.float64, fused_rhs=True)
    with pytest.raises(ValueError, match="unknown accurate_rates"):
        t_run(mi, sweep, device="cpu", accurate_rates="f64")
    with pytest.raises(ValueError, match="microbatch and mesh"):
        t_run(mi, sweep, mesh=Mesh(None, 0, 2, torch.device("cpu")),
              microbatch=1)


# ---------------------------------------------------------------------------
# odeint_ensemble's tuning arguments, on Robertson's stiff kinetics
# ---------------------------------------------------------------------------

ROB_TS = np.array([0.0, 1e-2, 1.0, 10.0])
ROB_Y0 = np.array([[1.0, 0.0, 0.0], [0.9, 0.05, 0.05]])
ROB_KW = dict(rtol=1e-6, atol=1e-10, max_steps=512)


def _rob(xp, stack):
    def f(t, y, k1=0.04):
        y1, y2, y3 = y[0], y[1], y[2]
        d1 = -k1 * y1 + 1e4 * y2 * y3
        d3 = 3e7 * y2 * y2
        return stack([d1, -d1 - d3, d3])

    return f


TUNING = {
    "batched_false": {},
    "args": {"args": (0.05,)},
    "rhs_noise": {"rhs_noise": 1e-9},
    "max_factor": {"max_factor": 1.6},
    "predict_stages": {"predict_stages": False},
    "theta_target": {"theta_target": 0.3},
    "newton_h_barrier": {"newton_h_barrier": True},
}


@pytest.mark.parametrize("case", list(TUNING))
def test_odeint_ensemble_tuning_matches_jax(case):
    """Each argument on Robertson's kinetics at B = 2, float64 states,
    Newton-Schulz mode, f one member's RHS (batched=False, the default)
    mapped by the integrator, its Jacobian by jacfwd over members: the
    port against rmt_tpu's odeint_ensemble with the same argument,
    trajectories within 1e-6 relative (atol 1e-12; both runs' float32
    preconditioners round differently), attempts within 1.25 times."""
    kw = dict(ROB_KW, **TUNING[case])
    f_j = _rob(jnp, jnp.stack)
    f_t = _rob(torch, torch.stack)
    if case == "args":
        kw_j = dict(kw, args=(jnp.asarray(0.05),))
        kw_t = dict(kw, args=(torch.tensor(0.05, dtype=torch.float64),))
    else:
        kw_j = kw_t = kw
    ys_j, st_j = j_se.odeint_ensemble(f_j, jnp.asarray(ROB_Y0),
                                      jnp.asarray(ROB_TS), **kw_j)
    ys_t, st_t = t_se.odeint_ensemble(f_t, torch.as_tensor(ROB_Y0), ROB_TS,
                                      **kw_t)
    assert int(torch.sum(st_t.seg < len(ROB_TS) - 1)) == 0
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-6,
                               atol=1e-12)
    assert _attempts(st_t).max() <= 1.25 * _attempts(st_j).max()


def test_batched_false_equals_batched_true():
    """batched=False maps one member's f with torch.func.vmap: the same
    run as the batched f with the batched Jacobian, bit for bit where the
    arithmetic is elementwise."""
    f_t = _rob(torch, torch.stack)
    fB = lambda t, y: _rob(torch, lambda xs: torch.stack(xs, dim=-1))(
        t, y.T)
    ys_a, st_a = t_se.odeint_ensemble(f_t, torch.as_tensor(ROB_Y0), ROB_TS,
                                      **ROB_KW)
    ys_b, st_b = t_se.odeint_ensemble(fB, torch.as_tensor(ROB_Y0), ROB_TS,
                                      batched=True, **ROB_KW)
    assert torch.equal(ys_a, ys_b)
    assert torch.equal(st_a.n_accepted, st_b.n_accepted)
