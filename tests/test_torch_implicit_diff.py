# The port's IFT-differentiable fixed-step Radau
# (rmt_tpu_torch.solvers.implicit_diff: radau_fixed, radau_fixed_batched,
# the stage solve as a torch.autograd.Function) against rmt_tpu's, in
# float64 on the CPU: the final state of the DME N2 model over its real
# 0.5 s period, the adjoint gradient of a weighted outlet functional
# against jax.value_and_grad and against central differences, a member
# batch against its members run alone, and the port's adaptive Radau.
# Both packages get the same parameters (convert.params_from_jax) and the
# kinetic constants K1-K3 as overrides at their 523 K values (at zNo 5
# and 12 steps the reference itself gives NaN with the temperature-
# dependent constants). The JAX side builds its RHS closure once, outside
# any trace.

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dme_case import make_model_input
from rmt_tpu.models import homo as j_homo
from rmt_tpu.parallel import estimation as j_est
from rmt_tpu.solvers.implicit_diff import radau_fixed as j_radau_fixed
from rmt_tpu_torch import convert
from rmt_tpu_torch.models import homo as t_homo
from rmt_tpu_torch.parallel import batch_params
from rmt_tpu_torch.parallel import estimation as t_est
from rmt_tpu_torch.solvers import radau
from rmt_tpu_torch.solvers.implicit_diff import (radau_fixed,
                                                 radau_fixed_batched)

PERIOD = 0.5
Z_NO, N_STEPS = 5, 12

RT = 8.314472 * 523.0
THETA = {
    "K1": math.log(35.45 * math.exp(-1.7069e4 / RT)),
    "K2": math.log(7.3976 * math.exp(-2.0436e4 / RT)),
    "K3": math.log(8.2894e4 * math.exp(-5.2940e4 / RT)),
}
f64 = torch.float64


def _mi():
    return make_model_input(model="N2", op_period=PERIOD)


@pytest.fixture(scope="module")
def case():
    """Both packages' spec, parameters and RHS at zNo 5."""
    mi = _mi()
    jspec = j_homo.build_spec(mi, z_no=Z_NO)
    jp = j_homo.build_params(mi)
    tspec = t_homo.build_spec(mi, z_no=Z_NO)
    return dict(jspec=jspec, jp=jp, jrhs=j_homo.make_n2_rhs(jspec),
                tspec=tspec, tp=convert.params_from_jax(jp, device="cpu"),
                trhs=t_homo.make_n2_rhs(tspec))


def _t_problem(case, theta_log):
    """(f, y0, args) of the port's one-member N2 problem with the
    overrides exp(theta_log)."""
    p = dict(case["tp"])
    p["kinetic_overrides"] = {k: torch.exp(v) for k, v in theta_log.items()}
    d = t_homo.feed_state(case["tspec"], p)
    y0 = t_homo.n2_initial_state(case["tspec"], p, d)
    rhs = case["trhs"]
    return (lambda t, y, a: rhs(t, y, a[0], a[1])), y0, (p, d)


def _weighted(spec, mf, xp):
    """An arbitrary smooth functional of the outlet composition
    (tests/test_implicit_diff.py's)."""
    return xp.sum(xp.arange(1.0, spec.n_comp + 1, dtype=mf.dtype) * mf)


def _t_loss(case, theta_log, n_steps=N_STEPS):
    yf = t_est.simulate_n2_implicit(
        case["tspec"], case["tp"],
        {k: torch.exp(v) for k, v in theta_log.items()}, n_steps)
    return _weighted(case["tspec"],
                     t_est.outlet_mole_fractions(case["tspec"], yf), torch)


def _theta_t(requires_grad=False):
    return {k: torch.tensor(v, dtype=f64, requires_grad=requires_grad)
            for k, v in THETA.items()}


@pytest.fixture(scope="module")
def t_grad(case):
    """The port's loss and adjoint gradients at THETA."""
    th = _theta_t(requires_grad=True)
    loss = _t_loss(case, th)
    g = torch.autograd.grad(loss, list(th.values()))
    return loss.item(), {k: v.item() for k, v in zip(th, g)}


def test_radau_fixed_matches_jax(case):
    """The final state of the N2 model over the full period against
    rmt_tpu's radau_fixed within 1e-9 relative."""
    jp = dict(case["jp"])
    jp["kinetic_overrides"] = {k: jnp.exp(v) for k, v in THETA.items()}
    jd = j_homo.feed_state(case["jspec"], jp)
    jy0 = j_homo.n2_initial_state(case["jspec"], jp, jd)
    jrhs = case["jrhs"]
    want = np.asarray(j_radau_fixed(
        lambda t, y, a: jrhs(t, y, a[0], a[1]), jy0, (0.0, PERIOD), N_STEPS,
        args=(jp, jd)))
    f, y0, args = _t_problem(case, _theta_t())
    got = radau_fixed(f, y0, (0.0, PERIOD), N_STEPS, args=args)
    assert got.dtype == f64 and got.shape == want.shape == (35,)
    assert np.isfinite(want).all()
    rel = np.abs(got.numpy() - want) / np.abs(want)
    assert rel.max() <= 1e-9, rel.max()


def test_radau_fixed_matches_adaptive_at_full_period():
    """96 fixed steps at zNo 10 against the port's adaptive Radau at rtol
    1e-9 (tests/test_implicit_diff.py's check and bar), with the
    temperature-dependent constants."""
    mi = _mi()
    spec = t_homo.build_spec(mi, z_no=10)
    p = t_homo.build_params(mi, device="cpu")
    d = t_homo.feed_state(spec, p)
    y0 = t_homo.n2_initial_state(spec, p, d)
    rhs = t_homo.make_n2_rhs(spec)
    y_ref, stats = radau.odeint(
        lambda t, y: rhs(t, y, p, d), y0,
        torch.tensor([0.0, PERIOD], dtype=f64), rtol=1e-9, atol=1e-12)
    assert int(stats.n_unreached) == 0
    y_fix = radau_fixed(lambda t, y, a: rhs(t, y, a[0], a[1]), y0,
                        (0.0, PERIOD), 96, args=(p, d))
    err = (y_fix - y_ref[-1]).abs() / (y_ref[-1].abs() + 1e-8)
    assert float(err.max()) < 1e-4


def test_radau_fixed_batched_equals_members_alone(case):
    """Three members with their own inlet temperatures and periods in one
    batch equal the same members integrated alone (B = 1) to 1e-12."""
    params, axes = batch_params(case["tp"], {
        "T0": np.array([521.0, 523.0, 526.0]),
        "opT": np.array([0.3, 0.5, 0.4])})
    theta = {k: torch.exp(v) for k, v in _theta_t().items()}
    yb = t_est.simulate_n2_implicit(case["tspec"], params, theta, N_STEPS,
                                    axes=axes)
    assert yb.shape == (3, 35)
    for b in range(3):
        q = dict(case["tp"], T0=params["T0"][b], opT=params["opT"][b])
        y1 = t_est.simulate_n2_implicit(case["tspec"], q, theta, N_STEPS)
        rel = ((yb[b] - y1).abs() / y1.abs()).max()
        assert float(rel) <= 1e-12, (b, float(rel))
    assert float((yb[0] - yb[1]).abs().max()) > 1e-6


def test_ift_gradient_matches_jax(case, t_grad):
    """The adjoint gradients of the weighted outlet functional in the log
    constants against jax.value_and_grad of rmt_tpu's custom_vjp within
    1e-6 relative (the values to 1e-9)."""
    jspec, jrhs = case["jspec"], case["jrhs"]

    def loss(theta_log):
        yf = j_est.simulate_n2_implicit(
            jspec, case["jp"], {k: jnp.exp(v) for k, v in theta_log.items()},
            N_STEPS, rhs=jrhs)
        return _weighted(jspec, j_est.outlet_mole_fractions(jspec, yf), jnp)

    val, grads = jax.value_and_grad(loss)(
        {k: jnp.asarray(v) for k, v in THETA.items()})
    t_val, t_g = t_grad
    assert abs(t_val - float(val)) <= 1e-9 * abs(float(val))
    for k in THETA:
        want = float(grads[k])
        assert want != 0.0
        assert abs(t_g[k] - want) <= 1e-6 * abs(want), (k, t_g[k], want)


def test_ift_gradient_matches_finite_differences(case, t_grad):
    """Each constant's adjoint gradient against central differences
    (eps 1e-4) at tests/test_implicit_diff.py's bar, 2e-4."""
    _, t_g = t_grad
    eps = 1e-4
    for k in THETA:
        side = []
        for sgn in (1.0, -1.0):
            th = _theta_t()
            th[k] = th[k] + sgn * eps
            with torch.no_grad():
                side.append(float(_t_loss(case, th)))
        fd = (side[0] - side[1]) / (2 * eps)
        ad = t_g[k]
        assert abs(ad - fd) <= 2e-4 * max(abs(fd), abs(ad), 1e-3), (k, ad, fd)


def test_gradients_reach_every_input_of_a_linear_problem():
    """y' = -k y over [0, t1] per member, with k an argument tensor: the
    adjoint gradients in y0, k and t1 equal the closed form (to the
    method's error at 40 steps); the guess carries no gradient."""
    k = torch.tensor([[1.0, 3.0], [0.5, 2.0]], dtype=f64, requires_grad=True)
    y0 = torch.tensor([[1.0, 2.0], [3.0, 1.0]], dtype=f64, requires_grad=True)
    t1 = torch.tensor([1.0, 0.7], dtype=f64, requires_grad=True)

    def f(t, Y, a):
        return -a["k"][:, None, :] * Y

    y = radau_fixed_batched(f, y0, (0.0, t1), 40, args={"k": k})
    e = torch.exp(-k * t1[:, None]).detach()
    np.testing.assert_allclose(y.detach().numpy(), (y0.detach() * e).numpy(),
                               rtol=1e-8)
    gk, gy0, gt1 = torch.autograd.grad(y.sum(), [k, y0, t1])
    tc = t1.detach()[:, None]
    want_k = -(tc * y0.detach() * e)
    want_t = torch.sum(-k.detach() * y0.detach() * e, dim=1)
    np.testing.assert_allclose(gk.numpy(), want_k.numpy(), rtol=1e-7)
    np.testing.assert_allclose(gy0.numpy(), e.numpy(), rtol=1e-7)
    np.testing.assert_allclose(gt1.numpy(), want_t.numpy(), rtol=1e-7)
