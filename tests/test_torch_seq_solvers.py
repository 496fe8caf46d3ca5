# The port's sequential integrators (rmt_tpu_torch.solvers: radau.odeint,
# dopri5.odeint, fixed.rk4 / adams_bashforth3 / precorr3) against
# rmt_tpu's on the problems of tests/test_solvers.py, in float64 on the
# CPU, and their member-batched loops (odeint_batched) against the
# members' own B = 1 runs, bit for bit, and against jax.vmap of the
# reference integrator.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmt_tpu.solvers import dopri5 as j_dopri5
from rmt_tpu.solvers import fixed as j_fixed
from rmt_tpu.solvers import radau as j_radau
from rmt_tpu_torch.solvers import dopri5, fixed, radau

F64 = torch.float64
LV_PARAMS = (1.5, 1.0, 3.0, 1.0)
LV_Y0 = np.array([10.0, 5.0])


def _lotka_j(t, z, params):
    a, b, c, d = params
    x, y = z
    return jnp.stack([a * x - b * x * y, -c * y + d * x * y])


def _lotka_t(t, z, params):
    a, b, c, d = params
    x, y = z[..., 0], z[..., 1]
    return torch.stack([a * x - b * x * y, -c * y + d * x * y], dim=-1)


def _decay_j(t, y):
    return -2.0 * y


def _decay_t(t, y):
    return -2.0 * y


def _robertson_j(t, y, k1=0.04):
    y1, y2, y3 = y
    d1 = -k1 * y1 + 1e4 * y2 * y3
    d3 = 3e7 * y2**2
    return jnp.stack([d1, -d1 - d3, d3])


def _robertson_t(t, y, k1=0.04):
    y1, y2, y3 = y[..., 0], y[..., 1], y[..., 2]
    d1 = -k1 * y1 + 1e4 * y2 * y3
    d3 = 3e7 * y2**2
    return torch.stack([d1, -d1 - d3, d3], dim=-1)


@pytest.mark.parametrize("method", ["rk4", "adams_bashforth3", "precorr3"])
def test_fixed_steppers_match_jax(method):
    n, t0, tn = 150, 0.0, 10.0
    want = np.asarray(getattr(j_fixed, method)(
        _lotka_j, t0, tn, n, jnp.asarray(LV_Y0), args=(LV_PARAMS,)))
    got = getattr(fixed, method)(_lotka_t, t0, tn, n,
                                 torch.tensor(LV_Y0, dtype=F64),
                                 args=(LV_PARAMS,)).numpy()
    assert got.shape == want.shape == (n + 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("problem", ["decay", "lotka"])
def test_dopri5_matches_jax(problem):
    """ys to 1e-10 relative and the statistics equal."""
    if problem == "decay":
        ts, y0 = np.linspace(0.0, 2.0, 11), np.array([1.0, 3.0])
        kw = dict(rtol=1e-9, atol=1e-12)
        yj, sj = j_dopri5.odeint(_decay_j, jnp.asarray(y0), jnp.asarray(ts),
                                 **kw)
        yt, st = dopri5.odeint(_decay_t, torch.tensor(y0, dtype=F64),
                               torch.tensor(ts, dtype=F64), **kw)
        np.testing.assert_allclose(
            yt.numpy(), np.exp(-2.0 * ts)[:, None] * y0, rtol=1e-7)
    else:
        ts, y0 = np.linspace(0.0, 10.0, 21), LV_Y0
        kw = dict(rtol=1e-10, atol=1e-12)
        yj, sj = j_dopri5.odeint(_lotka_j, jnp.asarray(y0), jnp.asarray(ts),
                                 args=(LV_PARAMS,), **kw)
        yt, st = dopri5.odeint(_lotka_t, torch.tensor(y0, dtype=F64),
                               torch.tensor(ts, dtype=F64),
                               args=(LV_PARAMS,), **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-10)
    assert {k: int(v) for k, v in st._asdict().items()} == {
        k: int(v) for k, v in sj._asdict().items()}


def test_radau_robertson_matches_jax():
    """The stiff Robertson kinetics (tests/test_solvers.py): ys to 1e-8
    relative (atol 1e-14) and the same accepted and rejected steps."""
    ts = np.asarray([0.0, 1e-2, 1e0, 1e2, 1e4])
    y0 = np.array([1.0, 0.0, 0.0])
    yj, sj = j_radau.odeint(_robertson_j, jnp.asarray(y0), jnp.asarray(ts),
                            rtol=1e-8, atol=1e-12)
    yt, st = radau.odeint(_robertson_t, torch.tensor(y0, dtype=F64), ts,
                          rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-8,
                               atol=1e-14)
    np.testing.assert_allclose(yt.numpy().sum(axis=1), 1.0, rtol=1e-9)
    assert int(st.n_accepted) == int(sj.n_accepted)
    assert int(st.n_rejected) == int(sj.n_rejected)
    assert int(st.n_unreached) == 0


def _ragged_members(solver):
    """(f, f_member(b), y0 (B, n), ts (B, T), kw): three members with
    different rates and different output times (ragged step counts)."""
    if solver == "radau":
        k1 = torch.tensor([0.04, 0.02, 0.1], dtype=F64)
        ts = torch.tensor([[0.0, 1e-2, 1.0, 1e2], [0.0, 0.5, 3.0, 50.0],
                           [0.0, 1e-3, 1e-1, 10.0]], dtype=F64)
        y0 = torch.tensor([[1.0, 0.0, 0.0]] * 3, dtype=F64)
        return (lambda t, y: _robertson_t(t, y, k1),
                lambda b: (lambda t, y: _robertson_t(t, y, k1[b:b + 1])),
                y0, ts, dict(rtol=1e-6, atol=1e-10), radau)
    lam = torch.tensor([[1.5, 1.0, 3.0, 1.0], [1.2, 0.8, 2.5, 1.1],
                        [2.0, 1.0, 3.0, 0.7]], dtype=F64)
    ts = torch.stack([torch.linspace(0, 10, 11, dtype=F64),
                      torch.linspace(0, 7, 11, dtype=F64),
                      torch.linspace(0, 12, 11, dtype=F64)])
    y0 = torch.tensor([[10.0, 5.0], [8.0, 4.0], [5.0, 6.0]], dtype=F64)
    return (lambda t, y: _lotka_t(t, y, lam.unbind(1)),
            lambda b: (lambda t, y: _lotka_t(t, y, lam[b:b + 1].unbind(1))),
            y0, ts, dict(rtol=1e-9, atol=1e-12), dopri5)


@pytest.mark.parametrize("solver", ["radau", "dopri5"])
def test_batched_members_equal_their_own_runs_bit_for_bit(solver):
    f, f_member, y0, ts, kw, mod = _ragged_members(solver)
    ys, st = mod.odeint_batched(f, y0, ts, **kw)
    att = st.n_accepted + st.n_rejected
    assert len(set(att.tolist())) == 3          # ragged step counts
    for b in range(3):
        yb, sb = mod.odeint_batched(f_member(b), y0[b:b + 1], ts[b:b + 1],
                                    **kw)
        assert torch.equal(yb[0], ys[b]), b
        for name, v in sb._asdict().items():
            assert int(v[0]) == int(getattr(st, name)[b]), (b, name)


def test_max_steps_unreached_matches_jax_vmap():
    """A step budget that stops some members: the per-member n_unreached
    (and every other statistic) equals jax.vmap(radau.odeint)'s."""
    k1 = np.array([0.04, 0.4, 4.0])
    ts = np.asarray([0.0, 1e-2, 1e0, 1e2])
    y0 = np.array([1.0, 0.0, 0.0])
    kw = dict(rtol=1e-6, atol=1e-10, max_steps=60)

    def one(k):
        return j_radau.odeint(lambda t, y: _robertson_j(t, y, k),
                              jnp.asarray(y0), jnp.asarray(ts), **kw)

    yj, sj = jax.vmap(one)(jnp.asarray(k1))
    kt = torch.tensor(k1, dtype=F64)
    yt, st = radau.odeint_batched(
        lambda t, y: _robertson_t(t, y, kt),
        torch.tensor(y0, dtype=F64).expand(3, 3), torch.tensor(ts), **kw)
    unreached = st.n_unreached.tolist()
    assert 0 < sum(unreached) and min(unreached) == 0, unreached
    for name, v in st._asdict().items():
        assert v.tolist() == np.asarray(getattr(sj, name)).tolist(), name
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-8,
                               atol=1e-14)


def test_odeint_takes_args_and_a_jacobian():
    """args reach f, and a caller's jac replaces the AD Jacobian (the
    exact one: the same steps)."""
    def decay(t, y, k):
        return -k * y

    ts = torch.linspace(0.0, 1.0, 5, dtype=F64)
    y0 = torch.tensor([1.0, 2.0], dtype=F64)
    ys, st = radau.odeint(decay, y0, ts, rtol=1e-9, atol=1e-12,
                          args=(torch.tensor([0.5, 2.0], dtype=F64),))
    ys2, st2 = radau.odeint(
        decay, y0, ts, rtol=1e-9, atol=1e-12,
        args=(torch.tensor([0.5, 2.0], dtype=F64),),
        jac=lambda t, y: -torch.diag(torch.tensor([0.5, 2.0], dtype=F64)))
    want = np.exp(-np.array([0.5, 2.0])[None] * ts.numpy()[:, None]) * [1, 2]
    np.testing.assert_allclose(ys.numpy(), want, rtol=1e-7)
    np.testing.assert_allclose(ys2.numpy(), ys.numpy(), rtol=1e-12)
    assert int(st.n_accepted) == int(st2.n_accepted)


def test_reverse_jacobian_equals_forward_mode():
    """reverse_jacobian (the sequential integrator's default) is the
    forward-mode batched_jacobian of the lockstep integrator up to
    rounding."""
    from rmt_tpu_torch.solvers.stiff_ensemble import batched_jacobian

    k1 = torch.tensor([0.04, 0.4], dtype=F64)

    def f(t, y):
        return _robertson_t(t, y, k1)

    y = torch.tensor([[0.9, 1e-5, 0.1], [0.5, 2e-5, 0.5]], dtype=F64)
    t = torch.zeros(2, dtype=F64)
    Jr = radau.reverse_jacobian(f, t, y)
    Jf = batched_jacobian(f, t, y)
    assert Jr.shape == (2, 3, 3)
    torch.testing.assert_close(Jr, Jf, rtol=1e-14, atol=0)
