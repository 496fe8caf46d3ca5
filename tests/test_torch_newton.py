# The port's damped Newton solvers (rmt_tpu_torch.solvers.newton: root,
# root_batched) against rmt_tpu's, in float64 on the CPU, on a seeded
# nonlinear system with a closed-form root: x**3 + p * x + C x = q, with
# p > 0 per member and C a shared symmetric positive semidefinite
# coupling, so the root r is unique and q = r**3 + p r + C r. Both
# packages get the same numpy inputs.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmt_tpu.solvers import newton as j_newton
from rmt_tpu_torch.solvers import newton as t_newton

N = 6


def _system(b, seed=0):
    """(p (b, N), C (N, N), r (b, N)) of b members."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.5, 2.0, (b, N))
    L = 0.3 * rng.standard_normal((N, N))
    C = L @ L.T
    r = rng.uniform(-2.0, 2.0, (b, N))
    return p, C, r


def _residual(p, C, r):
    q = r ** 3 + p * r + r @ C
    return lambda x: x ** 3 + p * x + x @ C - q


def _one(x, p, C, q):
    return x ** 3 + p * x + C @ x - q


def test_root_matches_jax():
    """root from 0 with args: the state to 1e-12, the same iteration
    count, converged, and the closed-form root."""
    p, C, r = _system(1)
    q = r[0] ** 3 + p[0] * r[0] + C @ r[0]
    want = j_newton.root(_one, jnp.zeros(N), args=(jnp.asarray(p[0]),
                                                   jnp.asarray(C),
                                                   jnp.asarray(q)))
    targs = [torch.as_tensor(a) for a in (p[0], C, q)]
    got = t_newton.root(_one, torch.zeros(N, dtype=torch.float64),
                        args=targs)
    assert got.x.dtype == torch.float64 and got.x.shape == (N,)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-12, atol=1e-12)
    assert int(got.iterations) == int(want.iterations) > 2
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), r[0], rtol=1e-10)
    assert float(got.residual_norm) < 1e-10


@pytest.mark.parametrize("max_iter", [3, 30])
def test_root_batched_matches_jax(max_iter):
    """root_batched over 5 members, one of them starting at its root:
    states to 1e-12, equal iteration counts and converged flags (at
    max_iter 3 no moving member has converged yet)."""
    p, C, r = _system(5, seed=1)
    x0 = np.zeros((5, N))
    x0[2] = r[2]
    f_j = _residual(jnp.asarray(p), jnp.asarray(C), jnp.asarray(r))
    want = j_newton.root_batched(f_j, jnp.asarray(x0), max_iter=max_iter)
    f_t = _residual(*(torch.as_tensor(a) for a in (p, C, r)))
    got = t_newton.root_batched(f_t, torch.as_tensor(x0), max_iter=max_iter)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.residual_norm.numpy(),
                               np.asarray(want.residual_norm), rtol=1e-6,
                               atol=1e-14)
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    assert got.converged.tolist() == np.asarray(want.converged).tolist()
    assert got.iterations.dtype == torch.int32
    assert got.iterations[2] == 0 and bool(got.converged[2])
    if max_iter == 30:
        assert bool(got.converged.all())
        np.testing.assert_allclose(got.x.numpy(), r, rtol=1e-10)
    else:
        assert not bool(got.converged[[0, 1, 3, 4]].any())


def test_root_batched_frozen_members_keep_their_state():
    """A member that converged keeps its state bit for bit however many
    iterations the batch runs on: the run at max_iter k + 5 equals the
    run at k for every member converged at k."""
    p, C, r = _system(8, seed=2)
    f_t = _residual(*(torch.as_tensor(a) for a in (p, C, r)))
    x0 = torch.zeros((8, N), dtype=torch.float64)
    x0[:, 0] = torch.linspace(-4.0, 4.0, 8)
    full = t_newton.root_batched(f_t, x0, max_iter=30)
    k = int(full.iterations.min())
    short = t_newton.root_batched(f_t, x0, max_iter=k)
    longer = t_newton.root_batched(f_t, x0, max_iter=k + 5)
    done = short.converged
    assert bool(done.any()) and not bool(done.all())
    assert torch.equal(longer.x[done], short.x[done])
    assert torch.equal(longer.iterations[done], short.iterations[done])
    assert torch.equal(longer.residual_norm[done], short.residual_norm[done])


def test_root_batched_takes_a_jacobian_and_refuses_block_modes():
    """jac= replaces the default reverse-mode Jacobian (the same roots);
    the default equals the analytic Jacobian to 1e-12; a block= layout
    that does not tile the state is refused (the block modes themselves
    are held in tests/test_torch_hetero_dyn_linalg.py)."""
    p, C, r = _system(3, seed=3)
    pt, Ct, rt = (torch.as_tensor(a) for a in (p, C, r))
    f_t = _residual(pt, Ct, rt)
    x0 = torch.zeros((3, N), dtype=torch.float64)

    def jac(x):
        return torch.diag_embed(3 * x ** 2 + pt) + Ct.T

    a = t_newton.root_batched(f_t, x0, jac=jac)
    b = t_newton.root_batched(f_t, x0)
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=1e-12)
    xs = torch.as_tensor(np.random.default_rng(4).standard_normal((3, N)))
    np.testing.assert_allclose(t_newton._dense_jacobian(f_t)(xs).numpy(),
                               jac(xs).numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="does not tile"):
        t_newton.root_batched(f_t, x0, block=(N + 1, 1))
