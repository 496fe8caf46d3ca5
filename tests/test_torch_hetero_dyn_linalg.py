# What the port's dynamic heterogeneous models run on, against rmt_tpu on
# the CPU: the colorings of ops/jacobian.py, the block solves of
# ops/block_solve.py, the block modes of newton.root_batched, the
# tridiagonal block mode of the lockstep integrator, and the two-phase
# colored Jacobians of M10-M12 (the models themselves:
# tests/test_torch_hetero_dyn.py). Tolerances: equal arrays for the
# colorings and the block extraction; 1e-12 for the block solves in
# float64 against the dense solve, and the float32 shifted solvers at the
# float32 bar 1e-4 against float64; root_batched's block modes equal the
# dense mode's roots to 1e-10; the colored Jacobians 1e-12 against the
# dense one and 1e-10 relative against rmt_tpu's.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmt_tpu.ops import block_solve as j_bs
from rmt_tpu.ops import jacobian as j_jac
from rmt_tpu.solvers import newton as j_newton
from rmt_tpu.solvers import stiff_ensemble as j_se
from rmt_tpu_torch.ops import block_solve as t_bs
from rmt_tpu_torch.ops import jacobian as t_jac
from rmt_tpu_torch.solvers import newton as t_newton
from rmt_tpu_torch.solvers import stiff_ensemble as t_se
from rmt_tpu_torch.solvers.radau import reverse_jacobian
from test_torch_hetero_dyn import _close, _dyn_rhs, _dyn_state, _setup


@pytest.mark.parametrize("kind, args", [
    ("tridiag", (7, 10)), ("tridiag", (3, 4)), ("tridiag", (7, 7)),
    ("two_phase", (7, 8, 10)), ("two_phase", (7, 5, 4)),
    ("two_phase", (2, 3, 7))])
def test_colorings_equal_jax(kind, args):
    name = f"{kind}_coloring"
    for g, w in zip(getattr(t_jac, name)(*args), getattr(j_jac, name)(*args)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# block solves
# ---------------------------------------------------------------------------

def _tridiag_system(rng, B, z, m):
    """Random diagonally dominant block-tridiagonal blocks (B, z, m, m)."""
    D = rng.standard_normal((B, z, m, m)) + 4.0 * m * np.eye(m)
    L = rng.standard_normal((B, z, m, m))
    U = rng.standard_normal((B, z, m, m))
    L[:, 0] = 0.0
    U[:, -1] = 0.0
    return D, L, U


def _solve(A, b):
    return np.linalg.solve(A, b[..., None])[..., 0]


def _dense_of(D, L, U):
    """The dense (B, n, n) matrix, flat index v*z + node, of the blocks."""
    B, z, m, _ = D.shape
    J = np.zeros((B, m, z, m, z))
    for k in range(z):
        J[:, :, k, :, k] = D[:, k]
        if k:
            J[:, :, k, :, k - 1] = L[:, k]
        if k < z - 1:
            J[:, :, k, :, k + 1] = U[:, k]
    return J.reshape(B, m * z, m * z)


@pytest.mark.parametrize("B, z, m", [(2, 10, 7), (3, 5, 4), (1, 7, 7),
                                     (2, 16, 3)])
def test_extract_tridiag_blocks_matches_jax(B, z, m):
    J = np.random.default_rng(B * z * m).standard_normal((B, m * z, m * z))
    got = t_bs.extract_tridiag_blocks(torch.as_tensor(J), m, z)
    want = j_bs.extract_tridiag_blocks(jnp.asarray(J), m, z)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, z, m, m)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("B, z, m", [(2, 10, 7), (3, 5, 4), (2, 16, 3),
                                     (1, 1, 2)])
def test_tridiag_factor_solve_matches_dense_and_jax(B, z, m):
    """Cyclic reduction (z a power of two or padded) against the dense
    float64 solve at 1e-12, and against rmt_tpu's at 1e-12."""
    rng = np.random.default_rng(11 + z)
    D, L, U = _tridiag_system(rng, B, z, m)
    r = rng.standard_normal((B, z, m))
    x = t_bs.tridiag_solve(t_bs.tridiag_factor(
        *(torch.as_tensor(a) for a in (D, L, U))), torch.as_tensor(r))
    dense = _solve(_dense_of(D, L, U), r.transpose(0, 2, 1).reshape(B, -1))
    _close(x.transpose(1, 2).reshape(B, -1), dense, 1e-12)
    xj = j_bs.tridiag_solve(j_bs.tridiag_factor(
        *(jnp.asarray(a) for a in (D, L, U))), jnp.asarray(r))
    _close(x, xj, 1e-12)


def test_batched_inv_and_solve_bidiag_match_jax():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((6, 5, 5)) + 5 * np.eye(5)
    _close(t_bs.batched_inv(torch.as_tensor(M)),
           j_bs.batched_inv(jnp.asarray(M)), 1e-12)
    Minv = rng.standard_normal((2, 6, 4, 4))
    C = 0.3 * rng.standard_normal((2, 6, 4, 4))
    C[:, 0] = 0.0
    r = rng.standard_normal((2, 6, 4))
    _close(t_bs.solve_bidiag(*(torch.as_tensor(a) for a in (Minv, C, r))),
           j_bs.solve_bidiag(*(jnp.asarray(a) for a in (Minv, C, r))),
           1e-12)


@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-4)])
def test_shifted_tridiag_solvers(dtype, rtol):
    """(I - h gamma J) x = r and (I - h mu J) x = r with the complex shift
    in its real embedding, against the dense complex solve in float64,
    and against rmt_tpu's float32 solvers (factored in ``dtype``)."""
    rng = np.random.default_rng(5)
    B, z, m = 3, 6, 4
    D, L, U = (0.5 * a for a in _tridiag_system(rng, B, z, m))
    h = np.asarray([1e-3, 0.05, 0.2])
    _, _, _, _, w, _, _ = t_se._transformed_tableau()
    gamma, mu = float(w[0].real), complex(w[1])
    rr, ri = rng.standard_normal((2, B, z, m))
    sr, sc = t_bs.make_shifted_solvers_tridiag(
        *(torch.as_tensor(a) for a in (D, L, U, h)), gamma, mu.real,
        mu.imag, dtype=dtype)
    J = _dense_of(D, L, U)
    eye = np.eye(J.shape[-1])
    flat = lambda a: np.asarray(a).transpose(0, 2, 1).reshape(B, -1)
    want_r = _solve(eye - (h * gamma)[:, None, None] * J, flat(rr))
    want_c = _solve(eye - (h * mu)[:, None, None] * J,
                    flat(rr) + 1j * flat(ri))
    xr = sr(torch.as_tensor(rr))
    xcr, xci = sc(torch.as_tensor(rr), torch.as_tensor(ri))
    assert xr.dtype == dtype
    _close(flat(xr.double()), want_r, rtol)
    _close(flat(xcr.double()), want_c.real, rtol)
    _close(flat(xci.double()), want_c.imag, rtol)
    jr, jc = j_bs.make_shifted_solvers_tridiag(
        *(jnp.asarray(a) for a in (D, L, U, h)), gamma, mu.real, mu.imag)
    _close(xr.double(), jr(jnp.asarray(rr)), 1e-4 if dtype == torch.float32
           else 1e-5)


# ---------------------------------------------------------------------------
# root_batched block modes and the tridiagonal lockstep integrator
# ---------------------------------------------------------------------------

def _block_system(m, z, tridiag, seed=0):
    """A batch of 3 nonlinear systems x**3 + A x = q whose coupling A is
    block bidiagonal (or tridiagonal) in the flat layout v*z + node."""
    rng = np.random.default_rng(seed)
    D, L, U = _tridiag_system(rng, 3, z, m)
    if not tridiag:
        U = np.zeros_like(U)
    A = _dense_of(D, L, U)
    q = rng.standard_normal((3, m * z))
    return A, q


@pytest.mark.parametrize("tridiag", [False, True])
def test_root_batched_block_modes_match_dense_and_jax(tridiag):
    """block=(m, z) and (m, z, "tridiag") reach the dense mode's roots to
    1e-10 in the same iterations, and rmt_tpu's block mode's roots."""
    m, z = 3, 5
    A, q = _block_system(m, z, tridiag)
    block = (m, z, "tridiag") if tridiag else (m, z)
    At, qt = torch.as_tensor(A), torch.as_tensor(q)
    f = lambda x: x**3 + torch.einsum("bij,bj->bi", At, x) - qt
    x0 = torch.zeros_like(qt)
    dense = t_newton.root_batched(f, x0)
    blk = t_newton.root_batched(f, x0, block=block)
    assert bool(blk.converged.all())
    _close(blk.x, dense.x.numpy())
    assert torch.equal(blk.iterations, dense.iterations)
    Aj, qj = jnp.asarray(A), jnp.asarray(q)
    fj = lambda x: x**3 + jnp.einsum("bij,bj->bi", Aj, x) - qj
    want = j_newton.root_batched(fj, jnp.zeros_like(qj), block=block)
    _close(blk.x, want.x)
    with pytest.raises(ValueError, match="tile"):
        t_newton.root_batched(f, x0, block=(m + 1, z))


def test_lockstep_tridiag_block_mode_matches_jax():
    """rmt_tpu's tests/test_ensemble.py Brusselator-with-diffusion
    ensemble (four members, tridiagonal z-coupling) in tridiagonal block
    mode: every member finishes, the states equal rmt_tpu's tridiagonal
    mode to 1e-8 (float32 stage solves in both) and the Newton-Schulz
    mode's to 5e-4 (rmt_tpu's bar between the two modes)."""
    var_no, z_no = 2, 12
    alpha, dz = 0.02, 1.0 / (z_no - 1)
    bp = np.asarray([3.0, 3.4, 2.8, 3.2])

    def lap(w, cat):
        wl = cat([w[..., 1:2], w[..., :-1]])
        wr = cat([w[..., 1:], w[..., -2:-1]])
        return (wl - 2.0 * w + wr) / dz**2

    def rhs(xp, cat, y, b):
        Y = y.reshape(y.shape[:-1] + (var_no, z_no))
        u, v = Y[..., 0, :], Y[..., 1, :]
        du = 1.0 + u * u * v - (b + 1.0) * u + alpha * lap(u, cat)
        dv = b * u - u * u * v + alpha * lap(v, cat)
        return xp.stack([du, dv], -2).reshape(y.shape)

    zs = np.linspace(0.0, 1.0, z_no)
    y0 = np.tile(np.concatenate([1.0 + 0.1 * np.sin(2 * np.pi * zs),
                                 np.full(z_no, 3.0)])[None], (4, 1))
    ts = np.asarray([0.0, 0.5, 1.0])
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=512)
    bt = torch.as_tensor(bp)[:, None]
    ys, st = t_se.odeint_ensemble(
        lambda t, y: rhs(torch, lambda xs: torch.cat(xs, dim=-1), y, bt),
        torch.as_tensor(y0), ts, block=(var_no, z_no, "tridiag"), batched=True,
        **kw)
    assert int(st.seg.min()) == len(ts) - 1
    f_single = lambda t, y, b: rhs(
        jnp, lambda xs: jnp.concatenate(xs, axis=-1), y, b)
    fB = jax.vmap(f_single)
    jB = jax.vmap(jax.jacobian(f_single, argnums=1))
    bj = jnp.asarray(bp)
    jkw = dict(jac=lambda t, y: jB(t, y, bj), batched=True, **kw)
    ys_tr, _ = j_se.odeint_ensemble(lambda t, y: fB(t, y, bj),
                                    jnp.asarray(y0), jnp.asarray(ts),
                                    block=(var_no, z_no, "tridiag"), **jkw)
    ys_ns, _ = j_se.odeint_ensemble(lambda t, y: fB(t, y, bj),
                                    jnp.asarray(y0), jnp.asarray(ts), **jkw)
    _close(ys, ys_tr, 1e-8)
    rel = np.abs(ys.numpy() - np.asarray(ys_ns)) / np.maximum(
        np.abs(np.asarray(ys_ns)), 1e-7)
    assert rel.max() < 5e-4, rel.max()


@pytest.mark.parametrize("model", ["M10", "M11", "M12"])
def test_two_phase_colored_jacobian_matches_dense(model):
    """The two-phase colored Jacobian (march frozen) by forward-mode column
    colors and by reverse-mode row colors (the one the models run) equal
    the port's dense reverse-mode Jacobian of the frozen RHS at 1e-12 and
    rmt_tpu's colored Jacobian at 1e-10 (rmt_tpu's tests/test_m11.py
    check, here for M10 and M12 too)."""
    z_no, r_no = 4, (3 if model == "M11" else 7)
    js, ts, jp, tp, jd, td = _setup(model, z_no, r_no)
    j_rhs, t_rhs = _dyn_rhs(model, js, ts, None, True)
    args_j = (jp,) if model == "M10" else (jp, jd)
    args_t = (tp,) if model == "M10" else (tp, td)
    y = torch.as_tensor(_dyn_state(js, jp, np.random.default_rng(9),
                                   real_units=model == "M10"))
    f = lambda t, yy: t_rhs(t, yy, *args_t)
    dense = reverse_jacobian(f, 0.0, y)
    cols = t_jac.colored_jacobian_from(
        f, t_jac.two_phase_coloring(js.n_layer, r_no + 1, z_no))(0.0, y)
    rows = t_jac.row_colored_jacobian_from(
        f, t_jac.two_phase_row_coloring(js.n_layer, r_no + 1, z_no))(0.0, y)
    _close(cols, dense.numpy(), 1e-12)
    _close(rows, dense.numpy(), 1e-12)
    want = j_jac.colored_jacobian_from(
        lambda t, yy: j_rhs(t, yy, *args_j),
        j_jac.two_phase_coloring(js.n_layer, r_no + 1, z_no))(
            0.0, jnp.asarray(y.numpy()))
    _close(rows, want)


@pytest.mark.parametrize("args", [(7, 8, 10), (2, 3, 7), (3, 2, 4)])
def test_row_colorings_share_no_column(args):
    """Two rows of one color never reach a common column of the sparsity
    pattern (the condition of row compression): two_phase_row_coloring's
    colors, and tridiag_coloring's on its symmetric pattern."""
    for colors, _, mask in (t_jac.two_phase_row_coloring(*args),
                            t_jac.tridiag_coloring(args[0], args[2])):
        for c in np.unique(colors):
            hits = mask[colors == c].sum(axis=0)
            assert hits.max() <= 1, (c, hits.max())
