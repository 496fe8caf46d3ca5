# Damped Newton root solvers with autodiff Jacobians (port of
# rmt_tpu/solvers/newton.py).
#
# Replaces scipy.optimize.fsolve/root/least_squares in the reference's
# steady-state models (particle T2, hetero M9/M14 ramped continuation --
# reference call sites: PyREMOT/docs/pbReactor.py:7615-7640,
# examples/particleModels.py:1554-1580, docs/pbHeterReactor.py:1032-1065).
# Armijo backtracking on the residual RMS norm. The linear solve is a
# plain one in the working dtype: float64 is native on the card, so the
# reference's float32 factorisation with a refinement pass (a TPU has no
# float64 LU) has no counterpart here.
#
# root is the reference's lax.while_loop as a host loop that reads one
# flag an iteration; root_batched keeps its fixed iteration budget with
# per-member masks, and ends early once every member has converged (one
# flag read an iteration: converged members are frozen, so the result is
# the whole budget's). Its block modes
# solve each Newton step exactly through the block structure of a member's
# Jacobian (ops/block_solve.py), in plain PyTorch as rmt_tpu solves them in
# plain XLA.

from __future__ import annotations

from typing import NamedTuple

import torch

from .radau import reverse_jacobian


class NewtonResult(NamedTuple):
    x: torch.Tensor
    residual_norm: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


def _rms(v):
    return torch.sqrt(torch.mean(v ** 2, dim=-1))


def _dense_jacobian(f):
    """jac(x (B, n)) -> (B, n, n) of a batched residual of independent
    members: reverse mode, one cotangent an output entry broadcast over
    the members (radau.reverse_jacobian). The same matrix as the
    reference's forward-mode _default_batched_jac up to rounding, at less
    host time in eager PyTorch."""
    return lambda x: reverse_jacobian(lambda t, y: f(y), None, x)


def _damped_step(f, x, fx, fn, dx, n_backtrack, damping_init):
    """The backtracking of one Newton iteration for a batch of members
    (x, fx (B, n), fn (B,), step dx): the first of n_backtrack halvings of
    the damping that lowers the RMS residual by the Armijo factor, else
    the full step. Returns (x_new, fx_new, fn_new)."""
    lam = torch.full_like(fn, float(damping_init))
    best_x, best_fx, best_fn = x, fx, fn
    found = torch.zeros_like(fn, dtype=torch.bool)
    for _ in range(n_backtrack):
        x_try = x + lam[:, None] * dx
        f_try = f(x_try)
        fn_try = _rms(f_try)
        ok = torch.isfinite(fn_try) & (fn_try < fn * (1 - 0.25 * lam)) & ~found
        best_x = torch.where(ok[:, None], x_try, best_x)
        best_fx = torch.where(ok[:, None], f_try, best_fx)
        best_fn = torch.where(ok, fn_try, best_fn)
        found = found | ok
        lam = lam * 0.5
    # if no damping works, take the full step anyway (may escape plateaus)
    x_full = x + dx
    f_full = f(x_full)
    return (torch.where(found[:, None], best_x, x_full),
            torch.where(found[:, None], best_fx, f_full),
            torch.where(found, best_fn, _rms(f_full)))


def _dense_solve(J, b):
    return torch.linalg.solve(J, b)


def _block_solve(block, n):
    """The batched solve J x = b (J (B, n, n), b (B, n)) through the
    block structure block=(m, z[, "tridiag"]): J is block bidiagonal (or
    tridiagonal) with (m x m) node blocks in the flat layout v*z + node
    (ops/jacobian.py's conventions)."""
    from ..ops import block_solve as bs

    m_b, z_b = block[0], block[1]
    tridiag = len(block) > 2 and block[2] == "tridiag"
    if m_b * z_b != n:
        raise ValueError(f"block {block} does not tile state size {n}")

    def lin_solve(J, b):
        B = b.shape[0]
        rb = b.reshape(B, m_b, z_b).transpose(1, 2)
        if tridiag:
            xb = bs.tridiag_solve(bs.tridiag_factor(
                *bs.extract_tridiag_blocks(J, m_b, z_b)), rb)
        else:
            Jd, Jl = bs.extract_bidiag_blocks(J, m_b, z_b)
            Minv = bs.batched_inv(Jd.reshape(-1, m_b, m_b)).reshape(
                B, z_b, m_b, m_b)
            xb = bs.solve_bidiag(Minv, -torch.einsum("bzij,bzjk->bzik",
                                                     Minv, Jl), rb)
        return xb.transpose(1, 2).reshape(B, n)

    return lin_solve


def _newton_step(jac, x, fx, lin_solve=_dense_solve):
    """The undamped Newton step of a batch, J dx = -f; a non-finite entry
    becomes 0."""
    dx = lin_solve(jac(x), -fx)
    return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))


def _converged(fn, x, tol):
    return fn < tol * (1 + torch.amax(torch.abs(x), dim=-1))


def root(f, x0, args=None, max_iter: int = 50, n_backtrack: int = 8,
         tol=1e-10, damping_init=1.0):
    """Solve f(x, *args) = 0 from x0 (n,) by damped Newton.

    Convergence: ||f||_2 / sqrt(n) < tol * (1 + ||x||_inf), tested after
    each iteration (not at x0, as in the reference). Returns NewtonResult
    of 0-d tensors besides x (n,).
    """
    args = () if args is None else tuple(args)
    x = torch.as_tensor(x0)[None]

    def fb(xb):
        return f(xb[0], *args)[None]

    jac = _dense_jacobian(fb)
    fx = fb(x)
    fn = _rms(fx)
    it = 0
    done = torch.zeros(1, dtype=torch.bool, device=x.device)
    while it < max_iter:
        dx = _newton_step(jac, x, fx)
        x, fx, fn = _damped_step(fb, x, fx, fn, dx, n_backtrack,
                                 damping_init)
        it += 1
        done = _converged(fn, x, tol)
        if bool(done):
            break
    return NewtonResult(x[0], fn[0],
                        torch.tensor(it, dtype=torch.int32, device=x.device),
                        done[0])


def root_batched(f, x0, max_iter: int = 30, n_backtrack: int = 6,
                 jac=None, tol=1e-10, damping_init=1.0, block=None,
                 like_root: bool = False):
    """Damped Newton on a BATCH of independent systems, lockstep.

    A fixed budget of max_iter iterations with per-member masking: a
    member that has converged keeps its state (its residual is not
    re-evaluated into it) and its iteration count, so the loop ends
    once every member has converged with the whole budget's result (one
    flag read by the host an iteration).

    like_root=True gives every member what root gives it alone (jax.vmap
    of rmt_tpu's root): convergence is tested after each iteration, not
    at x0.

    f: batched residual f(x (B, n)) -> (B, n) (close per-member
    parameters over it); members must be independent.
    jac: optional batched Jacobian jac(x) -> (B, n, n); default the dense
    one by reverse mode (exact, since members are independent).
    block=(m, z[, "tridiag"]): a member's Jacobian is block bidiagonal
    (tridiagonal) with (m x m) node blocks in the flat layout v*z + node
    (ops/jacobian.py's conventions); Newton steps then solve exactly
    through that structure (ops/block_solve.py). None: the dense solve.

    Convergence per member: ||f||_rms < tol * (1 + ||x||_inf), also at
    x0 unless like_root. Returns NewtonResult of batched fields ((B, n), (B,), (B,) int32,
    (B,) bool).
    """
    x = torch.as_tensor(x0)
    lin_solve = (_dense_solve if block is None
                 else _block_solve(block, x.shape[-1]))
    if jac is None:
        jac = _dense_jacobian(f)
    fx = f(x)
    fn = _rms(fx)
    done = (torch.zeros_like(fn, dtype=torch.bool) if like_root
            else _converged(fn, x, tol))
    it = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        dx = _newton_step(jac, x, fx, lin_solve)
        x_new, fx_new, fn_new = _damped_step(f, x, fx, fn, dx, n_backtrack,
                                             damping_init)
        conv = _converged(fn_new, x_new, tol)
        # frozen members keep their state
        x = torch.where(done[:, None], x, x_new)
        fx = torch.where(done[:, None], fx, fx_new)
        fn = torch.where(done, fn, fn_new)
        it = torch.where(done, it, it + 1)
        done = done | conv
    return NewtonResult(x, fn, it, done)
