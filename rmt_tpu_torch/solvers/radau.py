# Stiff implicit integrator: Radau IIA collocation (order 2s-1, default
# s = 3, the classic Radau5) with a modified-Newton inner solve on the
# dense AD Jacobian (port of rmt_tpu/solvers/radau.py).
#
# The reference integrates one member under lax.scan / lax.while_loop and
# maps members with jax.vmap. torch.func.vmap cannot map a data-dependent
# loop, so odeint_batched integrates B members in one loop over a leading
# member axis with per-member masks that reproduce vmap of the
# reference's loops: a member's carry (t, y, f, h, error history, stats,
# predictor state, step count) changes only while its own loop condition
# holds, and inside an attempt its Newton state (K, iteration count,
# increment norm) only while its own Newton condition holds. So a
# member's result depends on that member alone. All members walk the
# output segments together, as vmap of scan does; a segment ends when no
# member is active, which costs one read of a flag by the host per
# attempt and one per Newton sweep. odeint is the single-member call, a
# B = 1 call of odeint_batched.
#
# The Jacobian is the dense one by reverse-mode AD (reverse_jacobian), the
# reference's jax.jacfwd up to rounding. The Newton matrix I - h (A (x) J)
# is built by broadcasting into
# (B, s, n, s, n) and factored once per attempt by torch.linalg.lu_factor
# in the working dtype (the reference's non-TPU branch: no mixed-precision
# refinement, float64 is native on the card).

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 8.0
_NEWTON_ITERS = 8
_NEWTON_TOL = 0.03  # in units of the local error tolerance


def extrap_weights(c_np, r, c=None):
    """Collocation-extrapolation weights for the Radau stage predictor.

    W[..., i, j] = l_j(1 + c_i * r), the Lagrange basis over the node set
    {0, c_1..c_s} evaluated at the NEXT step's stage abscissae expressed in
    the previous step's local coordinate (r = h_new / h_prev). The
    previous stage offsets vanish at node 0, so that basis column is
    dropped. r may be batched: output shape r.shape + (s, s). c: the
    nodes c_np as a tensor of r's dtype on r's device, where the caller
    keeps one (it saves a copy to the device a call).
    """
    xs = [0.0] + [float(x) for x in c_np]
    s = len(c_np)
    r = torch.as_tensor(r)
    if c is None:
        c = torch.as_tensor(np.asarray(c_np), dtype=r.dtype, device=r.device)
    sv = 1.0 + c * r[..., None]                            # (..., s)
    cols = []
    for j in range(1, s + 1):
        num = torch.ones_like(sv)
        den = 1.0
        for m in range(s + 1):
            if m == j:
                continue
            num = num * (sv - xs[m])
            den = den * (xs[j] - xs[m])
        cols.append(num / den)
    return torch.stack(cols, dim=-1)                       # (..., s, s)


def radau_tableau(s: int = 3):
    """Radau IIA nodes/weights on [0,1], derived numerically (numpy f64).

    Right-Radau nodes (c_s = 1) are 1 - reversed(left-Radau nodes), where
    the left-Radau nodes are the roots of P_{s-1}(2x-1) + P_s(2x-1).
    A is the collocation integral of the Lagrange basis; b = A[-1]. bhat
    is the order-(s+1) quadrature over nodes {0, c_1..c_s} with the
    explicit node's weight pinned to the real eigenvalue of A (the
    embedded error estimate of Hairer-Wanner's Radau5).
    """
    from numpy.polynomial import legendre as L

    coef = np.zeros(s + 1)
    coef[s - 1] = 1.0
    coef[s] = 1.0
    u_roots = L.legroots(coef)           # roots of P_{s-1}+P_s in u=2x-1
    x_left = np.sort((u_roots + 1) / 2)  # left-Radau nodes, includes 0
    c = np.sort(1.0 - x_left)            # right-Radau nodes, includes 1

    V = np.vander(c, increasing=True)    # V[i,k] = c_i^k
    Vinv = np.linalg.inv(V)
    powers = np.arange(1, s + 1)
    Cmat = (c[:, None] ** powers) / powers  # int_0^{c_i} x^k dx
    A = Cmat @ Vinv
    b = A[-1].copy()

    eig = np.linalg.eigvals(A)
    gamma0 = float(eig[np.abs(eig.imag) < 1e-12].real[0])
    M = c[None, :] ** np.arange(s)[:, None]          # (s, s): c_j^k
    rhs = 1.0 / np.arange(1, s + 1)
    rhs[0] -= gamma0                                  # k=0 row: 0^0 = 1
    bhat_tail = np.linalg.solve(M, rhs)
    bhat = np.concatenate([[gamma0], bhat_tail])     # bhat[0] * f(t0, y0)
    return c, A, b, bhat


def reverse_jacobian(f, t, y):
    """Dense Jacobian (..., n, n) of a batched f(t, y (..., n)) at y by
    reverse-mode AD: one vector-Jacobian product a output entry, the n
    unit cotangents mapped in one call; every row of the leading axes
    must depend on its own input row alone. The same matrix as the
    forward mode of stiff_ensemble.batched_jacobian (jax.jacfwd in the
    reference) up to rounding, at about a fifth of the host time: in
    eager PyTorch every forward-mode operation that mixes a dual tensor
    with a parameter (no tangent) builds a zero tangent whose shape is
    computed by Python meta functions."""
    n = y.shape[-1]
    _, pull = torch.func.vjp(lambda yy: f(t, yy), y)
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    rows = torch.func.vmap(lambda e: pull(e.expand(y.shape))[0])(eye)
    return torch.movedim(rows, 0, -2)                       # (..., out, in)


class RadauStats(NamedTuple):
    n_fev: torch.Tensor
    n_jev: torch.Tensor
    n_lu: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    n_unreached: torch.Tensor  # output times NOT reached within max_steps;
                               # the run only succeeded if this is 0


def _norm(v, scale):
    """RMS of v / scale over the last axis."""
    return torch.sqrt(torch.mean((v / scale) ** 2, dim=-1))


def _mix(M, X):
    """(B, s_out, n) rows out[:, i] = sum_j M[i, j] X[:, j] for an
    (s_out, s) matrix M and X (B, s, n), as elementwise products summed
    over j: each member's bits do not depend on B."""
    return torch.sum(M[None, :, :, None] * X[:, None, :, :], dim=2)


class _Clock:
    """Seconds spent in named parts of the integrator, added to a
    caller's dict; the device is synchronised at every boundary, so each
    part's device work is charged to it (instrumentation: it serialises
    host and device)."""

    def __init__(self, out, dev):
        self.out, self.dev = out, dev
        self.t0 = time.perf_counter()

    def lap(self, key):
        if self.out is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.out[key] = self.out.get(key, 0.0) + now - self.t0
        self.t0 = now


def odeint_batched(f, y0, ts, rtol=1e-7, atol=1e-10, max_steps: int = 10_000,
                   s: int = 3, jac=None, f_stages=None, timings=None):
    """Integrate B stiff ODEs dy/dt = f(t, y) at once, each member as
    rmt_tpu's radau.odeint integrates it alone (jax.vmap of it).

    f is batched: f(t (B,), y (B, n)) -> (B, n). y0 (B, n); ts (B, T) or
    (T,), increasing per member; ys[:, 0] == y0. jac(t (B,), y (B, n)) ->
    (B, n, n) overrides the dense AD Jacobian (reverse_jacobian).
    f_stages(ts (B, s), Y (B, s, n)) -> (B, s, n) optionally evaluates
    all stages in one call (default: one call of f a stage). timings:
    an optional dict to which the seconds of the Jacobian ("jacobian"),
    the LU factorisations ("lu"), the Newton sweeps ("newton") and the
    rest ("other") are added (see _Clock).

    Returns (ys (B, T, n), RadauStats of (B,) int32 tensors).
    """
    y0 = torch.as_tensor(y0)
    dtype, dev = y0.dtype, y0.device
    Bsz, n = y0.shape
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    if ts.dim() == 1:
        ts = ts.expand(Bsz, -1)
    sn = s * n
    order_exp = -1.0 / (s + 1)
    clock = _Clock(timings, dev)

    c_np, A_np, b_np, bhat_np = radau_tableau(s)

    def cst(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    C, A, Ainv = cst(c_np), cst(A_np), cst(np.linalg.inv(A_np))
    b_row, err_w = cst(b_np[None]), cst((b_np - bhat_np[1:])[None])
    bhat0 = float(bhat_np[0])
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    sqrt_s = float(np.sqrt(float(s)))

    if jac is None:
        def jac(t, y):
            return reverse_jacobian(f, t, y)

    def stages(t, h, Y):
        ts_st = t[:, None] + C[None, :] * h[:, None]        # (B, s)
        if f_stages is not None:
            return f_stages(ts_st, Y)
        return torch.stack([f(ts_st[:, i], Y[:, i]) for i in range(s)],
                           dim=1)

    def predict_K(Kp, hp, h_new):
        """Newton starting guess from the previous accepted step's
        collocation polynomial (extrap_weights); the constant guess in
        the h_new / hp -> 0 limit (A 1 = c)."""
        r = torch.clamp(h_new / torch.clamp(hp, min=1e-300), 0.0, 4.0)
        W = extrap_weights(c_np, r, C)                     # (B, s, s)
        Z = hp[:, None, None] * _mix(A, Kp)                # (B, s, n)
        Zg = torch.sum(W[..., None] * Z[:, None], dim=2) - Z[:, -1:]
        Kg = _mix(Ainv, Zg) / h_new[:, None, None]
        return torch.where(torch.isfinite(Kg), Kg, torch.zeros_like(Kg))

    def newton_matrix(h, J):
        """I - h (A (x) J) as (B, sn, sn), built in place by
        broadcasting: entry (i n + k, j n + l) is A[i, j] J[k, l]."""
        M = A[None, :, None, :, None] * J[:, None, :, None, :]
        M = M.reshape(Bsz, sn, sn)
        M.mul_(h[:, None, None]).neg_()
        M.diagonal(dim1=-2, dim2=-1).add_(1.0)
        return M

    def attempt(active, t, y, h, f0, J, K0):
        """One Radau step of size h from (t, y) for every member (the
        Newton sweeps masked to active members). Returns (y1, err_norm,
        Newton iterations, K)."""
        # no error check (a host sync): a singular matrix gives a
        # non-finite step, which the error test rejects
        LU, piv, _ = torch.linalg.lu_factor_ex(newton_matrix(h, J))
        clock.lap("lu")
        scale = (atol + rtol * torch.abs(y))[:, None, :] * sqrt_s
        K = K0
        iters = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        hh = h[:, None, None]
        for it in range(_NEWTON_ITERS):
            go = active & ~done
            # the first sweep runs: the caller found a member active
            if it and not bool(go.any()):
                break
            Y = y[:, None, :] + hh * _mix(A, K)
            R = K - stages(t, h, Y)
            dK = torch.linalg.lu_solve(
                LU, piv, (-R).reshape(Bsz, sn, 1)).reshape(Bsz, s, n)
            dn = _norm((dK / scale).reshape(Bsz, sn), 1.0)
            dn = torch.where(torch.isfinite(dn), dn,
                             torch.full_like(dn, float("inf")))
            g3 = go[:, None, None]
            K = torch.where(g3, K + dK, K)
            iters = torch.where(go, iters + 1, iters)
            done = torch.where(go, dn < _NEWTON_TOL, done)
        clock.lap("newton")
        y1 = y + h[:, None] * _mix(b_row, K)[:, 0]
        # embedded error estimate, smoothed through (I - h*bhat0*J)
        err_raw = h[:, None] * (_mix(err_w, K)[:, 0] - bhat0 * f0)
        M1 = eye_n - (h * bhat0)[:, None, None] * J
        LU1, piv1, _ = torch.linalg.lu_factor_ex(M1)
        clock.lap("lu")
        err = torch.linalg.lu_solve(LU1, piv1, err_raw[..., None])[..., 0]
        scale2 = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        err_norm = _norm(err, scale2)
        inf = torch.full_like(err_norm, float("inf"))
        err_norm = torch.where(torch.isfinite(err_norm), err_norm, inf)
        err_norm = torch.where(done, err_norm, inf)
        return y1, err_norm, iters * s, K

    def segment(carry, t_end):
        t, y, fval, h, err_prev, stats, Kp, hp, pv = carry
        steps = torch.zeros(Bsz, dtype=torch.int32, device=dev)
        while True:
            active = (t < t_end) & (steps < max_steps)
            if not bool(active.any()):
                break
            h_eff = torch.minimum(h, t_end - t)
            clock.lap("other")
            J = jac(t, y)
            clock.lap("jacobian")
            K0 = torch.where(pv[:, None, None], predict_K(Kp, hp, h_eff),
                             fval[:, None, :].expand(Bsz, s, n))
            y1, err_norm, nfe, K = attempt(active, t, y, h_eff, fval, J, K0)
            accept = err_norm <= 1.0

            # clamp before the pow (an inf**-x would poison h forever);
            # the Gustafsson predictive (PI) controller, the I-controller
            # until a first error history exists
            err_c = torch.clamp(err_norm, 1e-10, 1e10)
            fac_i = _SAFETY * err_c ** order_exp
            ep = torch.clamp(err_prev, 1e-10, 1e10)
            fac_pi = (_SAFETY * err_c ** (0.6 * order_exp)
                      * ep ** (-0.25 * order_exp))
            factor = torch.where(err_prev > 0,
                                 torch.minimum(fac_i, fac_pi), fac_i)
            factor = torch.where(
                err_norm == 0.0, torch.full_like(factor, _MAX_FACTOR),
                torch.clamp(factor, _MIN_FACTOR, _MAX_FACTOR))
            factor = torch.where(accept, factor,
                                 torch.clamp(factor, max=1.0))
            clamped = h_eff < h
            h_next = torch.where(accept & clamped,
                                 torch.maximum(h, h_eff * factor),
                                 h_eff * factor)

            # a member's carry moves only while its own loop runs, and
            # its state only on an accepted step
            upd = active & accept
            t = torch.where(upd, t + h_eff, t)
            f_new = f(t, y1)
            y = torch.where(upd[:, None], y1, y)
            fval = torch.where(upd[:, None], f_new, fval)
            h = torch.where(active, h_next, h)
            err_prev = torch.where(upd, err_c, err_prev)
            Kp = torch.where(upd[:, None, None], K, Kp)
            hp = torch.where(upd, h_eff, hp)
            pv = pv | upd
            one = active.to(torch.int32)
            acc = upd.to(torch.int32)
            stats = RadauStats(
                stats.n_fev + one * (nfe + 1), stats.n_jev + one,
                stats.n_lu + one, stats.n_accepted + acc,
                stats.n_rejected + (one - acc), stats.n_unreached)
            steps = steps + one
        # a segment that exhausted max_steps leaves t short of t_end and
        # its output row holds a state at the wrong time: a failure
        eps_t = 8 * torch.finfo(dtype).eps * torch.clamp(
            torch.abs(t_end), min=1.0)
        unreached = (t < t_end - eps_t).to(torch.int32)
        stats = stats._replace(n_unreached=stats.n_unreached + unreached)
        return (t, y, fval, h, err_prev, stats, Kp, hp, pv), y

    t0 = ts[:, 0]
    f0 = f(t0, y0)
    span = ts[:, -1] - t0
    h0 = torch.minimum(1e-3 * span, 1e-4 * torch.clamp(span, min=1.0))
    zero = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    carry = (t0, y0, f0, h0, torch.zeros(Bsz, dtype=dtype, device=dev),
             RadauStats(zero + 1, zero, zero, zero, zero, zero),
             f0[:, None, :].expand(Bsz, s, n).clone(),
             torch.ones(Bsz, dtype=dtype, device=dev),
             torch.zeros(Bsz, dtype=torch.bool, device=dev))
    ys = [y0]
    for k in range(1, ts.shape[1]):
        carry, y = segment(carry, ts[:, k])
        ys.append(y)
    clock.lap("other")
    return torch.stack(ys, dim=1), carry[5]


def odeint(f, y0, ts, rtol=1e-7, atol=1e-10, max_steps: int = 10_000,
           s: int = 3, args=None, jac=None):
    """Integrate the stiff ODE dy/dt = f(t, y, *args) for one member (the
    signature of rmt_tpu's radau.odeint); returns (ys (T, n), RadauStats
    of 0-d tensors). ts must be increasing; ys[0] == y0. jac(t, y) -> (n,
    n) optionally overrides the dense AD Jacobian. The stages
    are evaluated in one call of f mapped over them (torch.func.vmap, as
    the reference maps them with jax.vmap)."""
    args = () if args is None else tuple(args)
    y0 = torch.as_tensor(y0)

    def f1(t, y):
        return f(t, y, *args)

    def fb(t, y):
        return f1(t[0], y[0])[None]

    def f_stages(t_st, Y):
        return torch.func.vmap(f1)(t_st[0], Y[0])[None]

    jb = None if jac is None else (lambda t, y: jac(t[0], y[0])[None])
    ys, stats = odeint_batched(fb, y0[None], torch.as_tensor(ts)[None],
                               rtol, atol, max_steps, s, jb, f_stages)
    return ys[0], RadauStats(*(v[0] for v in stats))
