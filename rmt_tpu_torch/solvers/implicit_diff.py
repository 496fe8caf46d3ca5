# Reverse-differentiable implicit integration: fixed-step Radau IIA whose
# stage solves carry an implicit-function-theorem adjoint (port of
# rmt_tpu/solvers/implicit_diff.py).
#
# The adaptive solvers (radau.odeint_batched, the lockstep ensemble) run
# data-dependent loops and are not meant to be differentiated. Here each
# Radau step solves the stage system g(K) = K - F(y0 + h A K) = 0 with a
# damped Newton iteration inside a torch.autograd.Function: its forward
# runs the iterations with no autograd graph, its backward solves
# (dg/dK)^T w = Kbar once at the converged K and pulls -w back through
# one vector-Jacobian product of g -- the IFT adjoint, so the backward
# sweep costs one Jacobian, one LU and one VJP a step whatever the
# Newton iteration count, and the whole loop of steps differentiates
# exactly.
#
# The reference's jax.vmap of radau_fixed is radau_fixed_batched: one
# loop over a leading member axis, every member with its own step sizes,
# Jacobian, LU and damping choices. The iteration counts are fixed, so no
# member waits on another and nothing is read back to the host. dg/dK is
# assembled from the n x n Jacobians of the s stages (block (i, j) is
# delta_ij I - h A_ij J_i), a third of the cotangents of the reference's
# jacfwd of the whole residual; the three damping trials of an iteration
# are evaluated in one call.
#
# Every tensor the residual depends on is an explicit input of the
# Function (the flattened leaves of args): a tensor that f captured
# instead would get no gradient, silently.
#
# No reference counterpart (the reference has no sensitivity machinery at
# all); this backs BASELINE config #5 at realistic stiffness.

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.utils import _pytree as pytree

from .radau import _Clock, radau_tableau, reverse_jacobian

_NEWTON_ITERS = 8
_MAX_ROUNDS = 4
_TRIALS = (1.0, 0.5, 0.125)


def _amix(A, K):
    """(..., s, n) rows out[..., i, :] = sum_j A[i, j] K[..., j, :], as
    elementwise products summed over j (a member's bits do not depend on
    the batch)."""
    return torch.sum(A[:, :, None] * K[..., None, :, :], dim=-2)


class _Stages:
    """The static side of one integration: the batched f(t (B, k), Y (B,
    k, n), args) -> (B, k, n), the tableau, how args is rebuilt from its
    leaves, and the clock of the forward's split (the backward keeps no
    split)."""

    def __init__(self, f, s, dtype, device, treedef, clock):
        c, A, _, _ = radau_tableau(s)
        self.f, self.treedef, self.clock = f, treedef, clock
        self.A = torch.as_tensor(A, dtype=dtype, device=device)
        self.C = torch.as_tensor(c, dtype=dtype, device=device)

    def args(self, leaves):
        return pytree.tree_unflatten(list(leaves), self.treedef)

    def stage_points(self, K, y0, t, h):
        """(t (B, m*s), Y (B, m*s, n)) of K (B, m, s, n)."""
        B, m, s, n = K.shape
        Y = y0[:, None, None, :] + h[:, None, None, None] * _amix(self.A, K)
        ts = (t[:, None] + self.C[None, :] * h[:, None])[:, None, :]
        return ts.expand(B, m, s).reshape(B, m * s), Y.reshape(B, m * s, n)

    def resid(self, K, y0, t, h, args):
        """g(K) = K - F(y0 + h A K) for K (B, m, s, n)."""
        ts, Y = self.stage_points(K, y0, t, h)
        return K - self.f(ts, Y, args).reshape(K.shape)

    def matrix(self, K, y0, t, h, args):
        """dg/dK (B, s n, s n) at K (B, s, n): block (i, j) is delta_ij I
        - h A_ij J_i, with J_i the Jacobian of f at stage i."""
        B, s, n = K.shape
        ts, Y = self.stage_points(K[:, None], y0, t, h)
        J = reverse_jacobian(lambda tt, yy: self.f(tt, yy, args), ts, Y)
        M = (h[:, None, None, None, None] * self.A[None, :, None, :, None]
             * J[:, :, :, None, :]).reshape(B, s * n, s * n)
        M.neg_().diagonal(dim1=-2, dim2=-1).add_(1.0)
        return M


def _solve(st, K, y0, t, h, args):
    """Rounds of [factor dg/dK at the current K -> damped iterations]
    from the guess K (B, s, n): the cold constant-stage guess can sit far
    outside the Newton basin on violent transients, where a frozen
    Jacobian stalls. An iteration takes the Newton step dK scaled by the
    first of 1, 1/2, 1/8 whose residual norm is at most the current one
    (else 1/8), per member."""
    B, s, n = K.shape
    clock = st.clock
    alphas = torch.as_tensor(_TRIALS, dtype=K.dtype, device=K.device)
    rows = torch.arange(B, device=K.device)
    R = st.resid(K[:, None], y0, t, h, args)[:, 0]
    clock.lap("residual")
    for _ in range(_MAX_ROUNDS):
        M = st.matrix(K, y0, t, h, args)
        clock.lap("jacobian")
        LU, piv, _ = torch.linalg.lu_factor_ex(M)
        clock.lap("lu")
        for _ in range(_NEWTON_ITERS):
            rn = torch.linalg.vector_norm(R.reshape(B, s * n), dim=-1)
            dK = -torch.linalg.lu_solve(LU, piv, R.reshape(B, s * n, 1))
            clock.lap("lu")
            Kt = K[:, None] + alphas[None, :, None, None] * dK.reshape(
                B, 1, s, n)
            Rt = st.resid(Kt, y0, t, h, args)                # (B, 3, s, n)
            nt = torch.linalg.vector_norm(Rt.reshape(B, 3, s * n), dim=-1)
            nt = torch.where(torch.isfinite(nt), nt,
                             torch.full_like(nt, float("inf")))
            ok = nt[:, :2] <= rn[:, None]
            pick = torch.where(ok[:, 0], 0, torch.where(ok[:, 1], 1, 2))
            # the chosen trial's residual is the next iteration's
            K, R = Kt[rows, pick], Rt[rows, pick]
            clock.lap("residual")
    return K


class _StageSolve(torch.autograd.Function):
    """K (B, s, n) solving g(K) = 0, differentiable in y0, t, h and the
    tensor leaves of args through the IFT; no gradient flows to the
    guess K0 (the reference returns zeros for it)."""

    @staticmethod
    def forward(ctx, st, K0, y0, t, h, *leaves):
        K = _solve(st, K0, y0, t, h, st.args(leaves))
        ctx.st = st
        ctx.tensor_at = [i for i, v in enumerate(leaves)
                         if isinstance(v, torch.Tensor)]
        ctx.leaves = [None if isinstance(v, torch.Tensor) else v
                      for v in leaves]
        ctx.save_for_backward(K, y0, t, h,
                              *(leaves[i] for i in ctx.tensor_at))
        return K

    @staticmethod
    @once_differentiable
    def backward(ctx, Kbar):
        st = ctx.st
        K, y0, t, h, *tensors = ctx.saved_tensors
        leaves = list(ctx.leaves)
        for i, v in zip(ctx.tensor_at, tensors):
            leaves[i] = v
        B, s, n = K.shape
        # adjoint linear solve (dg/dK)^T w = Kbar at the CONVERGED K
        LU, piv, _ = torch.linalg.lu_factor_ex(
            st.matrix(K, y0, t, h, st.args(leaves)))
        w = torch.linalg.lu_solve(LU, piv, Kbar.reshape(B, s * n, 1),
                                  adjoint=True).reshape(B, 1, s, n)
        # one VJP of g in the inputs that want a gradient; base[j] is
        # input j + 2 of forward (st, K0, y0, t, h, *leaves)
        base = [y0, t, h, *leaves]
        want = [j for j in range(len(base)) if ctx.needs_input_grad[j + 2]]

        def g(*prims):
            vals = list(base)
            for j, v in zip(want, prims):
                vals[j] = v
            return st.resid(K[:, None], vals[0], vals[1], vals[2],
                            st.args(vals[3:]))

        grads = [None] * len(base)
        if want:
            _, pull = torch.func.vjp(g, *(base[j] for j in want))
            for j, gj in zip(want, pull(-w)):
                grads[j] = gj
        return (None, None, *grads)


def radau_fixed_batched(f, y0, t_span, n_steps: int, args=None, s: int = 3,
                        timings=None):
    """Fixed-step Radau IIA(2s-1) of B members over t_span = (t0, t1),
    reverse-mode differentiable in y0, t_span and the tensors of args via
    IFT stage solves: the member-batched counterpart of jax.vmap of the
    reference's radau_fixed.

    f(t (B, k), Y (B, k, n), args) -> (B, k, n) evaluates k rows of every
    member b at once, each row with member b's parameters (args holds the
    per-member and shared tensors; a nested torch.func.vmap of a
    one-member f makes one). y0 (B, n); t0 and t1 scalars or (B,), so the
    period may differ per member. Returns y(t1) (B, n). timings: an
    optional dict to which the forward's seconds of the Jacobians
    ("jacobian"), the LU factorisations and solves ("lu"), the residuals
    ("residual") and the rest ("other") are added (radau._Clock; it
    synchronises the card at each boundary).

    L-stable, so step count buys accuracy, not stability."""
    y0 = torch.as_tensor(y0)
    dtype, dev = y0.dtype, y0.device
    Bsz, n = y0.shape
    _, _, b_np, _ = radau_tableau(s)
    b = torch.as_tensor(b_np, dtype=dtype, device=dev)
    leaves, treedef = pytree.tree_flatten(args)
    st = _Stages(f, s, dtype, dev, treedef, _Clock(timings, dev))

    def member_time(v):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(Bsz)

    t0, t1 = member_time(t_span[0]), member_time(t_span[1])
    # geometric warm-up ramp into uniform steps: dynamic models start from
    # clean initial states whose first instants are violently fast (rates
    # at the 1e-6 seed); tiny leading steps keep the cold Newton guess
    # inside its basin, exactly as an adaptive controller would
    n_ramp = min(12, n_steps // 2)
    raw = np.ones(n_steps)
    if n_ramp > 0:
        raw[:n_ramp] = np.geomspace(1e-6, 1.0, n_ramp)
    fracs = torch.as_tensor(raw / raw.sum(), dtype=dtype, device=dev)
    hs = fracs[None, :] * (t1 - t0)[:, None]                  # (B, steps)
    t_starts = t0[:, None] + torch.cat(
        [torch.zeros_like(hs[:, :1]), torch.cumsum(hs, dim=1)[:, :-1]],
        dim=1)

    y = y0
    for k in range(n_steps):
        t, h = t_starts[:, k], hs[:, k]
        # the cold constant-stage guess; its gradient is zero by
        # construction, so it carries none
        with torch.no_grad():
            K0 = f(t[:, None], y[:, None], args).expand(Bsz, s, n)
        st.clock.lap("other")
        K = _StageSolve.apply(st, K0, y, t, h, *leaves)
        y = y + h[:, None] * torch.sum(b[:, None] * K, dim=1)
    st.clock.lap("other")
    return y


def radau_fixed(f, y0, t_span, n_steps: int, args=None, s: int = 3):
    """Fixed-step Radau IIA(2s-1) of one member over t_span = (t0, t1),
    reverse-mode differentiable in y0 and args via IFT stage solves (the
    reference's signature). f(t, y, args) -> dy/dt with args any tree of
    tensors. Returns y(t1). radau_fixed_batched at B = 1."""
    fb = torch.func.vmap(torch.func.vmap(f, in_dims=(0, 0, None)),
                         in_dims=(0, 0, None))
    return radau_fixed_batched(fb, torch.as_tensor(y0)[None], t_span,
                               n_steps, args, s)[0]
