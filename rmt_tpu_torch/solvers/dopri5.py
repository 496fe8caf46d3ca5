# Adaptive Dormand-Prince 5(4) integrator (port of
# rmt_tpu/solvers/dopri5.py).
#
# The reference integrates one member under lax.scan over the output
# times with an adaptive lax.while_loop per segment, and maps members with
# jax.vmap. Here odeint_batched runs B members in one loop with
# per-member masks that reproduce vmap of those loops: a member's carry
# changes only while its own condition holds (t < t_end, steps <
# max_steps), so its result depends on that member alone. All members
# walk the segments together, as vmap of scan does. A step costs six
# evaluations of f and no host read: the host reads the any-active flag
# once every _SYNC_EVERY steps, and the steps run past the end of a
# segment are fully masked (they change no state and no statistic).
# odeint is the single-member call, a B = 1 call of odeint_batched.

from __future__ import annotations

from typing import NamedTuple

import torch

# Dormand-Prince 5(4) tableau
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B_ERR = tuple(b - e for b, e in zip(_B, (
    5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
    187 / 2100, 1 / 40)))

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ORDER_EXP = -1.0 / 5.0
# steps between the host's reads of the any-active flag: it changes the
# work done, never the result
_SYNC_EVERY = 64


class Dopri5Stats(NamedTuple):
    n_fev: torch.Tensor          # RHS evaluations
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    n_unreached: torch.Tensor    # output times NOT reached within max_steps


def _rms(v):
    return torch.sqrt(torch.mean(v ** 2, dim=-1))


def _error_norm(err, y0, y1, rtol, atol):
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return _rms(err / scale)


def _initial_step(f, t0, y0, f0, rtol, atol):
    """Hairer/Norsett/Wanner initial step size heuristic, per member."""
    scale = atol + torch.abs(y0) * rtol
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                     torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    y1 = y0 + h0[:, None] * f0
    f1 = f(t0 + h0, y1)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dmax) ** 0.2)
    return torch.minimum(100 * h0, h1)


def _step(f, t, y, f0, h):
    """One Dopri5 step (FSAL) for every member. Returns y1, f1 (= k7),
    err_vec."""
    hh = h[:, None]
    k = [f0]
    for i in range(1, 7):
        acc = None
        for a, kj in zip(_A[i], k):
            term = a * kj
            acc = term if acc is None else acc + term
        k.append(f(t + _C[i] * h, y + hh * acc))
    # row 6 of A equals b, so k[6] = f(t + h, y1) is the FSAL evaluation
    acc = None
    for b, kj in zip(_A[6], k[:6]):
        term = b * kj
        acc = term if acc is None else acc + term
    y1 = y + hh * acc
    acc = None
    for be, kj in zip(_B_ERR, k):
        term = be * kj
        acc = term if acc is None else acc + term
    return y1, k[6], hh * acc


def odeint_batched(f, y0, ts, rtol=1e-7, atol=1e-9, max_steps: int = 100_000):
    """Integrate B ODEs dy/dt = f(t, y) at once, each member as rmt_tpu's
    dopri5.odeint integrates it alone (jax.vmap of it).

    f is batched: f(t (B,), y (B, n)) -> (B, n). y0 (B, n); ts (B, T) or
    (T,), increasing per member. Returns (ys (B, T, n), Dopri5Stats of
    (B,) int32 tensors).
    """
    y0 = torch.as_tensor(y0)
    dtype, dev = y0.dtype, y0.device
    Bsz = y0.shape[0]
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    if ts.dim() == 1:
        ts = ts.expand(Bsz, -1)
    i32 = torch.int32

    t = ts[:, 0]
    y = y0
    fval = f(t, y0)
    h = _initial_step(f, t, y0, fval, rtol, atol)
    nfev = torch.full((Bsz,), 2, dtype=i32, device=dev)
    nacc = torch.zeros(Bsz, dtype=i32, device=dev)
    nrej = torch.zeros(Bsz, dtype=i32, device=dev)
    nunr = torch.zeros(Bsz, dtype=i32, device=dev)
    ys = [y0]
    for k in range(1, ts.shape[1]):
        t_end = ts[:, k]
        steps = torch.zeros(Bsz, dtype=i32, device=dev)
        while bool(((t < t_end) & (steps < max_steps)).any()):
            for _ in range(_SYNC_EVERY):
                active = (t < t_end) & (steps < max_steps)
                h_eff = torch.minimum(h, t_end - t)
                y1, f1, err = _step(f, t, y, fval, h_eff)
                err_norm = _error_norm(err, y, y1, rtol, atol)
                # NaN/Inf in the step (an over-long step driving the
                # state out of the RHS's domain) is a maximal error
                err_norm = torch.where(torch.isfinite(err_norm), err_norm,
                                       torch.full_like(err_norm,
                                                       float("inf")))
                accept = err_norm <= 1.0

                # clamp before the pow: an inf**-x would poison h forever
                err_c = torch.clamp(err_norm, 1e-10, 1e10)
                factor = torch.where(
                    err_norm == 0.0, torch.full_like(err_c, _MAX_FACTOR),
                    torch.clamp(_SAFETY * err_c ** _ORDER_EXP, _MIN_FACTOR,
                                _MAX_FACTOR))
                factor = torch.where(accept, factor,
                                     torch.clamp(factor, max=1.0))
                # clamping a step to the output boundary does not shrink
                # the controller's step size on an accepted step
                clamped = h_eff < h
                h_next = torch.where(accept & clamped,
                                     torch.maximum(h, h_eff * factor),
                                     h_eff * factor)
                upd = active & accept
                t = torch.where(upd, t + h_eff, t)
                y = torch.where(upd[:, None], y1, y)
                fval = torch.where(upd[:, None], f1, fval)
                h = torch.where(active, h_next, h)
                one = active.to(i32)
                nfev = nfev + 6 * one
                nacc = nacc + upd.to(i32)
                nrej = nrej + (active & ~accept).to(i32)
                steps = steps + one
        eps_t = 8 * torch.finfo(dtype).eps * torch.clamp(torch.abs(t_end),
                                                         min=1.0)
        nunr = nunr + (t < t_end - eps_t).to(i32)
        ys.append(y)
    return torch.stack(ys, dim=1), Dopri5Stats(nfev, nacc, nrej, nunr)


def odeint(f, y0, ts, rtol=1e-7, atol=1e-9, max_steps: int = 100_000,
           args=None):
    """Integrate dy/dt = f(t, y, *args) from ts[0] for one member (the
    signature of rmt_tpu's dopri5.odeint), returning (ys (T, n),
    Dopri5Stats of 0-d tensors); ys[0] == y0."""
    args = () if args is None else tuple(args)
    y0 = torch.as_tensor(y0)
    ys, stats = odeint_batched(
        lambda t, y: f(t[0], y[0], *args)[None], y0[None],
        torch.as_tensor(ts)[None], rtol, atol, max_steps)
    return ys[0], Dopri5Stats(*(v[0] for v in stats))
