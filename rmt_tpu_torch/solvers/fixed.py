# Fixed-step explicit integrators (port of rmt_tpu/solvers/fixed.py).
#
# Parity ports of the reference's hand-rolled steppers
# (PyREMOT/solvers/odeSolver.py:17-102): classic RK4, Adams-Bashforth 3,
# and the AB3/AM4 predictor-corrector "PreCorr3" (selected by
# solver-config ivp == "AM"). The reference's lax.scan over the steps is
# a Python loop; the multistep histories ride in its carry. Every member
# of a batched state shares the time grid, so f may take y (B, n) (or
# any shape) as long as it maps over members itself.

from __future__ import annotations

import torch


def _grid(t0, tn, n, like):
    t0 = torch.as_tensor(t0, dtype=like.dtype, device=like.device)
    tn = torch.as_tensor(tn, dtype=like.dtype, device=like.device)
    return torch.abs(tn - t0) / n, torch.linspace(
        float(t0), float(tn), n + 1, dtype=like.dtype, device=like.device)


def rk4(f, t0, tn, n: int, y0, args=()):
    """Classic RK4; returns ys with shape (n+1,) + y0.shape."""
    h, ts = _grid(t0, tn, n, y0)
    ys = [y0]
    y = y0
    for t in ts[:-1]:
        k1 = f(t, y, *args)
        k2 = f(t + h / 2, y + k1 * (h / 2), *args)
        k3 = f(t + h / 2, y + k2 * (h / 2), *args)
        k4 = f(t + h, y + k3 * h, *args)
        y = y + h * (k1 + 2 * k2 + 2 * k3 + k4) / 6
        ys.append(y)
    return torch.stack(ys)


def adams_bashforth3(f, t0, tn, n: int, y0, args=()):
    """AB3 with an RK4 bootstrap for the first two steps
    (matches reference AdBash3, odeSolver.py:43-68)."""
    h, ts = _grid(t0, tn, n, y0)
    boot = rk4(f, ts[0], ts[0] + 2 * h, 2, y0, args)   # ys[0..2]
    k2 = f(ts[0], boot[0], *args)
    k1 = f(ts[1], boot[1], *args)
    ys = list(boot)
    y = boot[2]
    for t in ts[2:-1]:
        k3, k2 = k2, k1
        k1 = f(t, y, *args)
        y = y + h * (23 * k1 - 16 * k2 + 5 * k3) / 12
        ys.append(y)
    return torch.stack(ys)


def precorr3(f, t0, tn, n: int, y0, args=()):
    """AB3 predictor / AM4 corrector (reference PreCorr3,
    odeSolver.py:71-102)."""
    h, ts = _grid(t0, tn, n, y0)
    boot = rk4(f, ts[0], ts[0] + 2 * h, 2, y0, args)
    k2 = f(ts[0], boot[0], *args)
    k1 = f(ts[1], boot[1], *args)
    ys = list(boot)
    y = boot[2]
    for t, t_next in zip(ts[2:-1], ts[3:]):
        k3, k2 = k2, k1
        k1 = f(t, y, *args)
        y_pred = y + h * (23 * k1 - 16 * k2 + 5 * k3) / 12
        k0 = f(t_next, y_pred, *args)
        y = y + h * (9 * k0 + 19 * k1 - 5 * k2 + k3) / 24
        ys.append(y)
    return torch.stack(ys)
