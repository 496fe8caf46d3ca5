# Radau IIA tableau and the stage-predictor extrapolation weights (port of
# rmt_tpu/solvers/radau.py: radau_tableau and extrap_weights; the
# sequential per-member integrator of that file is not ported yet).

from __future__ import annotations

import numpy as np
import torch


def extrap_weights(c_np, r):
    """Collocation-extrapolation weights for the Radau stage predictor.

    W[..., i, j] = l_j(1 + c_i * r), the Lagrange basis over the node set
    {0, c_1..c_s} evaluated at the NEXT step's stage abscissae expressed in
    the previous step's local coordinate (r = h_new / h_prev). The
    previous stage offsets vanish at node 0, so that basis column is
    dropped. r may be batched: output shape r.shape + (s, s).
    """
    xs = [0.0] + [float(x) for x in c_np]
    s = len(c_np)
    r = torch.as_tensor(r)
    sv = 1.0 + torch.as_tensor(np.asarray(c_np), dtype=r.dtype,
                               device=r.device) * r[..., None]   # (..., s)
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
