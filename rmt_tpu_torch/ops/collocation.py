# Orthogonal collocation on symmetric (even-power) polynomials (the
# port's copy of rmt_tpu/ops/collocation.py, which is numpy only).
#
# The catalyst-particle profiles are symmetric about r=0, so the basis is
# y(x) = sum_j d_j x^(2j) on collocation points Xc (+ the surface point
# x=1). First/second derivative operators A = C Q^-1, B = D Q^-1 are tiny
# dense float64 tables, built once on the host. (reference:
# PyREMOT/solvers/solOrCo.py:31-199; the 7 spherical points are
# reproduced bit-for-bit.)

from __future__ import annotations

import numpy as np

# 6 interior spherical collocation points + surface (reference solOrCo.py:38-46)
SPHERICAL_POINTS_7 = np.array(
    [0.215353, 0.420638, 0.606253, 0.763519, 0.885082, 0.965245, 1.0]
)


def build_matrices(xc: np.ndarray | None = None):
    """Q, A (1st deriv), B (2nd deriv) operators on collocation values.

    y'(Xc) = A @ y(Xc), y''(Xc) = B @ y(Xc) for y in span{x^(2j)}.
    """
    xc = SPHERICAL_POINTS_7 if xc is None else np.asarray(xc)
    n = xc.size

    # scalar evaluation, entry by entry: x**k on a float scalar can differ
    # from the vectorized array power by 1 ulp, and inv(Q) (condition
    # number ~1e9 for the degree-12 basis) amplifies that to ~1e-10 in
    # A/B -- scalar order keeps the operators bit-for-bit with the
    # reference's loops (solOrCo.py:130-188)
    q = np.zeros((n, n))
    c = np.zeros((n, n))
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            q[i, j] = xc[i] ** (2 * j)
            c[i, j] = 0.0 if j == 0 else (2 * j) * xc[i] ** (2 * j - 1)
            if j == 0:
                d[i, j] = 0.0
            elif j == 1:
                d[i, j] = 2.0
            else:
                d[i, j] = 2 * j * (2 * j - 1) * xc[i] ** (2 * j - 2)
    q_inv = np.linalg.inv(q)
    return {"N": n, "Xc": xc, "Q": q, "A": np.dot(c, q_inv), "B": np.dot(d, q_inv)}
