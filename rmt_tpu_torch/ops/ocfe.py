# Orthogonal collocation on finite elements (OCFE) for the catalyst
# particle: 4-point Lobatto elements on the radial domain with value and
# flux continuity at the element interfaces (port of rmt_tpu/ops/ocfe.py:
# the basis and operator are the same numpy float64 tables, the residual
# runs on tensors and moves them to its device once, oc_particle.table).
#
# Basis port (bit-for-bit): reference FiElClass (PyREMOT/solvers/
# solFiEl.py:8-227) -- full monomial basis on Xc = [0, 0.21132, 0.78868, 1]
# (interior points are the 2-point Gauss nodes), A = C Q^-1, B = D Q^-1,
# uniform elements h = 1/NuEl.
#
# Assembler: the intended residual of the reference's
# FiElCatParticleClass/solCatParticle2-3 (:37-151 row formulas). The
# reference's own assembly cannot produce a correct system and has no
# runnable caller:
#   * the source vector is indexed by the COLUMN of the assembly loop
#     (const2[j], solCatParticle2.py:186-191), so every interior row gets
#     the last column's source;
#   * inter-element flux continuity keeps only the scalar corner
#     EdMat[0,0] of the previous element's flux row (:249-250) -- the
#     off-diagonal entries are overwritten, so the "continuity" row
#     constrains the wrong quantity;
#   * the last element's Robin row drops the 1/h metric (:100-107).
# Here the rows are assembled as the formulas themselves state: interior
# collocation rows k_eff*((1/h^2) B + (2/x)(1/h) A) y + src, a symmetry
# row (1/h) A[0] y = 0 at the center, FULL flux-continuity rows
# (1/h_k) A[-1] y_k - (1/h_{k+1}) A[0] y_{k+1} at shared nodes, and a
# Robin surface row (1/h) A[-1] y + beta (y_s - bulk).

from __future__ import annotations

import numpy as np
import torch

from .oc_particle import table

# element collocation points (solFiEl.py:28-39)
XC_4 = np.array([0.0, 0.21132, 0.78868, 1.0])


def ocfe_basis(nu_el: int):
    """Element basis + mesh (reference FiElClass.initFiEl,
    solFiEl.py:150-227; scalar loops keep Q/A/B bit-for-bit)."""
    xc = XC_4
    n = xc.size
    q = np.zeros((n, n))
    c = np.zeros((n, n))
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            q[i, j] = 1 if j == 0 else xc[i] ** j
            c[i, j] = 0 if j == 0 else (1 if j == 1 else j * xc[i] ** (j - 1))
            if j in (0, 1):
                d[i, j] = 0
            elif j == 2:
                d[i, j] = 2
            else:
                d[i, j] = j * (j - 1) * xc[i] ** (j - 2)
    q_inv = np.linalg.inv(q)
    A = np.dot(c, q_inv)
    B = np.dot(d, q_inv)

    hi = np.full(nu_el, 1.0 / nu_el)
    li = np.zeros(nu_el + 1)
    li[1:] = np.cumsum(hi)
    n_total = nu_el * (n - 1) + 1
    xi = np.zeros(n_total)
    m = 0
    for k in range(nu_el):
        for j in range(n - 1):
            xi[m] = li[k] if j == 0 else li[k] + hi[k] * xc[j]
            m += 1
    xi[-1] = li[-1]
    return {
        "NuEl": nu_el, "NuToCoPo": n_total, "hi": hi, "li": li, "xi": xi,
        "N": n, "Xc": xc, "Q": q, "A": A, "B": B,
    }


def ocfe_operator(nu_el: int):
    """Global residual operator pieces for the spherical
    diffusion-reaction particle on the OCFE grid.

    Returns the basis plus L (n_total, n_total): the assembled linear
    operator rows -- interior rows hold (1/h^2)B + (2/x)(1/h)A (to be
    scaled by k_eff), the center row holds the symmetry constraint, the
    shared-node rows hold flux continuity, and the surface row holds
    (1/h)A[-1] (beta-term added by ocfe_residual). Masks mark which rows
    take the reaction source / are constraints."""
    basis = ocfe_basis(nu_el)
    n, n_total = basis["N"], basis["NuToCoPo"]
    A, B, hi, li, xi = basis["A"], basis["B"], basis["hi"], basis["li"], basis["xi"]

    L = np.zeros((n_total, n_total))
    interior = np.zeros(n_total, dtype=bool)
    for k in range(nu_el):
        s = k * (n - 1)                      # global index of element start
        h, l = hi[k], li[k]
        for i in range(1, n - 1):
            g = s + i
            x_g = xi[g]
            L[g, s:s + n] += B[i] / h**2 + (2.0 / x_g) * (A[i] / h)
            interior[g] = True
        if k < nu_el - 1:
            g = s + n - 1                    # shared node: flux continuity
            L[g, s:s + n] += A[n - 1] / h
            s2 = (k + 1) * (n - 1)
            L[g, s2:s2 + n] -= A[0] / hi[k + 1]
    L[0, 0:n] = A[0] / hi[0]                 # center symmetry: dy/dx = 0
    L[-1, n_total - n:] = A[n - 1] / hi[-1]  # surface flux (Robin base)
    return {**basis, "L": L, "interior": interior}


def ocfe_residual(y, k_eff, source, beta, bulk, ops):
    """Residual on the OCFE grid:

      center row:      (1/h0) A[0] . y_el0                    = 0
      interior rows:   k_eff * ((1/h^2)B + (2/x)(1/h)A) . y + source
      shared nodes:    (1/h_k) A[-1] . y_k - (1/h_k+1) A[0] . y_k+1 = 0
      surface row:     (1/h) A[-1] . y + beta (y_s - bulk)    = 0

    y: (..., NuToCoPo); source: (..., NuToCoPo) (only interior entries
    used); k_eff scales the diffusion operator on interior rows only."""
    L = table(ops, "L", y)
    interior = table(ops, "interior", torch.zeros((), dtype=torch.bool,
                                                  device=y.device))
    Ly = y @ L.T
    scale = torch.where(interior, torch.as_tensor(k_eff, dtype=y.dtype,
                                                  device=y.device),
                        torch.ones((), dtype=y.dtype, device=y.device))
    res = scale * Ly + torch.where(interior, source, torch.zeros_like(source))
    surface = res[..., -1] + beta * (y[..., -1] - bulk)
    return torch.cat([res[..., :-1], surface[..., None]], dim=-1)
