# Orthogonal-collocation particle assembler: Robin-interface update +
# diffusion-reaction residual on the symmetric OC basis (port of
# rmt_tpu/ops/oc_particle.py).
#
# Port of the reference's OrCoCatParticleClass (PyREMOT/solvers/
# solCatParticle.py:28-242). Layout is the OC basis's own ordering
# (solOrCo.py:31-57): index 0 = innermost collocation point, index N-1 =
# the gas-solid surface (x = 1). rmt_tpu's module notes why the
# reference's own assembly cannot run (buildLhsMatrix indexes an empty
# const3, solCatParticle.py:150) and why rows stay aligned with their
# collocation points (the mode="test" semantics); this port keeps both
# decisions.
#
# The operators are numpy float64 tables built once (oc_operator);
# table() keeps one copy of each on every device and dtype it is asked
# for, so a residual moves them to the card once, not per call.

from __future__ import annotations

import torch

from .collocation import build_matrices


def table(ops, key, like: torch.Tensor) -> torch.Tensor:
    """ops[key] as a tensor of like's dtype on like's device, made once
    per (key, device, dtype) and kept in ops."""
    cache = ops.setdefault("_tensors", {})
    k = (key, like.device, like.dtype)
    if k not in cache:
        cache[k] = torch.as_tensor(ops[key], dtype=like.dtype,
                                   device=like.device)
    return cache[k]


def interface_update(y, bulk, beta, A, flux_dir="lr"):
    """Replace the surface value y[..., -1] by the solution of the Robin
    boundary row (reference CalUpdateYnSolidGasInterface,
    solCatParticle.py:28-85).

    The surface row of the first-derivative operator A enforces
    A[-1] . y = -beta (y_s - bulk) (flux_dir "lr") or
    A[-1] . y = +beta (bulk - y_s) with the reference's "rl" sign layout;
    both solve to the same affine form in y[:-1].

    y: (..., N) collocation values, center-first; beta: dimensionless
    transfer number (MaTrCo*rf/D-type, already scaled by the caller);
    A: the (N, N) operator (table(ops, "A", y) keeps it on the device).
    """
    A = torch.as_tensor(A, dtype=y.dtype, device=y.device)
    s = y[..., :-1] @ A[-1, :-1]
    if flux_dir == "rl":
        yn = (s + beta * bulk) / (beta - A[-1, -1])
    else:
        yn = (beta * bulk - s) / (beta + A[-1, -1])
    return torch.cat([y[..., :-1], yn.expand(y.shape[:-1])[..., None]],
                     dim=-1)


def oc_operator(xc=None):
    """L = B + (2/Xc) A -- the spherical Laplacian on collocation values
    (reference fR interior rows, solCatParticle.py:102-105) -- plus the
    matrices themselves."""
    mats = build_matrices(xc)
    xc_v = mats["Xc"]
    L = mats["B"] + (2.0 / xc_v)[:, None] * mats["A"]
    return {"L": L, **mats}


def oc_residual(y, k_eff, source, beta, bulk, ops):
    """R . y + f with the Robin surface row (reference buildOrCoMatrix
    called with const3=(bulk, beta), solCatParticle.py:205-239, unflipped
    mode="test" row order):

      interior i:  k_eff * (B + (2/Xc) A)[i] . y + source[i]
      surface:     A[-1] . y + beta * (y[-1] - bulk)

    y: (..., N) center-first; source: (..., N) (surface entry unused);
    k_eff: dimensionless effective diffusivity/conductivity; beta, bulk:
    scalars of y's leading axes; returns the residual aligned with the
    collocation points.
    """
    L = table(ops, "L", y)
    A = table(ops, "A", y)
    interior = k_eff * (y @ L.T) + source
    surface = y @ A[-1] + beta * (y[..., -1] - bulk)
    return torch.cat([interior[..., :-1], surface[..., None]], dim=-1)
