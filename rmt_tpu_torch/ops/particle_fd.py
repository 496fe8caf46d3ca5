# Spherical-particle finite-difference residual assemblers (dimensionless),
# vectorized over the radial nodes (port of rmt_tpu/ops/particle_fd.py).
#
# Direct ports of the reference's per-node loops
# (reference: PyREMOT/solvers/solFiDi.py:319-529,
#  FiDiBuildCMatrix_DiLe / FiDiBuildTMatrix_DiLe with mode="test").
# Node layout: index 0 = particle center (symmetry BC via the 3x trick),
# index rNo-1 = gas-solid interface (Robin BC via a ghost point).
# The reference's quirks are reproduced deliberately:
#   * the radial coordinate in the first-derivative metric uses ri = i*dr
#     for both flux directions (solFiDi.py:370,412);
#   * the reaction term enters *unscaled* (the dimensionless scaling is
#     commented out upstream, solFiDi.py:377-378).
# Each assembler takes profiles with any leading axes (..., rNo) and
# per-profile scalars of those leading axes, so every species of a
# particle goes through one call.

from __future__ import annotations

import torch


def _radial(y):
    """(dr, ri, y_m, y_p) of profiles y (..., rNo): the spacing, the
    metric radius (1 at the center), and the neighbours y[i-1], y[i+1]
    padded with the edge values."""
    r_no = y.shape[-1]
    dr = 1.0 / (r_no - 1)
    idx = torch.arange(r_no, device=y.device)
    ri = torch.where(idx == 0, torch.ones((), dtype=y.dtype, device=y.device),
                     idx.to(y.dtype) * dr)
    y_m = torch.cat([y[..., :1], y[..., :-1]], dim=-1)
    y_p = torch.cat([y[..., 1:], y[..., -1:]], dim=-1)
    return dr, ri, y_m, y_p


def _assemble(y, const1, const2, y_ghost, dr, ri, y_m, y_p, source):
    """The center, interior and surface rows of the spherical Laplacian
    with the interface ghost value, plus the source."""
    center = 3 * const1 * (2 * y_p - 2 * y)
    interior = const1 * (y_m - 2 * y + y_p) + const2 * (y_p - y_m)
    surface = (const1[..., 0] * (y[..., -2] - 2 * y[..., -1] + y_ghost)
               + const2[..., -1] * (y_ghost - y[..., -2]))
    a = torch.cat([center[..., :1], interior[..., 1:-1],
                   surface[..., None]], dim=-1)
    return a + source


def build_c_residual(y, ri_term, di_dile, ma_tr_co, c_bulk, ga_dii0, rf,
                     flux_dir="lr"):
    """Concentration residual A[r] over the radial profiles y (..., rNo).

    di_dile: dimensionless diffusivity; ma_tr_co: mass transfer coefficient;
    c_bulk: bulk concentration (dimensionless); ga_dii0: reference
    diffusivity scale (SoDiiEff upstream); rf: particle radius. The
    scalars carry y's leading axes.
    """
    dr, ri, y_m, y_p = _radial(y)
    d = torch.as_tensor(di_dile, dtype=y.dtype, device=y.device)[..., None]
    const1 = (d / dr**2).expand(y.shape)
    const2 = 2 * d / (ri * 2 * dr)

    # ghost point at the interface
    alpha = rf / ga_dii0
    beta = ma_tr_co / di_dile
    dile_no = alpha * beta
    if flux_dir == "rl":
        y_ghost = y[..., -2] + (2 * dr) * dile_no * (c_bulk - y[..., -1])
    else:
        y_ghost = y[..., -2] - (2 * dr) * dile_no * (y[..., -1] - c_bulk)
    return _assemble(y, const1, const2, y_ghost, dr, ri, y_m, y_p, ri_term)


def build_t_residual(y, dh_term, k_dile, he_tr_co, t_bulk, k_ref, rf):
    """Temperature residual over the radial profile y (..., rNo).

    k_dile: dimensionless effective conductivity; he_tr_co: heat transfer
    coefficient [kJ/m^2.s.K]; k_ref: conductivity scale [kJ/s.m.K].
    """
    dr, ri, y_m, y_p = _radial(y)
    k = torch.as_tensor(k_dile, dtype=y.dtype, device=y.device)[..., None]
    const1 = (k / dr**2).expand(y.shape)
    const2 = 2 * k / (ri * 2 * dr)

    alpha = rf / k_ref
    beta = -he_tr_co / k_dile
    dile_no = alpha * beta
    y_ghost = (2 * dr) * dile_no * (y[..., -1] - t_bulk) + y[..., -2]
    return _assemble(y, const1, const2, y_ghost, dr, ri, y_m, y_p, dh_term)
