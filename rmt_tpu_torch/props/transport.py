# Gas transport properties on tensors (port of rmt_tpu/props/transport.py):
# pure-species viscosity and thermal conductivity, the Wilke mixture rule,
# and Chapman-Enskog binary diffusivities combined by Blanc's law.

from __future__ import annotations

import numpy as np
import torch

from ..data import species as DB


def viscosity(T, idx: np.ndarray):
    """Pure-species low-pressure vapor viscosity [Pa.s].

    eq1: A*1e-6*T^B/(1 + C/T + D/T^2); DME uses its dedicated closed form
    (reference: gasTransPor.py:137-168, data/dataGasViscosity.py:131-135).
    """
    T = torch.as_tensor(T)
    p = torch.as_tensor(DB.VISC_PARAMS[idx], dtype=T.dtype, device=T.device)
    is_eq2 = torch.as_tensor(DB.VISC_EQ[idx] == 2, device=T.device)
    T = T[..., None]
    eq1 = p[..., 0] * 1e-6 * T ** p[..., 1] / (
        1 + p[..., 2] * (1 / T) + p[..., 3] * T**-2
    )
    eq2 = 2.68e-7 * T**0.3975 / (1 + (534 / T))
    return torch.where(is_eq2, eq2, eq1)


def thermal_conductivity(T, idx: np.ndarray):
    """Pure-species gas thermal conductivity [W/m.K].

    k = C1*T^C2/(1 + C3/T + C4/T^2) (reference: gasTransPor.py:335-354).
    """
    T = torch.as_tensor(T)
    p = torch.as_tensor(DB.THCOND_PARAMS[idx], dtype=T.dtype, device=T.device)
    T = T[..., None]
    return (p[..., 0] * T ** p[..., 1]) / (1 + p[..., 2] / T + p[..., 3] / T**2)


def wilke_mixture(prop_i, mole_frac, mw):
    """Wilke mixture rule for viscosity/conductivity (reference:
    gasTransPor.py:229-274). For i<j
      phi_ij = (1 + sqrt(x_i/x_j) (MW_j/MW_i)^(1/4))^2 / sqrt(8 (1+MW_i/MW_j))
    and the lower triangle follows the reference's recurrence
      phi_ji = (x_j/x_i) (MW_i/MW_j) phi_ij.
    """
    x = torch.as_tensor(prop_i)
    n = x.shape[-1]
    xi = x[..., :, None]
    xj = x[..., None, :]
    mi = mw[:, None]
    mj = mw[None, :]
    upper = (1 + torch.sqrt(xi / xj) * (mj / mi) ** 0.25) ** 2 / torch.sqrt(
        8 * (1 + mi / mj)
    )
    lower = (xi / xj) * (mj / mi) * torch.swapaxes(upper, -1, -2)
    i_idx = torch.arange(n, device=x.device)[:, None]
    j_idx = torch.arange(n, device=x.device)[None, :]
    phi = torch.where(i_idx == j_idx, torch.ones_like(upper),
                      torch.where(i_idx < j_idx, upper, lower))
    num = x * mole_frac
    den = torch.sum(mole_frac[..., None, :] * phi, dim=-1)
    return torch.sum(num / den, dim=-1)


def diffusivity_chapman_enskog(T, P, mole_frac, idx: np.ndarray):
    """Mixture diffusion coefficients [m^2/s]: Chapman-Enskog binary pairs
    combined with Blanc's law (reference: gasTransPor.py:42-131)."""
    T = torch.as_tensor(T)

    def table(a):
        return torch.as_tensor(a, dtype=T.dtype, device=T.device)

    mw, tc, pc = table(DB.MW[idx]), table(DB.TC[idx]), table(DB.PC[idx])
    n = len(idx)

    ek = 0.75 * tc  # e/K per species
    sigma = 2.44 * (tc / pc) ** (1.0 / 3.0)

    eij = torch.sqrt(ek[:, None] * ek[None, :])
    sigij = 0.5 * (sigma[:, None] + sigma[None, :])

    off = ~torch.eye(n, dtype=torch.bool, device=T.device)
    one = torch.ones_like(eij)
    # avoid nan on the (unused) diagonal
    Ts = T / torch.where(off, eij, one)
    omega = (44.54 * Ts**-4.909 + 1.911 * Ts**-1.575) ** 0.10

    dij = (
        1e-4
        * 0.0018583
        * torch.sqrt(T**3 * (1 / mw[:, None] + 1 / mw[None, :]))
        / ((P * 9.86923e-6) * sigij**2 * omega)
    )
    dij = torch.where(off, dij, torch.zeros_like(dij))
    # the reference fills only the upper triangle, then symmetrizes by D + D^T
    dij_new = torch.triu(dij) + torch.triu(dij).T
    dij_safe = torch.where(off, dij_new, one)
    terms = torch.where(off, mole_frac[None, :] / dij_safe,
                        torch.zeros_like(dij_safe))
    return 1.0 / torch.sum(terms, dim=-1)
