# Gas transport properties on tensors (port of rmt_tpu/props/transport.py,
# the parts the N2 feed state reads: pure-species viscosity and the Wilke
# mixture rule).

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
