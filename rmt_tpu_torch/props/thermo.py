# Thermodynamic property functions on tensors (port of
# rmt_tpu/props/thermo.py).
#
# Coefficient tables are numpy float64 (data/species.py); each function
# casts them to the dtype and device of its temperature argument, so an
# f32 evaluation stays f32 end to end.

from __future__ import annotations

import numpy as np
import torch

from ..constants import R_CONST, Tref
from ..data import species as DB


def _table(arr, like: torch.Tensor):
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


def cp_mol(T, idx: np.ndarray):
    """Ideal-gas heat capacity Cp(T) [kJ/kmol.K] for species rows ``idx``.
    Returns shape ``T.shape + (len(idx),)``."""
    T = torch.as_tensor(T)
    c = _table(DB.CP_COEFF[idx], T)                      # (S, 4)
    T = T[..., None]
    return c[..., 0] + c[..., 1] * T + c[..., 2] * T**2 + c[..., 3] * T**3


def cp_mean(T2, idx: np.ndarray, T1=Tref):
    """Mean Cp between T1 and T2 [kJ/kmol.K]: 0.5*(Cp(T1)+Cp(T2))."""
    T2 = torch.as_tensor(T2)
    T1 = torch.as_tensor(T1, dtype=T2.dtype, device=T2.device)
    return 0.5 * (cp_mol(T1, idx) + cp_mol(T2, idx))


def cp_mix(mole_frac, cp_i):
    """Mixture Cp [kJ/kmol.K] as mole-fraction weighted dot product."""
    return torch.sum(mole_frac * cp_i, dim=-1)


def enthalpy_change(T2, idx: np.ndarray, T1=Tref):
    """Enthalpy change Cp_mean*(T2-T1) [kJ/kmol] per species."""
    T2 = torch.as_tensor(T2)
    return cp_mean(T2, idx, T1) * (T2[..., None] - T1)


def volumetric_flowrate_ig(P, T, molar_flows):
    """Total volumetric flowrate of an ideal gas [m^3/s]."""
    return (R_CONST * T / P) * torch.sum(molar_flows, dim=-1)


def concentration_ig(molar_flows, vol_flow):
    """Species concentration [mol/m^3] from molar flow / volumetric flow."""
    return molar_flows / vol_flow


def density_ig(mw_mix, conc_total):
    """Ideal-gas density [kg/m^3] = MW [kg/mol] * total concentration."""
    return mw_mix * conc_total


def density_ig_eos(P, T, mw_mix):
    """Ideal-gas density from the EOS [kg/m^3]."""
    return P / ((R_CONST / mw_mix) * T)


def mixture_molecular_weight(mole_frac, mw, unit: str = "g/mol"):
    """Mixture molecular weight; unit in {g/mol, kg/mol, kg/kmol}."""
    m = torch.sum(mole_frac * mw, dim=-1)
    if unit == "kg/mol":
        return m * 1e-3
    return m


def mole_fraction_from_concentration(conc):
    """Mole fractions from species concentrations (last axis)."""
    return conc / torch.sum(conc, dim=-1, keepdim=True)
