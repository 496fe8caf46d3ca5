# Default reactor/catalyst/membrane geometry and feed-composition helpers.
#
# Values and semantics match the reference data layer bit-for-bit
# (reference: PyREMOT/data/inputDataReactor.py:7-57, initData.py:11-78) so
# a canonical model input can be built from the installed package alone --
# the reference keeps these in importable module globals; here they are a
# typed dict plus pure functions.

from __future__ import annotations

import numpy as np

from ..constants import R_CONST
from ..utils.round import roundNum

# mole-fraction / concentration rounding accuracies
# (reference: core/config.py:8-24)
MOLE_FRACTION_ACCURACY = 4
CONCENTRATION_ACCURACY = 7

# packed-bed reactor (inputDataReactor.py:7-21)
REACTOR = {
    "rea_D": 0.0381,       # packed reactor diameter [m]
    "reaW_D": 0.0025,      # reactor diameter [m]
    "reaWall_D": 0.01,     # reactor wall thickness [m]
    "rea_L": 1.0,          # bed height [m]
    "bed_por": 0.39,       # bed porosity
    "kwall": 50.0,         # wall thermal conductivity [J/K.m.s]
}

# catalyst (inputDataReactor.py:23-39)
CATALYST = {
    "cat_d": 0.002,        # particle diameter [m]
    "cat_rho": 1982.0,     # particle density [kg/m^3]
    "cat_por": 0.45,       # porosity
    "cat_tor": 2.0,        # tortuosity
    "therCop": 12.6,       # thermal conductivity [J/K.m.s]
    "cat_Cp": 960.0,       # specific heat capacity [J/kg.K]
}
CATALYST["bulk_rho"] = CATALYST["cat_rho"] * (1 - REACTOR["bed_por"])

# membrane (inputDataReactor.py:41-57; unused by the shipped models, kept
# for input-building parity)
MEMBRANE = {
    "mem_D": 0.0254,
    "mem_t": 0.0001,
    "mem_A": 100.0,
    "QH2O": 5e-10,
    "SelH2OH2": 30.0,
    "av": 352.0,
    "kmem": 1.0,
}
MEMBRANE["QH2"] = MEMBRANE["QH2O"] / MEMBRANE["SelH2OH2"]


def setFeedMoleFraction(H2COxRatio: float, CO2COxRatio: float) -> np.ndarray:
    """Inlet mole fractions [H2, CO2, H2O, CO, CH3OH, DME] from the H2/COx
    and CO2/CO ratios (reference initData.py:11-40, float32 output
    included -- the reference's rounding behavior propagates into every
    downstream concentration)."""
    y0_h2o = 0.00001
    y0_ch3oh = 0.00001
    y0_dme = 0.00001
    tmf0 = 1 - (y0_h2o + y0_ch3oh + y0_dme)
    cox = tmf0 / (H2COxRatio + 1)
    y0_h2 = H2COxRatio * cox
    y0_co2 = CO2COxRatio * cox
    y0_co = cox - y0_co2
    return np.array(
        [y0_h2, y0_co2, y0_h2o, y0_co, y0_ch3oh, y0_dme], dtype=np.float32
    )


def calConcentration(MoFri, P: float, T: float, unit: str = "kmol/m^3"):
    """Component concentrations from mole fractions at (P, T), ideal gas
    (reference initData.py:43-69 -- per-element f32 arithmetic stored into
    a float64 array, then rounded to CONCENTRATION_ACCURACY)."""
    mo_fri = np.asarray(MoFri)
    ci = np.zeros(len(mo_fri))
    for i in range(len(mo_fri)):
        ci[i] = (P / (R_CONST * T)) * mo_fri[i] / 1000.0
    if unit == "mol/m^3":
        ci = 1e3 * ci
    return roundNum(ci, CONCENTRATION_ACCURACY)


def calTotalConcentration(Ci):
    """Total concentration (reference initData.py:72-78)."""
    return roundNum(np.sum(np.asarray(Ci)), CONCENTRATION_ACCURACY)
