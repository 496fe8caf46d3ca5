# Species property database as typed coefficient arrays.
#
# The reference stores these as python dicts with Cp polynomials as
# eval()-able *strings* re-parsed on every RHS call
# (reference: PyREMOT/data/componentData.py:109-424,
#  PyREMOT/data/dataGasViscosity.py:8-141,
#  PyREMOT/data/dataGasThermalConductivity.py:8-140).
# Here every property is a dense float64 coefficient array indexed by a
# species id, so the property engine compiles to pure XLA with zero python
# in the hot path. Values are preserved bit-for-bit.

from __future__ import annotations

import numpy as np

# species order matches the reference database payload order
SPECIES: tuple[str, ...] = (
    "CO2", "H2", "CH3OH", "H2O", "CO", "DME",
    "N2", "CH4", "C2H4", "C3H6", "C3H8", "C4H10",
)

_INDEX = {s: i for i, s in enumerate(SPECIES)}

# molecular weight [g/mol]
MW = np.array([
    44.01, 2.0, 32.04, 18.01, 28.01, 46.07,
    28.0, 16.04, 28.05, 42.08, 44.1, 58.12,
])

# critical temperature [K]
TC = np.array([
    304.12, 33.25, 512.64, 647.14, 132.85, 400.0,
    126.192, 190.56, 282.34, 369.9, 369.15, 425.0,
])

# critical pressure [bar]
PC = np.array([
    73.74, 12.97, 80.97, 220.64, 34.94, 53.0,
    33.98, 45.99, 50.41, 46.0, 42.5, 38.0,
])

# acentric factor [-]
ACENTRIC = np.array([
    0.239, -0.216, 0.556, 0.344, 0.066, 0.200,
    0.039, 0.011, 0.087, 0.137, 0.149, 0.197,
])

# standard heat of formation at 25C [kJ/mol]
DHF25 = np.array([
    -393.51, 0.0, -200.7, -241.820, -110.53, -184.1,
    0.0, -74.90, 52.32, 20.4, -103.9, -126.2,
])

# standard Gibbs free energy of formation at 25C [kJ/mol]
DGF25 = np.array([
    -394.6, 0.0, -162.6, -228.7, -137.4, -0.0,
    0.0, -50.83, 68.17, 62.76, -23.50, -17.2,
])

# ideal-gas heat capacity Cp(T) polynomial coefficients [kJ/kmol.K]
# Cp = c0 + c1*T + c2*T^2 + c3*T^3, T in [K]
# (coefficients transcribed from the Cp "expr" strings in the reference DB)
CP_COEFF = np.array([
    [22.243, 5.98e-02, -3.50e-05, 7.46e-09],      # CO2
    [26.879, 4.35e-03, -3.30e-07, 0.0],           # H2
    [19.038, 9.15e-02, -1.22e-05, -8.03e-09],     # CH3OH
    [29.163, 1.45e-02, -2.02e-06, 0.0],           # H2O
    [27.113, 6.55e-03, -1.00e-06, 0.0],           # CO
    [19.8, 0.17, -5.66e-5, 0.0],                  # DME
    [28.883, -1.57e-03, 8.08e-06, -2.87e-09],     # N2
    [19.875, 5.021e-02, 1.268e-05, -11.004e-09],  # CH4
    [3.950, 15.628e-02, -8.339e-05, 17.657e-09],  # C2H4
    [3.151, 23.812e-02, -12.176e-05, 24.603e-09],  # C3H6
    [-4.042, 30.456e-02, -15.711e-05, 31.716e-09],  # C3H8
    [-7.908, 41.573e-02, -22.992e-05, 49.875e-09],  # C4H10
])

# vapor viscosity correlation [Pa.s]
# eq1: mu = A*1e-6 * T^B / (1 + C/T + D/T^2)
# eq2 (DME only): mu = 2.68e-7 * T^0.3975 / (1 + 534/T)
VISC_EQ = np.array([1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 1], dtype=np.int64)
VISC_PARAMS = np.array([
    [4.719875, 0.373279, 512.686300, -6119.961],   # CO2
    [0.169104, 0.692485, -7.634394, 467.120],      # H2
    [0.477915, 0.641076, 284.838034, -3230.713],   # CH3OH
    [0.501246, 0.709247, 869.465599, -90063.891],  # H2O
    [0.734306, 0.588574, 52.318660, 1018.822],     # CO
    [1.0, 0.0, 0.0, 0.0],                          # DME (uses eq2 closed form)
    [0.847662, 0.574033, 75.437536, 56.771],       # N2
    [1.119178, 0.493234, 214.627200, -3952.087],   # CH4
    [1.503552, 0.456140, 288.342422, 73.362],      # C2H4
    [0.876767, 0.520871, 293.618650, -182.857],    # C3H6
    [0.173966, 0.734798, 143.207060, -7147.859],   # C3H8
    [0.075828, 0.837082, 67618677.0, -2141.762],   # C4H10
])

# gas thermal conductivity correlation [W/m.K]
# k = C1*T^C2 / (1 + C3/T + C4/T^2)
THCOND_PARAMS = np.array([
    [3.69, -0.3838, 964.0, 1860000.0],         # CO2
    [0.002653, 0.7452, 12.0, 0.0],             # H2
    [5.7992e-07, 1.7862, 0.0, 0.0],            # CH3OH
    [6.2041e-06, 1.3973, 0.0, 0.0],            # H2O
    [0.00059882, 0.6863, 57.13, 501.92],       # CO
    [0.059975, 0.2667, 1018.6, 1098800.0],     # DME
    [0.00033143, 0.7722, 16.323, 373.72],      # N2
    [8.3983e-06, 1.4268, -49.654, 0.0],        # CH4
    [8.6806e-06, 1.4559, 299.72, -29.403],     # C2H4
    [0.0000449, 1.2018, 421.0, 0.0],           # C3H6
    [-1.12, 0.10972, -9834.6, -7535800.0],     # C3H8
    [0.051094, 0.45253, 5455.5, 1979800.0],    # C4H10
])


class UnknownComponentError(KeyError):
    """A feed/reaction component is not in the species database."""


def species_index(symbol: str) -> int:
    try:
        return _INDEX[symbol]
    except KeyError:
        raise UnknownComponentError(
            f"Component database is not up to date! (unknown component {symbol!r}; "
            f"available: {', '.join(SPECIES)})"
        ) from None


def species_indices(symbols) -> np.ndarray:
    """Map component symbol list to database row indices."""
    return np.array([species_index(s) for s in symbols], dtype=np.int64)


def component_symbols() -> tuple[str, ...]:
    return SPECIES
