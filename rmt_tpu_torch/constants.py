# Physical constants.
#
# Values match the reference implementation bit-for-bit
# (reference: PyREMOT/core/constants.py:8-23) so that numeric parity tests
# against the reference oracle hold to float64 precision.

import math

# universal gas constant [J/mol.K]
R_CONST = 8.314472

# epsilon floor used by dynamic models to clamp concentrations
EPS_CONST = 1e-30

# pi
PI_CONST = math.pi

# STP condition
#  pressure [Pa]
Pstp = 101325
#  temperature [K]
Tstp = 273.15

# reference temperature [K] (25 C)
Tref = Tstp + 25.00
