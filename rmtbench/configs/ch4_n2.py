"""The ch4_n2 chemistry, frozen: methane coupling
2 CH4 <=> C2H4 + 2 H2 over a packed bed, a second-order rate on the CH4
concentration (PyREMOT tests/test_rmt_N2_CH4.py:20-252, its rate law at
:188-204). Species data are PyREMOT's tables for the three species. The
float64 reference (reference/n2.py) runs it; it imports nothing of the
measured program."""

import numpy as np

COMPONENTS = ("CH4", "C2H4", "H2")
K0 = 0.0072 * 1e-1          # m^3 / (mol s)


def rates(T, P, x, conc):
    """The one rate (1, z) [mol/(m^3 s)] from the CH4 concentration."""
    return (K0 * conc[0] ** 2)[None]


CHEMISTRY = dict(
    mw=np.array([16.04, 28.05, 2.0]),
    cp=np.array([[19.875, 5.021e-2, 1.268e-5, -1.1004e-8],
                 [3.95, 0.15628, -8.339e-5, 1.7657e-8],
                 [26.879, 4.35e-3, -3.3e-7, 0.0]]),
    visc=np.array([[1.119178, 0.493234, 214.627200, -3952.087],
                   [1.503552, 0.456140, 288.342422, 73.362],
                   [0.169104, 0.692485, -7.634394, 467.12]]),
    visc_eq2=np.array([False, False, False]),
    nu=np.array([[-2.0, 1.0, 2.0]]),
    eq_cp=np.array([[19.875, 5.021e-2, 1.268e-5, -1.1004e-8],
                    [3.95, 0.15628, -8.339e-5, 1.7657e-8],
                    [26.879, 4.35e-3, -3.3e-7, 0.0]]),
    eq_nu=np.array([[-2.0, 1.0, 2.0]]),
    dh25=np.array([202120.0]),
    rates=rates,
)
