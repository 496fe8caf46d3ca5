"""The dme_n2 chemistry, frozen: CO2/CO hydrogenation to methanol and its
dehydration to dimethyl ether over a packed bed (PyREMOT README.md:55-173,
tests/test_rmt_N1_DME.py:129-200: the Graaf / Bercic LHHW rate set).

Species data are PyREMOT's tables for these six species (molecular
weights, Cp polynomials, viscosity correlations, heats of formation as
the heats of reaction at 25 C). The float64 reference
(reference/n2.py) runs it; it imports nothing of the measured program."""

import numpy as np

COMPONENTS = ("H2", "CO2", "H2O", "CO", "CH3OH", "DME")
R_CONST = 8.314472
CA_BE_DE = 1209.02          # catalyst bed density in the rate law [kg/m^3]


def rates(T, P, x, conc):
    """Reaction rates (3, z) [mol/(m^3 s)] at node temperatures T [K],
    pressures P [Pa] and mole fractions x (6, z)."""
    RT = R_CONST * T
    K1 = 35.45 * np.exp(-1.7069e4 / RT)
    K2 = 7.3976 * np.exp(-2.0436e4 / RT)
    K3 = 8.2894e4 * np.exp(-5.2940e4 / RT)
    KH2 = 0.249 * np.exp(3.4394e4 / RT)
    KCO2 = 1.02e-7 * np.exp(6.74e4 / RT)
    KCO = 7.99e-7 * np.exp(5.81e4 / RT)
    KP1 = np.exp(4213 / T - 5.752 * np.log(T) - 1.707e-3 * T
                 + 2.682e-6 * T ** 2 - 7.232e-10 * T ** 3 + 17.6)
    KP2 = 10.0 ** (2167 / T - 0.5194 * np.log10(T) + 1.037e-3 * T
                   - 2.331e-7 * T ** 2 - 1.2777)
    KP3 = np.exp(4019 / T + 3.707 * np.log(T) - 2.783e-3 * T
                 + 3.8e-7 * T ** 2 - 6.56e-4 / T ** 3 - 26.64)
    # partial pressures [bar]
    pH2, pCO2, pH2O, pCO, pMeOH, pDME = (P * x[i] * 1e-5 for i in range(6))
    ra1 = pCO2 * pH2
    ra2 = 1 + KCO2 * pCO2 + KCO * pCO + np.sqrt(KH2 * pH2)
    ra3 = (1 / KP1) * ((pH2O * pMeOH) / (pCO2 * pH2 ** 3))
    ra4 = pH2O - (1 / KP2) * ((pCO2 * pH2) / pCO)
    ra5 = pMeOH ** 2 / pH2O - pDME / KP3
    return np.stack([
        1000 * K1 * (ra1 / ra2 ** 3) * (1 - ra3) * CA_BE_DE,
        1000 * K2 * (1 / ra2) * ra4 * CA_BE_DE,
        1000 * K3 * ra5 * CA_BE_DE])


CHEMISTRY = dict(
    mw=np.array([2.0, 44.01, 18.01, 28.01, 32.04, 46.07]),
    # Cp = c0 + c1 T + c2 T^2 + c3 T^3 [kJ/(kmol K)]
    cp=np.array([[26.879, 4.35e-3, -3.3e-7, 0.0],
                 [22.243, 5.98e-2, -3.5e-5, 7.46e-9],
                 [29.163, 1.45e-2, -2.02e-6, 0.0],
                 [27.113, 6.55e-3, -1.0e-6, 0.0],
                 [19.038, 9.15e-2, -1.22e-5, -8.03e-9],
                 [19.8, 0.17, -5.66e-5, 0.0]]),
    # A 1e-6 T^B / (1 + C / T + D / T^2) [Pa s]; DME by its own closed form
    visc=np.array([[0.169104, 0.692485, -7.634394, 467.12],
                   [4.7198750, 0.373279, 512.686300, -6119.961],
                   [0.501246, 0.709247, 869.465599, -90063.891],
                   [0.734306, 0.588574, 52.318660, 1018.822],
                   [0.477915, 0.641076, 284.838034, -3230.713],
                   [1.0, 0.0, 0.0, 0.0]]),
    visc_eq2=np.array([False, False, False, False, False, True]),
    # R1 CO2 + 3H2 <=> CH3OH + H2O; R2 CO + H2O <=> H2 + CO2;
    # R3 2CH3OH <=> DME + H2O
    nu=np.array([[-3.0, -1.0, 1.0, 0.0, 1.0, 0.0],
                 [1.0, 1.0, -1.0, -1.0, 0.0, 0.0],
                 [0.0, 0.0, 1.0, 0.0, -2.0, 1.0]]),
    # the equations' species in order of appearance: CO2, H2, CH3OH, H2O,
    # CO, DME
    eq_cp=np.array([[22.243, 5.98e-2, -3.5e-5, 7.46e-9],
                    [26.879, 4.35e-3, -3.3e-7, 0.0],
                    [19.038, 9.15e-2, -1.22e-5, -8.03e-9],
                    [29.163, 1.45e-2, -2.02e-6, 0.0],
                    [27.113, 6.55e-3, -1.0e-6, 0.0],
                    [19.8, 0.17, -5.66e-5, 0.0]]),
    eq_nu=np.array([[-1.0, -3.0, 1.0, 1.0, 0.0, 0.0],
                    [1.0, 1.0, 0.0, -1.0, -1.0, 0.0],
                    [0.0, 0.0, -2.0, 1.0, 0.0, 1.0]]),
    # heats of reaction at 25 C [kJ/kmol]
    dh25=np.array([-49010.0, -41160.0, -24520.0]),
    rates=rates,
)
