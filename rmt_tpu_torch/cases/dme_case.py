# Canonical DME synthesis case: CO2/CO hydrogenation to methanol+DME
# over a packed bed -- the reference's flagship chemistry
# (reference: PyREMOT/tests/test_rmt_N1_DME.py, README.md:55-173).
# The kinetics DSL below is the public Graaf/Berčič-style LHHW rate set used
# in all reference examples, expressed in the exact VARS/RATES lambda format
# the API accepts.
#
# A copy of the test fixture tests/dme_case.py that reads the port's own
# data layer, so it imports no jax (tests/test_torch_foundations.py holds
# the two equal).

import math

import numpy as np

from rmt_tpu_torch.data import defaults as _defaults

# default reactor/catalyst geometry, served by the package data layer
# (rmt_tpu_torch.data.defaults; values from reference data/inputDataReactor.py)
REA_D = _defaults.REACTOR["rea_D"]
REA_L = _defaults.REACTOR["rea_L"]
BED_POR = _defaults.REACTOR["bed_por"]
CAT_D = _defaults.CATALYST["cat_d"]
CAT_RHO = _defaults.CATALYST["cat_rho"]
CAT_CP = _defaults.CATALYST["cat_Cp"]
BULK_RHO = _defaults.CATALYST["bulk_rho"]

R_CONST = 8.314472

COMP_LIST = ["H2", "CO2", "H2O", "CO", "CH3OH", "DME"]

REACTION_SET = {
    "R1": "CO2 + 3H2 <=> CH3OH + H2O",
    "R2": "CO + H2O <=> H2 + CO2",
    "R3": "2CH3OH <=> DME + H2O",
}


def feed_mole_fraction(h2_cox_ratio=1.0, co2_co_ratio=0.5):
    """Inlet mole fractions from H2/COx and CO2/CO ratios, served by the
    package data layer (rmt_tpu.data.setFeedMoleFraction; reference
    data/initData.py:11-40, float32 rounding included)."""
    return _defaults.setFeedMoleFraction(h2_cox_ratio, co2_co_ratio)


def dme_kinetics(ca_be_de=BULK_RHO):
    """The DME VARS/RATES dict-program (reference: test_rmt_N1_DME.py:129-200)."""
    varis0 = {
        "CaBeDe": ca_be_de,
        "RT": lambda x: x["R_CONST"] * x["T"],
        "K1": lambda x: 35.45 * math.exp(-1.7069e4 / x["RT"]),
        "K2": lambda x: 7.3976 * math.exp(-2.0436e4 / x["RT"]),
        "K3": lambda x: 8.2894e4 * math.exp(-5.2940e4 / x["RT"]),
        "KH2": lambda x: 0.249 * math.exp(3.4394e4 / x["RT"]),
        "KCO2": lambda x: 1.02e-7 * math.exp(6.74e4 / x["RT"]),
        "KCO": lambda x: 7.99e-7 * math.exp(5.81e4 / x["RT"]),
        "Ln_KP1": lambda x: 4213 / x["T"]
        - 5.752 * math.log(x["T"])
        - 1.707e-3 * x["T"]
        + 2.682e-6 * (math.pow(x["T"], 2))
        - 7.232e-10 * (math.pow(x["T"], 3))
        + 17.6,
        "KP1": lambda x: math.exp(x["Ln_KP1"]),
        "log_KP2": lambda x: 2167 / x["T"]
        - 0.5194 * math.log10(x["T"])
        + 1.037e-3 * x["T"]
        - 2.331e-7 * (math.pow(x["T"], 2))
        - 1.2777,
        "KP2": lambda x: math.pow(10, x["log_KP2"]),
        "Ln_KP3": lambda x: 4019 / x["T"]
        + 3.707 * math.log(x["T"])
        - 2.783e-3 * x["T"]
        + 3.8e-7 * (math.pow(x["T"], 2))
        - 6.56e-4 / (math.pow(x["T"], 3))
        - 26.64,
        "KP3": lambda x: math.exp(x["Ln_KP3"]),
        "yi_H2": lambda x: x["MoFri"][0],
        "yi_CO2": lambda x: x["MoFri"][1],
        "yi_H2O": lambda x: x["MoFri"][2],
        "yi_CO": lambda x: x["MoFri"][3],
        "yi_CH3OH": lambda x: x["MoFri"][4],
        "yi_DME": lambda x: x["MoFri"][5],
        "PH2": lambda x: x["P"] * (x["yi_H2"]) * 1e-5,
        "PCO2": lambda x: x["P"] * (x["yi_CO2"]) * 1e-5,
        "PH2O": lambda x: x["P"] * (x["yi_H2O"]) * 1e-5,
        "PCO": lambda x: x["P"] * (x["yi_CO"]) * 1e-5,
        "PCH3OH": lambda x: x["P"] * (x["yi_CH3OH"]) * 1e-5,
        "PCH3OCH3": lambda x: x["P"] * (x["yi_DME"]) * 1e-5,
        "ra1": lambda x: x["PCO2"] * x["PH2"],
        "ra2": lambda x: 1
        + (x["KCO2"] * x["PCO2"])
        + (x["KCO"] * x["PCO"])
        + math.sqrt(x["KH2"] * x["PH2"]),
        "ra3": lambda x: (1 / x["KP1"])
        * ((x["PH2O"] * x["PCH3OH"]) / (x["PCO2"] * (math.pow(x["PH2"], 3)))),
        "ra4": lambda x: x["PH2O"] - (1 / x["KP2"]) * ((x["PCO2"] * x["PH2"]) / x["PCO"]),
        "ra5": lambda x: (math.pow(x["PCH3OH"], 2) / x["PH2O"])
        - (x["PCH3OCH3"] / x["KP3"]),
    }
    rates0 = {
        "r1": lambda x: 1000
        * x["K1"]
        * (x["ra1"] / (math.pow(x["ra2"], 3)))
        * (1 - x["ra3"])
        * x["CaBeDe"],
        "r2": lambda x: 1000 * x["K2"] * (1 / x["ra2"]) * x["ra4"] * x["CaBeDe"],
        "r3": lambda x: 1000 * x["K3"] * x["ra5"] * x["CaBeDe"],
    }
    return {"VARS": varis0, "RATES": rates0}


def make_model_input(model="N1", process_type="non-iso-thermal", P=5e6, T=523.0,
                     op_period=0.5, su_ga_ve=0.2, ivp="default", display="False",
                     kinetics=None):
    """Build the full modelInput dict for the DME packed-bed case
    (mirrors the setup block of reference test_rmt_N1_DME.py:25-269)."""
    mo_fri = feed_mole_fraction()
    # concentration [kmol/m^3]: per-element f32 arithmetic stored into a
    # float64 array, exactly like the reference helper
    # (data/initData.py:43-69 -- MoFri[i] is np.float32, Ci is np.zeros -> f64)
    ct0 = np.zeros(len(mo_fri))
    for i in range(len(mo_fri)):
        ct0[i] = (P / (R_CONST * T)) * mo_fri[i] / 1000.0
    ct0 = np.round(ct0, 7)
    ct0_conv = 1e3 * ct0  # -> mol/m^3 scale used by N1/N2 feeds

    in_ga_ve = su_ga_ve / BED_POR
    rea_csa = BED_POR * (math.pi * REA_D**2 / 4)
    vo_fl_ra = in_ga_ve * rea_csa

    u = 100.0
    a = 4 / REA_D
    tm = T - 1

    return {
        "model": model,
        "operating-conditions": {
            "pressure": P,
            "temperature": T,
            "period": op_period,
            "process-type": process_type,
        },
        "feed": {
            "volumetric-flowrate": vo_fl_ra,
            "concentration": ct0_conv,
            "components": {"shell": COMP_LIST},
        },
        "reactions": dict(REACTION_SET),
        "reaction-rates": kinetics if kinetics is not None else dme_kinetics(),
        "external-heat": {"OvHeTrCo": u, "EfHeTrAr": a, "MeTe": tm},
        "reactor": {
            "ReInDi": REA_D,
            "ReLe": REA_L,
            "PaDi": CAT_D,
            "BeVoFr": BED_POR,
            "CaBeDe": BULK_RHO,
            "CaDe": CAT_RHO,
            "CaSpHeCa": CAT_CP / 1000.0,
        },
        "solver-config": {"ivp": ivp, "display-result": display},
    }
