# Methane-coupling case: 2CH4 <=> C2H4 + 2H2 over a packed bed -- the
# reference's second published chemistry for the dynamic N2 model
# (reference: PyREMOT/tests/test_rmt_N2_CH4.py:20-252). Exercises the
# kinetics DSL with a second-order concentration-based rate (SpCoi instead
# of partial pressures), a stoichiometric coefficient > 1 in the reaction
# string, and the Tm==0 => adiabatic external-heat quirk
# (rmtUtility.py:437-439).
#
# A copy of the N2 part of the test fixture tests/ch4_case.py that reads
# the port's own data layer, so it imports no jax
# (tests/test_torch_foundations.py holds the two equal).

import math

from rmt_tpu_torch.data import defaults as _defaults

BED_POR = _defaults.REACTOR["bed_por"]
CAT_D = _defaults.CATALYST["cat_d"]
CAT_RHO = _defaults.CATALYST["cat_rho"]
CAT_CP = _defaults.CATALYST["cat_Cp"]
BULK_RHO = CAT_RHO * (1 - BED_POR)

COMP_LIST = ["CH4", "C2H4", "H2"]

REACTION_SET = {
    "R1": "2CH4 <=> C2H4 + 2H2",
}


def ch4_kinetics():
    """The CH4-coupling VARS/RATES dict-program
    (reference: test_rmt_N2_CH4.py:188-204): a single second-order rate
    on the CH4 concentration."""
    varis0 = {
        # [m^3/(mol*s)]
        "k0": 0.0072 * 1e-1,
        "y_CH4": lambda x: x["MoFri"][0],
        "C_CH4": lambda x: x["SpCoi"][0],
    }
    rates0 = {
        # [mol/m^3.s]
        "r1": lambda x: x["k0"] * (x["C_CH4"] ** 2),
    }
    return {"VARS": varis0, "RATES": rates0}


def make_model_input(model="N2", process_type="non-iso-thermal", P=3e5,
                     T=973.0, op_period=10.0, su_ga_ve=0.01, ivp="default",
                     display="False"):
    """Full modelInput for the CH4-coupling packed-bed case (mirrors the
    setup block of reference test_rmt_N2_CH4.py:20-252: rea_dia=0.007 m,
    U=50, Tm=0 -> adiabatic)."""
    mo_fr_h2 = 0.05
    mo_fr_c2h4 = 0.05
    mo_fri0 = [1 - (mo_fr_h2 + mo_fr_c2h4), mo_fr_c2h4, mo_fr_h2]

    # concentrations via the package data layer (same helpers the reference
    # test imports from data/initData.py)
    ct0 = _defaults.calConcentration(mo_fri0, P, T, "kmol/m^3")
    ct0_conv = 1e3 * ct0

    rea_dia = 0.007
    rea_len = 1.0
    in_ga_ve = su_ga_ve / BED_POR
    rea_csa = BED_POR * (math.pi * rea_dia**2 / 4)
    vo_fl_ra = in_ga_ve * rea_csa

    u = 50.0
    a = 4 / rea_dia
    tm = 0.0  # reference quirk: MeTe == 0 means adiabatic (Qm = 0)

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
            "mixture-viscosity": 1e-5,
            "components": {"shell": list(COMP_LIST)},
        },
        "reactions": dict(REACTION_SET),
        "reaction-rates": ch4_kinetics(),
        "external-heat": {"OvHeTrCo": u, "EfHeTrAr": a, "MeTe": tm},
        "reactor": {
            "ReInDi": rea_dia,
            "ReLe": rea_len,
            "PaDi": CAT_D,
            "BeVoFr": BED_POR,
            "CaBeDe": BULK_RHO,
            "CaDe": CAT_RHO,
            "CaSpHeCa": CAT_CP / 1000.0,
        },
        "solver-config": {"ivp": ivp, "display-result": display},
    }
