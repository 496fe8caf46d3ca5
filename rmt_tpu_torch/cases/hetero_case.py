# Model inputs of the particle, axial-dispersion and steady heterogeneous
# models (T1, T2, T3, M5, M14) on the DME case: the inputs rmt_tpu's own
# tests give these models (tests/test_particle.py::_t1_model_input and
# _t2_model_input, tests/test_t3.py::_t3_model_input,
# tests/test_m14.py::_m14_model_input; M5 is pb_case's flow input), built
# on the port's copy of the DME case so that scripts need no tests/
# import.

import numpy as np

from rmt_tpu_torch.cases import pb_case
from rmt_tpu_torch.cases.dme_case import make_model_input

# the particle's gas diffusivities [m^2/s] and film mass-transfer
# coefficients [m/s] of the reference's particle tests
GA_DII = np.array([6.61512999110972e-06, 2.12995183554984e-06,
                   1.39108654241678e-06, 2.20809430865725e-06,
                   9.64429037148681e-07, 8.74374373632434e-07])
MA_TR_CO = np.array([0.0273301866548795, 0.0149179341780856,
                     0.0108707796723462, 0.0157945517381349,
                     0.0104869502041277, 0.00898673624257253])


def t1_model_input():
    """T1: the dynamic particle over a 5 s period, feed in kmol/m^3, the
    frozen film coefficients and bulk state in test-const, FDM."""
    mi = make_model_input(model="T1", op_period=5.0)
    mi["feed"]["concentration"] = np.asarray(mi["feed"]["concentration"]) / 1e3
    mi["feed"]["diffusivity"] = GA_DII
    mi["feed"]["mixture-thermal-conductivity"] = 0.125
    mi["reactor"].update({"CaPo": 0.45, "CaTo": 2.0, "CaThCo": 12.6,
                          "BeVoFr": 0.39, "CaSpHeCa": 0.96})
    mi["test-const"] = {
        "MaTrCo0": MA_TR_CO, "HeTrCo0": 1731.0,
        "Cbi": np.asarray(mi["feed"]["concentration"]), "Tb": 523.0,
        "numerical-method": "fdm",
    }
    return mi


def t2_model_input(method=None):
    """T2: the steady particle (feed in mol/m^3); method "oc" or "fem"
    sets solver-config numerical-method (default: FDM)."""
    mi = make_model_input(model="T2")
    mi["feed"]["superficial-velocity"] = 0.2
    mi["reactor"].update({"CaPo": 0.87, "CaTo": 2.0, "CaThCo": 960.0,
                          "BeVoFr": 0.45, "CaSpHeCa": 960.0})
    if method is not None:
        mi["solver-config"]["numerical-method"] = method
    return mi


def _dispersion_model_input(model):
    mi = make_model_input(model=model)
    # the feed concentrations are kmol/m^3 (homoModels.py:109)
    mi["feed"]["concentration"] = np.asarray(mi["feed"]["concentration"]) / 1e3
    mi["feed"]["superficial-velocity"] = 0.2
    mi["feed"]["diffusivity"] = GA_DII
    mi["feed"]["mixture-thermal-conductivity"] = 0.125
    mi["feed"]["mixture-viscosity"] = 2.51e-5
    mi["reactor"].update({"CaPo": 0.45, "CaTo": 2.0, "CaThCo": 12.6})
    mi["solver-config"].update({"root": "fsolve", "mesh": "normal"})
    return mi


def t3_model_input(mesh="normal"):
    """T3: the axial-dispersion model at its default zNo 10, or on the
    two-zone mesh (mesh other than "normal")."""
    mi = _dispersion_model_input("T3")
    mi["solver-config"]["mesh"] = mesh
    return mi


def m14_model_input(z_no=None, ramp_list=None, mesh="normal"):
    """M14: the steady heterogeneous bed at its default zNo 30 unless z_no
    is given, with an optional rampList, or on the two-zone mesh."""
    mi = _dispersion_model_input("M14")
    mi["solver-config"]["mesh"] = mesh
    if z_no is not None:
        mi["solver-config"]["zNo"] = z_no
    if ramp_list is not None:
        mi["solver-config"]["rampList"] = list(ramp_list)
    return mi


def model_input(model):
    """The input above for T1, T2, T3, M5 or M14 at its default grid."""
    return {"T1": t1_model_input, "T2": t2_model_input,
            "T3": t3_model_input, "M14": m14_model_input,
            "M5": lambda: pb_case.flow_model_input("M5")}[model]()
