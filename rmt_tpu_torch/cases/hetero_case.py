# Model inputs of the particle, axial-dispersion and heterogeneous models
# (T1, T2, T3, M5, M14 and the dynamic M10-M13) on the DME case: the inputs
# rmt_tpu's own tests give these models (tests/test_particle.py::
# _t1_model_input and _t2_model_input, tests/test_t3.py::_t3_model_input,
# tests/test_m14.py::_m14_model_input, tests/test_m13.py::_m13_model_input
# and its M10, M11 and M12 variants; M5 is pb_case's flow input), built on
# the port's copy of the DME case so that scripts need no tests/ import.

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


def dyn_model_input(model="M13", grid=None, period=None):
    """M10, M11, M12 or M13: the dynamic heterogeneous bed over a 5 s
    period (feed in kmol/m^3, FDM particle for M11/M13), each model at its
    default grid unless grid (solver-config zNo/rNo/tNo) or period is
    given."""
    mi = make_model_input(model="M13", op_period=5.0)
    mi["model"] = model
    mi["operating-conditions"]["numerical-method"] = "fdm"
    mi["feed"]["concentration"] = np.asarray(mi["feed"]["concentration"]) / 1e3
    mi["feed"]["superficial-velocity"] = 0.2
    mi["feed"]["diffusivity"] = GA_DII
    mi["feed"]["viscosity"] = np.full(6, 2.51e-5)
    mi["feed"]["mixture-viscosity"] = 2.51e-5
    mi["feed"]["thermal-conductivity"] = np.full(6, 0.125)
    mi["feed"]["mixture-thermal-conductivity"] = 0.125
    mi["reactor"].update({"CaPo": 0.45, "CaTo": 2.0, "CaThCo": 12.6})
    mi["solver-config"].update({"root": "fsolve", "mesh": "normal"})
    if grid:
        mi["solver-config"].update(grid)
    if period is not None:
        mi["operating-conditions"]["period"] = period
    return mi


def m12_physical_resume(z_no):
    """M12's resume-state at the physical startup state (the feed at every
    (r, z) node, theta = 0; rNo + 1 = 8 rows), as rmt_tpu's
    tests/test_m12.py starts its end-to-end run: the reference's 1e-6
    seed is singular."""
    mi = dyn_model_input("M12")
    c_in = np.asarray(mi["feed"]["concentration"], np.float64)
    c_in = c_in / np.max(c_in)
    y0 = np.concatenate([np.tile(c_in[:, None, None], (1, 8, z_no)),
                         np.zeros((1, 8, z_no))], axis=0).reshape(-1)
    return {"model": "M12", "t": 0.0, "state": y0}


def model_input(model):
    """The input above for T1, T2, T3, M5 or M14 at its default grid."""
    return {"T1": t1_model_input, "T2": t2_model_input,
            "T3": t3_model_input, "M14": m14_model_input,
            "M5": lambda: pb_case.flow_model_input("M5")}[model]()
