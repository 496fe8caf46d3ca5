# Model inputs of the packed-bed, plug-flow and batch models (M0-M9) on
# the DME case: the inputs rmt_tpu's own tests give these models
# (tests/test_pb_pf.py::_flow_model_input, tests/test_m789.py::
# _conc_model_input, tests/test_m2.py::_m2_model_input), built on the
# port's copy of the DME case so that scripts need no tests/ import.

import numpy as np

from rmt_tpu_torch.cases.dme_case import feed_mole_fraction, make_model_input

# the feed numbers those tests add to the DME case
MOLAR_FLOWRATE = 0.26          # [mol/s]
MIXTURE_VISCOSITY = 2.51e-5    # [Pa.s]


def flow_model_input(model):
    """M0, M1, M4: the DME case fed by mole fraction and molar flowrate."""
    mi = make_model_input(model=model)
    mi["feed"]["mole-fraction"] = np.asarray(feed_mole_fraction(),
                                             dtype=np.float64)
    mi["feed"]["molar-flowrate"] = MOLAR_FLOWRATE
    mi["feed"]["mixture-viscosity"] = MIXTURE_VISCOSITY
    return mi


def conc_model_input(model, kmol=False):
    """M7, M8 (mol/m^3) and M9 (kmol=True: kmol/m^3): the DME case fed by
    concentration."""
    mi = make_model_input(model=model)
    if kmol:
        mi["feed"]["concentration"] = np.asarray(
            mi["feed"]["concentration"]) / 1e3
    mi["feed"]["mixture-viscosity"] = MIXTURE_VISCOSITY
    return mi


def m2_model_input(z_no=None):
    """M2: the DME case with the feed in kmol/m^3 (the reference's units
    for M2), at the default grid (zNo 100, tNo 10) unless z_no is given."""
    mi = conc_model_input("M2", kmol=True)
    if z_no is not None:
        mi["solver-config"]["zNo"] = z_no
    return mi


def batch_model_input():
    """M3: the DME case as rmt_tpu's make_model_input(model="M3") gives
    it."""
    return make_model_input(model="M3")


def model_input(model):
    """The input above for any of M0-M4 and M7-M9 (M2 and M9 at the
    default grid)."""
    if model in ("M0", "M1", "M4"):
        return flow_model_input(model)
    if model in ("M7", "M8"):
        return conc_model_input(model)
    if model == "M9":
        return conc_model_input(model, kmol=True)
    if model == "M3":
        return batch_model_input()
    return m2_model_input()
