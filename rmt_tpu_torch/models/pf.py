# Plug-flow reactor model, reference ids M0/M4 (port of
# rmt_tpu/models/pf.py).
#
# State: component molar flowrates Fi [mol/s] + temperature T [K],
# integrated along the reactor length [m]; no pressure drop. Like rmt_tpu
# it implements the reference's intended equations (PyREMOT/docs/
# pfReactor.py:54-390, whose RHS reads FunParam keys its runner never
# supplies).

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from .. import config
from ..constants import PI_CONST
from ..data import species as DB
from ..kinetics.dsl import RateProgram
from ..kinetics.stoich import Stoichiometry
from ..props import thermo
from .homo import _reaction_energetics


@dataclass(frozen=True)
class PFSpec:
    comp_list: tuple[str, ...]
    stoich: Stoichiometry = field(hash=False, compare=False)
    rates: RateProgram = field(hash=False, compare=False)
    z_out: int = 100

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)


def build_spec(model_input: Mapping[str, Any], **overrides) -> PFSpec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    return PFSpec(
        comp_list=comp_list,
        stoich=Stoichiometry(model_input["reactions"], comp_list),
        rates=RateProgram(
            model_input["reaction-rates"]["VARS"],
            model_input["reaction-rates"]["RATES"],
        ),
        **overrides,
    )


def build_params(model_input: Mapping[str, Any], dtype=None,
                 device=None) -> dict[str, Any]:
    """Numeric parameter dict of tensors on ``device`` (default: the CUDA
    card; see config.resolve_device)."""
    dtype = dtype or config.default_float()
    device = config.resolve_device(device)
    oc = model_input["operating-conditions"]
    feed = model_input["feed"]
    re_spec = model_input["reactor"]
    ex_he = model_input.get(
        "external-heat", {"OvHeTrCo": 0.0, "EfHeTrAr": 0.0, "MeTe": 0.0})

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    return {
        "P0": f(oc["pressure"]),
        "T0": f(oc["temperature"]),
        "MoFri0": f(feed["mole-fraction"]),
        "MoFlRa0": f(feed["molar-flowrate"]),
        "U": f(ex_he["OvHeTrCo"]),
        "Tm": f(ex_he["MeTe"]),
        "ReInDi": f(re_spec["ReInDi"]),
        "ReLe": f(re_spec["ReLe"]),
        "kinetic_overrides": {
            k: f(v) for k, v in model_input.get("kinetic-overrides", {}).items()
        },
    }


def initial_state(spec: PFSpec, p):
    return torch.cat([p["MoFlRa0"] * p["MoFri0"], p["T0"][None]])


def make_rhs(spec: PFSpec):
    """RHS over reactor length z [m] (reference: pfReactor.py:219-390)."""
    idx = spec.comp_idx
    n_comp = spec.n_comp

    def rhs(z, y, p):
        nu_comp = torch.as_tensor(spec.stoich.nu_comp, dtype=y.dtype,
                                  device=y.device)
        cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
        fi = y[:n_comp]
        T = y[n_comp]
        P = p["P0"]                            # no pressure drop

        f_tot = torch.sum(fi)
        vo_fl = thermo.volumetric_flowrate_ig(P, T, fi)
        conc = fi / vo_fl
        mo_fri = conc / torch.sum(conc)

        r0 = spec.rates(T, P, mo_fri, conc, p["kinetic_overrides"])
        ri = r0 @ nu_comp

        cp_mix = thermo.cp_mix(mo_fri, thermo.cp_mean(T, idx))
        ov_he_re_t = torch.dot(r0, _reaction_energetics(spec, T))
        qm = p["U"] * (4 / p["ReInDi"]) * (p["Tm"] - T)

        dF = cr_se_ar * ri
        dT = (cr_se_ar / (f_tot * cp_mix)) * (-ov_he_re_t + qm)
        return torch.cat([dF, dT[None]])

    return rhs
