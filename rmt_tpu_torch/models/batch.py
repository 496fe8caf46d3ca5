# Batch reactor model, reference id M3 (port of rmt_tpu/models/batch.py).
#
# The reference's batchReactorClass.runM3 is a stub (PyREMOT/docs/
# batchReactor.py:57); like rmt_tpu this implements the well-mixed batch
# balance the stub advertises: dCi/dt = ri(C, T), dT/dt =
# (-dHr*R + Qm)/(Ct*Cp) at constant volume, with the ideal-gas pressure
# following temperature and composition.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from .. import config
from ..constants import R_CONST
from ..data import species as DB
from ..kinetics.dsl import RateProgram
from ..kinetics.stoich import Stoichiometry
from ..props import thermo
from .homo import _reaction_energetics


@dataclass(frozen=True)
class BatchSpec:
    comp_list: tuple[str, ...]
    iso_thermal: bool
    stoich: Stoichiometry = field(hash=False, compare=False)
    rates: RateProgram = field(hash=False, compare=False)
    t_out: int = 101

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)


def build_spec(model_input: Mapping[str, Any], **overrides) -> BatchSpec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    process_type = model_input["operating-conditions"].get(
        "process-type", "iso-thermal")
    return BatchSpec(
        comp_list=comp_list,
        iso_thermal=(process_type == "iso-thermal"),
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
    ex_he = model_input.get(
        "external-heat", {"OvHeTrCo": 0.0, "EfHeTrAr": 0.0, "MeTe": 0.0})

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    return {
        "P0": f(oc["pressure"]),
        "T0": f(oc["temperature"]),
        "opT": f(oc.get("period", 1.0)),
        "SpCoi0": f(feed["concentration"]),
        "U": f(ex_he["OvHeTrCo"]),
        "EfHeTrAr": f(ex_he["EfHeTrAr"]),
        "Tm": f(ex_he["MeTe"]),
        "kinetic_overrides": {
            k: f(v) for k, v in model_input.get("kinetic-overrides", {}).items()
        },
    }


def initial_state(spec: BatchSpec, p):
    if spec.iso_thermal:
        return p["SpCoi0"]
    return torch.cat([p["SpCoi0"], p["T0"][None]])


def make_rhs(spec: BatchSpec):
    idx = spec.comp_idx
    n_comp = spec.n_comp

    def rhs(t, y, p):
        conc = y[:n_comp]
        T = y[n_comp] if not spec.iso_thermal else p["T0"]
        co_sp = torch.sum(conc)
        mo_fri = conc / co_sp
        # ideal-gas pressure follows temperature/composition at constant V
        P = co_sp * R_CONST * T

        r0 = spec.rates(T, P, mo_fri, conc, p["kinetic_overrides"])
        ri = r0 @ torch.as_tensor(spec.stoich.nu_comp, dtype=y.dtype,
                                  device=y.device)
        out = [ri]
        if not spec.iso_thermal:
            cp_mix = thermo.cp_mix(mo_fri, thermo.cp_mean(T, idx))
            ov_he_re_t = torch.dot(r0, _reaction_energetics(spec, T))
            qm = torch.where(p["Tm"] == 0, torch.zeros_like(T),
                             p["U"] * p["EfHeTrAr"] * (p["Tm"] - T))
            dT = (-ov_he_re_t + qm) / (co_sp * cp_mix)
            out.append(dT[None])
        return torch.cat(out)

    return rhs
