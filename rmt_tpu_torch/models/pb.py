# Packed-bed reactor models in dimensional variables (port of
# rmt_tpu/models/pb.py): M1 (steady, molar-flow variables), M2 (dynamic
# MoL, concentration variables), the concentration-based steady models of
# the reference ids M7 (m3_*) and M8 (m4_*), and M9 (dynamic MoL with
# coupled pressure and velocity marches).
#
# Same math and units as rmt_tpu, quirks included (each marked QUIRK with
# the reference line it mirrors). The explicit axial marches, a lax.scan
# in rmt_tpu, are a loop over the nodes here. The dynamic RHS (M2, M9)
# takes a state (..., n) with any leading batch dimensions, so the
# lockstep integrator evaluates all members and stages in one call; the
# steady ones take one state (n,).

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from .. import config
from ..constants import EPS_CONST, PI_CONST, R_CONST
from ..data import species as DB
from ..kinetics.dsl import RateProgram
from ..kinetics.stoich import Stoichiometry
from ..props import thermo
from ..utils.tables import DeviceTables
from .homo import _reaction_energetics


@dataclass(frozen=True)
class PBSpec:
    comp_list: tuple[str, ...]
    stoich: Stoichiometry = field(hash=False, compare=False)
    rates: RateProgram = field(hash=False, compare=False)
    z_out: int = 25          # solverSetting['S3']['timesNo']
    z_no: int = 100          # M2 axial nodes (solverSetting['S2']['zNo'])
    t_no: int = 10           # M2 outer time intervals
    times_no: int = 5

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)


def build_spec(model_input: Mapping[str, Any], **overrides) -> PBSpec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    return PBSpec(
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
    card; without one, a call that names no device raises, see
    config.resolve_device)."""
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

    out = {
        "P0": f(oc["pressure"]),
        "T0": f(oc["temperature"]),
        "opT": f(oc.get("period", 1.0)),
        "GaMiVi": f(feed["mixture-viscosity"]),
        "U": f(ex_he["OvHeTrCo"]),
        "EfHeTrAr": f(ex_he["EfHeTrAr"]),
        "Tm": f(ex_he["MeTe"]),
        "ReInDi": f(re_spec["ReInDi"]),
        "ReLe": f(re_spec["ReLe"]),
        "PaDi": f(re_spec["PaDi"]),
        "BeVoFr": f(re_spec["BeVoFr"]),
        "CaBeDe": f(re_spec["CaBeDe"]),
        "CaDe": f(re_spec.get("CaDe", 0.0)),
        "CaSpHeCa": f(re_spec.get("CaSpHeCa", 0.0)),
        "kinetic_overrides": {
            k: f(v) for k, v in model_input.get("kinetic-overrides", {}).items()
        },
    }
    # M1 feed: mole-fraction + molar flowrate; M2 feed: volumetric flowrate
    # + concentration [kmol/m^3] (reference pbReactor.py:191-193, 609-611)
    if "mole-fraction" in feed:
        out["MoFri0"] = f(feed["mole-fraction"])
        out["MoFlRa0"] = f(feed["molar-flowrate"])
    if "concentration" in feed:
        out["SpCoi0"] = f(feed["concentration"])
        out["VoFlRa0"] = f(feed["volumetric-flowrate"])
    return out


def _tables(spec: PBSpec) -> DeviceTables:
    """The stoichiometric matrix and the molecular weights a RHS reads."""
    return DeviceTables(nu=spec.stoich.nu_comp, mw=DB.MW[spec.comp_idx])


def _ergun(p, su_ga_ve, ga_de):
    """Ergun pressure gradient dP/dz [Pa/m]."""
    eps = p["BeVoFr"]
    erg_a = 150 * p["GaMiVi"] * su_ga_ve / p["PaDi"] ** 2
    erg_b = (1 - eps) ** 2 / eps**3
    erg_c = 1.75 * ga_de * su_ga_ve**2 / p["PaDi"]
    erg_d = (1 - eps) / eps**3
    return -(erg_a * erg_b + erg_c * erg_d)


def m1_initial_state(spec: PBSpec, p):
    cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
    fi0 = p["MoFlRa0"] * p["MoFri0"]
    flux0 = p["MoFlRa0"] / cr_se_ar
    return torch.cat([fi0, flux0[None], p["T0"][None], p["P0"][None]])


def make_m1_rhs(spec: PBSpec):
    """Steady flow-variable RHS (reference modelEquationM1,
    pbReactor.py:354-547)."""
    idx = spec.comp_idx
    n_comp = spec.n_comp
    tables = _tables(spec)

    def rhs(z, y, p):
        tb = tables(y)
        nu_comp, mw = tb["nu"], tb["mw"]
        cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
        fi = y[:n_comp]
        flux = y[n_comp]
        T = y[n_comp + 1]
        P = y[n_comp + 2]

        vo_fl = thermo.volumetric_flowrate_ig(P, T, fi)
        conc = fi / vo_fl
        conc_tot = torch.sum(conc)
        mo_fri = conc / conc_tot

        # velocity from the EOS using the molar flux state
        in_ga_ve = flux * T * R_CONST / P
        su_ga_ve = in_ga_ve * p["BeVoFr"]

        mi_mo_we = thermo.mixture_molecular_weight(mo_fri, mw, "kg/mol")
        ga_de = thermo.density_ig(mi_mo_we, conc_tot)
        dP = _ergun(p, su_ga_ve, ga_de)

        r0 = spec.rates(T, P, mo_fri, conc, p["kinetic_overrides"])
        ri = r0 @ nu_comp
        ov_r = torch.sum(ri)

        cp_mix = thermo.cp_mix(mo_fri, thermo.cp_mean(T, idx))
        ov_he_re_t = torch.dot(r0, _reaction_energetics(spec, T))
        qm = torch.where(p["Tm"] == 0, torch.zeros_like(T),
                         p["U"] * (4 / p["ReInDi"]) * (p["Tm"] - T))

        dF = cr_se_ar * ri
        dT = (-ov_he_re_t + qm) / (flux * cp_mix)
        return torch.cat([dF, ov_r[None], dT[None], dP[None]])

    return rhs


def m2_initial_state(spec: PBSpec, p):
    """Uniform fields at feed values (reference pbReactor.py:640-653)."""
    ones = torch.ones((1, spec.z_no), dtype=p["T0"].dtype,
                      device=p["T0"].device)
    c0 = p["SpCoi0"][:, None] * ones
    t0 = p["T0"] * ones
    return torch.cat([c0, t0], dim=0).reshape(-1)


def _mol_fields(spec: PBSpec, y, mw):
    """The MoL state (..., (n_comp + 1) * z_no) split into the raw and
    clamped concentrations (..., n_comp, z_no), the temperatures (...,
    z_no), the total concentration, the mole fractions and the mixture
    molecular weight (..., z_no) [kg/mol]."""
    n_comp = spec.n_comp
    Y = y.reshape(y.shape[:-1] + (n_comp + 1, spec.z_no))
    c_raw = Y[..., :n_comp, :]
    # QUIRK: concentrations are clamped at EPS for the source/kinetics
    # path but the raw center value feeds the convection stencil
    c_clamped = torch.clamp(c_raw, min=EPS_CONST)
    T_z = Y[..., n_comp, :]
    co_sp = torch.sum(c_clamped, dim=-2)
    mo_fri = c_clamped / co_sp[..., None, :]
    mi_mo_we = thermo.mixture_molecular_weight(mo_fri.transpose(-1, -2), mw,
                                               "kg/mol")
    return c_raw, c_clamped, T_z, co_sp, mo_fri, mi_mo_we


def _axial_rates(spec, p, T, P, mo_fri, conc):
    """The kinetics at every node: T, P (..., z); mo_fri, conc (...,
    n_comp, z) -> (..., n_rxn, z)."""
    r = spec.rates(T, P, mo_fri.movedim(-2, 0), conc.movedim(-2, 0),
                   p["kinetic_overrides"])
    return r.movedim(0, -2)


def _mol_balances(spec, p, tables, y, c_raw, c_clamped, T_z, co_sp, mo_fri,
                  v_z, r0, c_sink):
    """The MoL time derivatives of M2 and M9 from their velocity field v_z
    (..., z), rates r0 (..., n_rxn, z) [kmol/m^3.s] and the extra
    concentration sink c_sink (M9's -C dv/dz, or None)."""
    nu_comp = tables(y)["nu"]
    dz = p["ReLe"] / (spec.z_no - 1)
    eps = p["BeVoFr"]
    ri = torch.einsum("mk,...mz->...kz", nu_comp, r0)
    cp_mean_i = thermo.cp_mean(T_z, spec.comp_idx)       # (..., z, n_comp)
    cp_mix = torch.sum(mo_fri.transpose(-1, -2) * cp_mean_i, dim=-1)
    he_re_t = _reaction_energetics(spec, T_z)
    ov_he_re_t = torch.sum(r0.transpose(-1, -2) * he_re_t, dim=-1)
    # QUIRK: M2/M9 use the user-provided EfHeTrAr (not 4/D) and kJ units
    qm = torch.where(p["Tm"] == 0, torch.zeros_like(T_z),
                     1e-3 * p["U"] * p["EfHeTrAr"] * (p["Tm"] - T_z))

    mo_fl = co_sp * v_z                                  # [kmol/m^2.s]
    const_f1 = 1 / eps
    const_t1 = mo_fl * cp_mix
    const_t2 = 1 / (co_sp * cp_mix * eps
                    + (1 - eps) * p["CaDe"] * p["CaSpHeCa"])

    c_in = p["SpCoi0"][:, None].expand(c_raw.shape[:-1] + (1,))
    c_back = torch.cat([c_in, c_clamped[..., :-1]], dim=-1)
    dcdz = (c_raw - c_back) / dz
    adv = -v_z[..., None, :] * dcdz
    if c_sink is not None:
        adv = adv - c_sink
    dxdt_c = const_f1 * (adv + ri)

    t_back = torch.cat([p["T0"].expand(T_z.shape[:-1] + (1,)),
                        T_z[..., :-1]], dim=-1)
    dtdz = (T_z - t_back) / dz
    dxdt_t = const_t2 * (-const_t1 * dtdz + (-ov_he_re_t + qm))
    return torch.cat([dxdt_c, dxdt_t[..., None, :]], dim=-2).reshape(
        y.shape)


def make_m2_rhs(spec: PBSpec, frozen_pressure_jac: bool = False):
    """Dynamic MoL RHS in dimensional variables [kmol/m^3, K] (reference
    modelEquationM2, pbReactor.py:845-1165), vectorized over the axial
    nodes with a loop over them for the explicit pressure march.

    frozen_pressure_jac detaches the pressure/velocity march for the
    block-bidiagonal stage-solve Jacobian."""
    z_no = spec.z_no
    tables = _tables(spec)

    def rhs(t, y, p):
        mw = tables(y)["mw"]
        dz = p["ReLe"] / (z_no - 1)
        cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
        eps = p["BeVoFr"]
        sp_co0 = torch.sum(p["SpCoi0"])
        in_ga_ve0 = p["VoFlRa0"] / (cr_se_ar * eps)
        c_raw, c_clamped, T_z, co_sp, mo_fri, mi_mo_we = _mol_fields(
            spec, y, mw)

        # pressure march: the velocity from the EOS depends on the
        # marching P
        co_sp_m = co_sp.detach() if frozen_pressure_jac else co_sp
        mi_mo_we_m = mi_mo_we.detach() if frozen_pressure_jac else mi_mo_we
        erg_b = (1 - eps) ** 2 / eps**3
        erg_d = (1 - eps) / eps**3
        # the node-wise factors of the march, formed as rmt_tpu's scan body
        # forms them (the same roundings)
        q_z = in_ga_ve0 * (co_sp_m / sp_co0)
        ga_de_z = 1.75 * (mi_mo_we_m * co_sp_m)          # calDensityIG, kmol
        erg_a0 = 150 * p["GaMiVi"]
        pd2 = p["PaDi"] ** 2
        P = p["P0"].expand(co_sp.shape[:-1])
        P_list = []
        for z in range(z_no):
            P_list.append(P)
            su_ga_ve = q_z[..., z] * (p["P0"] / P) * eps
            erg_a = erg_a0 * su_ga_ve / pd2
            erg_c = ga_de_z[..., z] * su_ga_ve**2 / p["PaDi"]
            P = P + (-(erg_a * erg_b + erg_c * erg_d)) * dz
        P_z = torch.stack(P_list, dim=-1)
        # the velocity used in convection follows the *unfrozen*
        # concentration
        in_ga_ve_z = in_ga_ve0 * (co_sp / sp_co0) * (p["P0"] / P_z)
        su_ga_ve_z = in_ga_ve_z * eps

        # kinetics: concentrations in mol/m^3, rates scaled back to kmol
        r0 = 1e-3 * _axial_rates(spec, p, T_z, P_z, mo_fri, 1e3 * c_clamped)
        return _mol_balances(spec, p, tables, y, c_raw, c_clamped, T_z,
                             co_sp, mo_fri, su_ga_ve_z, r0, None)

    return rhs


def m3_initial_state(spec: PBSpec, p):
    """IV for the concentration-based steady model (reference id M7;
    pbReactor.py:1243-1248)."""
    return torch.cat([p["SpCoi0"], p["T0"][None], p["P0"][None]])


def make_m3_rhs(spec: PBSpec):
    """Concentration-based steady RHS (reference id M7, modelEquationM3,
    pbReactor.py:1371-1575): state (Ci [mol/m^3], T, P), velocity from the
    EOS, Ergun pressure drop, Qm without the adiabatic rule."""
    idx = spec.comp_idx
    n_comp = spec.n_comp
    tables = _tables(spec)

    def rhs(z, y, p):
        tb = tables(y)
        nu_comp, mw = tb["nu"], tb["mw"]
        cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
        eps = p["BeVoFr"]
        sp_co0 = torch.sum(p["SpCoi0"])
        in_ga_ve0 = p["VoFlRa0"] / (cr_se_ar * eps)

        conc = y[:n_comp]
        T = y[n_comp]
        P = y[n_comp + 1]
        co_sp = torch.sum(conc)
        mo_fri = conc / co_sp

        in_ga_ve = in_ga_ve0 * (co_sp / sp_co0) * (p["P0"] / P)
        su_ga_ve = in_ga_ve * eps
        mo_fl = co_sp * su_ga_ve

        mi_mo_we = thermo.mixture_molecular_weight(mo_fri, mw, "kg/mol")
        ga_de = thermo.density_ig(mi_mo_we, co_sp)
        dP = _ergun(p, su_ga_ve, ga_de)

        r0 = spec.rates(T, P, mo_fri, conc, p["kinetic_overrides"])
        ri = r0 @ nu_comp

        cp_mix = thermo.cp_mix(mo_fri, thermo.cp_mean(T, idx))
        ov_he_re_t = torch.dot(r0, _reaction_energetics(spec, T))
        qm = p["U"] * p["EfHeTrAr"] * (p["Tm"] - T)

        dC = ri / su_ga_ve
        dT = (-ov_he_re_t + qm) / (mo_fl * cp_mix)
        return torch.cat([dC, dT[None], dP[None]])

    return rhs


def m4_initial_state(spec: PBSpec, p):
    """IV for the velocity-resolved steady model (reference id M8;
    pbReactor.py:1650-1665)."""
    cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
    su_ga_ve0 = p["VoFlRa0"] / cr_se_ar
    return torch.cat(
        [p["SpCoi0"], p["T0"][None], p["P0"][None], su_ga_ve0[None]])


def make_m4_rhs(spec: PBSpec):
    """Concentration-based steady RHS with a velocity ODE (reference id M8,
    modelEquationM4, pbReactor.py:1778-1995): dv/dz from the differentiated
    EOS, mass balance with the -Ci*dv/dz expansion term."""
    idx = spec.comp_idx
    n_comp = spec.n_comp
    tables = _tables(spec)

    def rhs(z, y, p):
        tb = tables(y)
        nu_comp, mw = tb["nu"], tb["mw"]
        conc = y[:n_comp]
        T = y[n_comp]
        P = y[n_comp + 1]
        su_ga_ve = y[n_comp + 2]
        co_sp = torch.sum(conc)
        mo_fri = conc / co_sp
        mo_fl = co_sp * su_ga_ve

        mi_mo_we = thermo.mixture_molecular_weight(mo_fri, mw, "kg/mol")
        ga_de = thermo.density_ig(mi_mo_we, co_sp)
        dP = _ergun(p, su_ga_ve, ga_de)

        r0 = spec.rates(T, P, mo_fri, conc, p["kinetic_overrides"])
        ri = r0 @ nu_comp
        ov_r = torch.sum(ri)

        cp_mix = thermo.cp_mix(mo_fri, thermo.cp_mean(T, idx))
        ov_he_re_t = torch.dot(r0, _reaction_energetics(spec, T))
        qm = p["U"] * p["EfHeTrAr"] * (p["Tm"] - T)

        dT = (-ov_he_re_t + qm) / (mo_fl * cp_mix)
        dv = (1 / co_sp) * (
            (-su_ga_ve / R_CONST) * ((1 / T) * dP - (P / T**2) * dT) + ov_r
        )
        dC = (-conc * dv + ri) / su_ga_ve
        return torch.cat([dC, dT[None], dP[None], dv[None]])

    return rhs


def m9_initial_state(spec: PBSpec, p):
    """Uniform fields at feed values (reference runM5,
    pbReactor.py:2090-2103)."""
    return m2_initial_state(spec, p)


def make_m9_rhs(spec: PBSpec, frozen_march_jac: bool = False):
    """Dynamic concentration-based MoL RHS with coupled explicit pressure
    AND velocity marches (reference id M9, modelEquationM5,
    pbReactor.py:2296-2660). The velocity update needs the local reaction
    rates, so the kinetics evaluate inside the axial loop. Quirks kept:
    kinetics receive kmol/m^3 concentrations without unit conversion; the
    velocity equation mixes a x1000 CoSp with a x1000 OvR."""
    z_no = spec.z_no
    tables = _tables(spec)

    def rhs(t, y, p):
        tb = tables(y)
        nu_comp, mw = tb["nu"], tb["mw"]
        dz = p["ReLe"] / (z_no - 1)
        cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
        eps = p["BeVoFr"]
        in_ga_ve0 = p["VoFlRa0"] / (cr_se_ar * eps)
        su_ga_ve0 = in_ga_ve0 * eps
        c_raw, c_clamped, T_z, co_sp, mo_fri, mi_mo_we = _mol_fields(
            spec, y, mw)

        t_back = torch.cat([p["T0"].expand(T_z.shape[:-1] + (1,)),
                            T_z[..., :-1]], dim=-1)
        dtdz = (T_z - t_back) / dz

        march_in = (co_sp, mi_mo_we, mo_fri, c_clamped, T_z, dtdz)
        if frozen_march_jac:
            march_in = tuple(x.detach() for x in march_in)
        co_sp_m, mi_mo_we_m, mo_fri_m, c_m, T_m, dtdz_m = march_in

        erg_b = (1 - eps) ** 2 / eps**3
        erg_d = (1 - eps) / eps**3
        P = p["P0"].expand(co_sp.shape[:-1])
        v = su_ga_ve0.expand(co_sp.shape[:-1])
        P_l, v_l, dv_l, r_l = [], [], [], []
        for z in range(z_no):
            co_sp_z, T_zz = co_sp_m[..., z], T_m[..., z]
            ga_de = mi_mo_we_m[..., z] * co_sp_z
            erg_a = 150 * p["GaMiVi"] * v / p["PaDi"] ** 2
            erg_c = 1.75 * ga_de * v**2 / p["PaDi"]
            dP = -(erg_a * erg_b + erg_c * erg_d)
            # kinetics at the marching pressure (kmol in, unconverted)
            r0 = spec.rates(T_zz, P, mo_fri_m[..., z].movedim(-1, 0),
                            c_m[..., z].movedim(-1, 0),
                            p["kinetic_overrides"])          # (n_rxn, ...)
            ov_r = torch.sum(torch.einsum("m...,mk->...k", r0, nu_comp),
                             dim=-1)
            dv = (1 / (co_sp_z * 1000)) * (
                (-v / R_CONST) * ((1 / T_zz) * dP
                                  - (P / T_zz**2) * dtdz_m[..., z])
                + ov_r * 1000
            )
            P_l.append(P)
            v_l.append(v)
            dv_l.append(dv)
            r_l.append(r0.movedim(0, -1))
            P, v = P + dP * dz, v + dv * dz
        P_z, v_z, dv_z = (torch.stack(a, dim=-1) for a in (P_l, v_l, dv_l))
        if frozen_march_jac:
            # re-evaluate the kinetics outside the (gradient-frozen) march
            # so the stage-solve Jacobian keeps the local reaction
            # couplings while staying block-bidiagonal
            r0 = _axial_rates(spec, p, T_z, P_z.detach(), mo_fri, c_clamped)
        else:
            r0 = torch.stack(r_l, dim=-1)                     # (..., n_rxn, z)
        return _mol_balances(spec, p, tables, y, c_raw, c_clamped, T_z,
                             co_sp, mo_fri, v_z, r0,
                             c_raw * dv_z[..., None, :])

    return rhs
