# Dynamic heterogeneous packed beds M10-M13 (port of
# rmt_tpu/models/hetero_dyn.py), as plain functions on tensors.
#
# M13 (reference PackedBedHeteroReactorClass.runM2, PyREMOT/docs/
# pbHeterReactor.py:512-1220; gas RHS modelEquationM2 :1222-2165, solid
# residual modelEquationM3 :2167-2816): a gas-phase PDE (method of lines
# with axial dispersion and a Danckwerts inlet) coupled to a steady
# catalyst-particle BVP at every axial node through film transfer, by
# operator splitting. M11 (modelEquationM7, pbReactor.py:4389-5491) carries
# the FDM particle interior in the ODE state beside the gas row; M12
# (modelEquationM8, :6050-7181) does so on the 7-point orthogonal-
# collocation particle with a static algebraic interface; M10
# (modelEquationM6, :3053-3801) is that OC model in real units with live
# velocity and pressure marches. rmt_tpu's module documents every quirk it
# reproduces and every salvage of a reference path that cannot run; this
# port keeps them all, and its docstrings name them briefly.
#
# Layouts: the M13 gas state (n_comp+1, zNo), its solid state (n_layer,
# rNo, zNo) in radial STORAGE order (index 0 = gas-solid interface); the
# M10-M12 state (n_layer, rNo+1, zNo) with row 0 the gas phase. The
# particle rows of every node are computed together (the nodes on the last
# axis) where rmt_tpu maps one node's function over them with jax.vmap.
#
# The pressure and velocity marches are frozen for differentiation
# (.detach(), rmt_tpu's stop_gradient): the two-phase colored Jacobian
# (ops/jacobian.two_phase_coloring) assumes the gas rows couple nodes only
# through the tridiagonal stencils.
#
# make_m13_driver runs the split transient for a batch of members at once
# on the member-batched integrators (radau.odeint_batched,
# newton.root_batched with like_root), every member as rmt_tpu's driver
# runs it alone.

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch
from torch.func import vmap

from ..constants import EPS_CONST, PI_CONST, R_CONST
from ..data import species as DB
from ..kinetics.dsl import RateProgram
from ..kinetics.stoich import Stoichiometry
from ..ops import oc_particle, particle_fd
from ..props import film, thermo
from ..utils.tables import DeviceTables
from .hetero import _NO_HEAT, _params
from .homo import AxialStencil, _heat_exchange, _reaction_energetics


@dataclass(frozen=True)
class M13Spec:
    comp_list: tuple[str, ...]
    stoich: Stoichiometry = field(hash=False, compare=False)
    rates: RateProgram = field(hash=False, compare=False)
    z_no: int = 10        # solverSetting['T1']['zNo']
    r_no: int = 7         # solverSetting['T1']['rNo']['fdm']
    t_no: int = 5         # solverSetting['T1']['tNo']
    times_no: int = 5

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def n_layer(self) -> int:
        return self.n_comp + 1   # M10-M13 always carry the temperature layer

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)


def m13_build_spec(model_input: Mapping[str, Any], **overrides) -> M13Spec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    rr = model_input["reaction-rates"]
    return M13Spec(
        comp_list=comp_list,
        stoich=Stoichiometry(model_input["reactions"], comp_list),
        rates=RateProgram(rr["VARS"], rr["RATES"]),
        **overrides,
    )


def _with_overrides(model_input, p):
    p["kinetic_overrides"] = _params(model_input.get("kinetic-overrides", {}),
                                     p["T0"].dtype, p["T0"].device)
    return p


def m13_params(model_input: Mapping[str, Any], dtype=None,
               device=None) -> dict[str, Any]:
    """The parameter dict of M11, M12 and M13 as tensors on ``device``
    (default: the CUDA card; without one, a call that names no device
    raises, see config.resolve_device)."""
    oc = model_input["operating-conditions"]
    feed = model_input["feed"]
    re_spec = model_input["reactor"]
    ex_he = model_input.get("external-heat", _NO_HEAT)
    return _with_overrides(model_input, _params({
        "P0": oc["pressure"],
        "T0": oc["temperature"],
        "opT": oc.get("period", 1.0),
        "VoFlRa0": feed["volumetric-flowrate"],
        "SpCoi0": feed["concentration"],
        "vf": feed["superficial-velocity"],
        "GaDii0": feed["diffusivity"],
        "GaViMix0": feed["mixture-viscosity"],
        "GaThCoMix0": feed["mixture-thermal-conductivity"],
        "U": ex_he["OvHeTrCo"],
        "EfHeTrAr": ex_he["EfHeTrAr"],
        "Tm": ex_he["MeTe"],
        "ReInDi": re_spec["ReInDi"],
        "ReLe": re_spec["ReLe"],
        "PaDi": re_spec["PaDi"],
        "BeVoFr": re_spec["BeVoFr"],
        "CaBeDe": re_spec["CaBeDe"],
        "CaDe": re_spec["CaDe"],
        "CaSpHeCa": re_spec["CaSpHeCa"],
        "CaPo": re_spec["CaPo"],
        "CaTo": re_spec["CaTo"],
    }, dtype, device))


def m13_feed(spec: M13Spec, p: Mapping[str, Any]) -> dict[str, Any]:
    """Feed-state scales, dimensionless groups, and FIX-mode transfer
    coefficients (pbHeterReactor.py:647-958)."""
    idx = spec.comp_idx
    sp_coi0 = p["SpCoi0"]
    mw = torch.as_tensor(DB.MW[idx], dtype=sp_coi0.dtype,
                         device=sp_coi0.device)
    cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
    sp_co0 = torch.sum(sp_coi0)
    mo_fri0 = sp_coi0 / sp_co0
    mi_mo_we0 = thermo.mixture_molecular_weight(mo_fri0, mw, "kg/mol")
    ga_de0 = thermo.density_ig(mi_mo_we0, sp_co0 * 1000.0)
    cp_mean0 = thermo.cp_mean(p["T0"], idx)
    cp_mix0 = thermo.cp_mix(mo_fri0, cp_mean0)

    c_max = torch.max(sp_coi0)
    vf = p["vf"]
    zf = p["ReLe"]
    rf = p["PaDi"] / 2

    # MAX normalization mode (modelSetting.py GaMaCoTe0 == "MAX")
    ga_ma_co_te0 = (vf / zf) * c_max
    ga_he_co_te0 = (ga_de0 * vf * p["T0"] * (cp_mix0 / mi_mo_we0) / zf) * 1e-3
    so_ma_di_te0 = (p["GaDii0"] * c_max) / rf**2           # (n_comp,)
    so_he_di_te0 = (p["GaThCoMix0"] * p["T0"] / rf**2) * 1e-3
    pe_ma0 = vf * zf / p["GaDii0"]
    pe_he0 = zf * ga_de0 * (cp_mix0 / mi_mo_we0) * vf / p["GaThCoMix0"]

    re0 = film.reynolds(ga_de0, vf, p["PaDi"], p["GaViMix0"])
    sc0 = film.schmidt(ga_de0, p["GaViMix0"], p["GaDii0"])
    sh0 = film.sherwood(sc0, re0, film.FROSSLING)
    pr0 = film.prandtl(cp_mix0, p["GaViMix0"], p["GaThCoMix0"], mi_mo_we0)
    nu0 = film.nusselt(pr0, re0)
    ma_tr_co = film.mass_transfer_coefficient(sh0, p["GaDii0"], p["PaDi"])
    he_tr_co = film.heat_transfer_coefficient(nu0, p["GaThCoMix0"], p["PaDi"])

    sp_su_ar = (3 / rf) * (1 - p["BeVoFr"])
    # the RHS recomputes the velocity scale from the volumetric flowrate
    # (pbHeterReactor.py:1482-1484), which need not equal the user's vf
    su_ga_ve0 = p["VoFlRa0"] / cr_se_ar
    return {
        "mw": mw,
        "Cmax": c_max,
        "MiMoWe0": mi_mo_we0,
        "GaDe0": ga_de0,
        "GaCpMeanMix0": cp_mix0,
        "GaMaCoTe0": ga_ma_co_te0,
        "GaHeCoTe0": ga_he_co_te0,
        "SoMaDiTe0": so_ma_di_te0,
        "SoHeDiTe0": so_he_di_te0,
        "PeNuMa0": pe_ma0,
        "PeNuHe0": pe_he0,
        "MaTrCo": ma_tr_co,
        "HeTrCo": he_tr_co,
        "SpSuAr": sp_su_ar,
        "vDl": su_ga_ve0 / vf,
    }


def m13_gas_initial_state(spec: M13Spec, p):
    """Gas IV: 1e-6 dimensionless concentrations, theta = 0
    (pbHeterReactor.py:745-753)."""
    c0 = torch.full((spec.n_comp, spec.z_no), 1e-6, dtype=p["P0"].dtype,
                    device=p["P0"].device)
    return torch.cat([c0, torch.zeros_like(c0[:1])]).reshape(-1)


def m13_solid_initial_state(spec: M13Spec, p):
    """Solid IV: 1e-6 in every concentration layer, theta = 0
    (pbHeterReactor.py:755-765)."""
    y = torch.full((spec.n_comp, spec.r_no, spec.z_no), 1e-6,
                   dtype=p["P0"].dtype, device=p["P0"].device)
    return torch.cat([y, torch.zeros_like(y[:1])], dim=0)


def _clamp(c, width):
    """max(c, EPS) (width 0, the reference's clamp) or the smooth C^1 clamp
    0.5*(c + EPS + sqrt((c - EPS)^2 + width^2)) of rmt_tpu's refined-mesh
    driver."""
    if width > 0.0:
        return 0.5 * (c + EPS_CONST
                      + torch.sqrt((c - EPS_CONST) ** 2 + width**2))
    return torch.clamp(c, min=EPS_CONST)


def _gas_phase(spec: M13Spec, ax: AxialStencil, p, d, c_raw, T_dl, cs_surf,
               ts_surf, flux_sign=-1.0, clamp_width=0.0):
    """The gas-phase balances shared by the coupled dynamic heterogeneous
    models (M13's modelEquationM2; M11/M12's gas rows, pbReactor.py:
    5119-5451 and 6846-7065): BD convection + CD dispersion with a
    Danckwerts inlet ghost and a zero-gradient outlet (stencils on the RAW
    state, ax's mesh), film exchange against the solid-surface values
    cs_surf (n_comp, zNo) and ts_surf (zNo,), entering the species balance
    with flux_sign. Returns (dcdt (n_comp, zNo), dtdt (zNo,), ga_de)."""
    idx = spec.comp_idx
    eps = p["BeVoFr"]

    c_cl = _clamp(c_raw, clamp_width)
    c_re = c_cl * d["Cmax"]
    co_sp_re = torch.sum(c_re, dim=0)
    T_re = T_dl * p["T0"] + p["T0"]
    mo_fri = c_re / co_sp_re                       # (n_comp, zNo)

    mi_mo_we = thermo.mixture_molecular_weight(mo_fri.T, d["mw"], "kg/mol")
    ga_de = thermo.density_ig(mi_mo_we, co_sp_re * 1000.0)
    ga_de_dl = ga_de / d["GaDe0"]

    cp_mean = thermo.cp_mean(T_re, idx)            # (zNo, n_comp)
    cp_mix = torch.sum(mo_fri.T * cp_mean, dim=-1)
    cp_dl = cp_mix / d["GaCpMeanMix0"]

    # Qm in kJ/m^3.s; Tm == 0 means adiabatic (rmtUtility.py:437-444)
    qm = _heat_exchange(p["Tm"], T_re, p["U"], p["EfHeTrAr"]) * 1e-3

    # interphase film flux on the RAW gas state (pbHeterReactor.py:1798)
    mo_fli = d["MaTrCo"][:, None] * d["Cmax"] * (c_raw - cs_surf)

    dcdz, d2c = ax.derivatives(c_raw, ax.mass_ghost(p, d, c_raw))
    conv_c = -d["vDl"] * dcdz
    disp_c = (eps / d["PeNuMa0"])[:, None] * d2c   # GaDii_DiLeVa = 1
    flux_c = (1.0 / d["GaMaCoTe0"]) * mo_fli * d["SpSuAr"]
    dcdt = (p["vf"] / (eps * p["ReLe"])) * (
        conv_c + disp_c + flux_sign * flux_c)

    dtdz, d2t = ax.derivatives(T_dl, ax.heat_ghost(d, T_dl))
    conv_t = -d["vDl"] * ga_de_dl * cp_dl * dtdz
    disp_t = (1.0 / d["PeNuHe0"]) * (eps * 1.0) * d2t
    flux_t = (
        d["HeTrCo"] * d["SpSuAr"] * p["T0"] * (ts_surf - T_dl) * 1e-3
    ) / d["GaHeCoTe0"]
    exch_t = qm / d["GaHeCoTe0"]
    dtdt = (conv_t + disp_t + flux_t + exch_t) / (
        ga_de_dl * cp_dl * eps * (p["ReLe"] / p["vf"]))
    return dcdt, dtdt, ga_de


def make_m13_gas_rhs(spec: M13Spec, flux_sign: float = 1.0, mesh=None,
                     clamp_width: float = 0.0):
    """Gas-phase MoL RHS of M13, vectorized over z (reference
    modelEquationM2): rhs(t, y (n_layer*zNo,), p, d, cs_surf (n_comp, zNo),
    ts_surf (zNo,)), the interface values dimensionless.

    flux_sign +1.0 reproduces the reference's interphase-flux sign
    (pbHeterReactor.py:1798,2004), which makes the gas phase linearly
    unstable; the driver integrates with -1.0, the sister model's sign
    (pbReactor.modelEquationM7:5268). mesh: a two_zone_mesh(...) result
    (the reference's refined stencils, :1884-1945) or None. clamp_width:
    0.0 is the reference's hard max(Ci, EPS) clamp; the driver uses the
    smooth C^1 clamp of width 1e-3 on refined meshes (rmt_tpu's
    make_m13_gas_rhs docstring says why)."""
    n_comp, z_no = spec.n_comp, spec.z_no
    ax = AxialStencil(z_no, mesh)

    def rhs(t, y, p, d, cs_surf, ts_surf):
        Y = y.reshape(n_comp + 1, z_no)
        dcdt, dtdt, _ = _gas_phase(spec, ax, p, d, Y[:n_comp], Y[n_comp],
                                   cs_surf, ts_surf, flux_sign, clamp_width)
        return torch.cat([dcdt, dtdt[None]], dim=0).reshape(-1)

    return rhs


def _fd_particle(spec: M13Spec, nu, p, d, cs_store, ts_store, c_bulk, t_bulk,
                 P, scaled_sources=True):
    """The FDM particle rows of every node (the nodes on the last axis, Z
    of them): cs_store (n_comp, rNo, Z) and ts_store (rNo, Z) in radial
    storage order, the bulk values c_bulk (n_comp, Z) and t_bulk (Z,) of
    the Robin interface, the kinetics pressure P (scalar or (Z,)). M13's
    steady residual (modelEquationM3, pbHeterReactor.py:2167-2816) and
    M11's particle rows (modelEquationM7) in one: kinetics and energetics
    in storage order, flipped center-first for the FD assemblers and back
    (solFiDi.py:397-400), the energy row scaled by the real effective heat
    capacity. scaled_sources=False passes the reaction and enthalpy
    sources unscaled (M11's reference quirk, pbReactor.py:5288,5468).
    Returns (dcs (n_comp, rNo, Z), dts (rNo, Z))."""
    rf = p["PaDi"] / 2
    ca_po = p["CaPo"]

    cs_cl = torch.clamp(cs_store, min=EPS_CONST)
    cs_re = cs_cl * d["Cmax"]
    ts_re = ts_store * p["T0"] + p["T0"]
    cos_sp_re = torch.sum(cs_re, dim=0)                 # (rNo, Z)
    mo_frsi = cs_re / cos_sp_re                         # (n_comp, rNo, Z)
    r0 = spec.rates(ts_re, P, mo_frsi, cs_re,
                    p["kinetic_overrides"]).to(cs_store.dtype)
    ri_r = torch.einsum("mk,mrz->krz", nu, r0)          # (n_comp, rNo, Z)

    cp_mean_i = thermo.cp_mean(ts_re, spec.comp_idx)    # (rNo, Z, n_comp)
    so_cp_mix = torch.sum(mo_frsi.movedim(0, -1) * cp_mean_i, dim=-1)
    so_cp_eff_re = (cos_sp_re * so_cp_mix * ca_po
                    + (1 - ca_po) * p["CaDe"] * p["CaSpHeCa"])
    ov_he_re_t = torch.sum(
        r0.movedim(0, -1) * _reaction_energetics(spec, ts_re), dim=-1)

    # storage -> center-first, the radial axis last for the assemblers
    def cf(a, r_axis):
        return a.flip(r_axis).movedim(r_axis, -1)

    if scaled_sources:
        ri_r = (1.0 / d["SoMaDiTe0"])[:, None, None] * (1 - ca_po) * ri_r
    a = particle_fd.build_c_residual(
        cf(cs_cl, 1), cf(ri_r, 1), 1.0, d["MaTrCo"][:, None], c_bulk,
        p["GaDii0"][:, None], rf, flux_dir="rl")       # (n_comp, Z, rNo)
    dcs = a.flip(-1).movedim(-1, 1) / (
        ca_po * rf**2 / p["GaDii0"])[:, None, None]

    dh = -cf(ov_he_re_t, 0)                             # (Z, rNo)
    if scaled_sources:
        dh = (1.0 / d["SoHeDiTe0"]) * (1 - ca_po) * dh
    so_th_eff_conv = ca_po * p["GaThCoMix0"] / 1000.0
    a_t = particle_fd.build_t_residual(
        cf(ts_store, 0), dh, ca_po * 1.0, d["HeTrCo"] / 1000.0, t_bulk,
        so_th_eff_conv, rf)
    dts = a_t.flip(-1).T / (so_cp_eff_re * p["T0"] / d["SoHeDiTe0"])
    return dcs, dts


def make_m13_solid_residual(spec: M13Spec):
    """The steady particle residual of M13 (modelEquationM3, the
    reference's one flattened fsolve system): residual(y (n_layer, rNo,
    Z), c_bulk (n_comp, Z), t_bulk (Z,), p, d) -> (n_layer, rNo, Z) for any
    number Z of independent nodes, the dimensionless gas bulk values in
    the Robin interface; kinetics at P0 for every node (the reference's
    P_z march is the identity, pbHeterReactor.py:2568)."""
    nu = DeviceTables(nu=spec.stoich.nu_comp)
    n_comp = spec.n_comp

    def residual(y, c_bulk, t_bulk, p, d):
        dcs, dts = _fd_particle(spec, nu(y)["nu"], p, d, y[:n_comp],
                                y[n_comp], c_bulk, t_bulk, p["P0"])
        return torch.cat([dcs, dts[None]], dim=0)

    return residual


def make_m13_solid_node_residual(spec: M13Spec):
    """The residual of one axial node's particle: residual(y_node
    (n_layer, rNo), c_bulk (n_comp,), t_bulk (), p, d) -> (n_layer, rNo)
    (make_m13_solid_residual at Z = 1)."""
    residual = make_m13_solid_residual(spec)

    def node(y_node, c_bulk, t_bulk, p, d):
        return residual(y_node[..., None], c_bulk[:, None],
                        torch.as_tensor(t_bulk)[None], p, d)[..., 0]

    return node


def m11_initial_state(spec: M13Spec, p):
    """M11 IV (pbReactor.py:3991-4026): gas rows at the dimensionless feed,
    solid rows 1e-6, all temperatures 0; (n_layer, rNo+1, zNo) flat."""
    c_in = p["SpCoi0"] / torch.max(p["SpCoi0"])
    c_gas = c_in[:, None, None].expand(spec.n_comp, 1, spec.z_no)
    c_sol = torch.full((spec.n_comp, spec.r_no, spec.z_no), 1e-6,
                       dtype=c_gas.dtype, device=c_gas.device)
    t_all = torch.zeros((1, spec.r_no + 1, spec.z_no), dtype=c_gas.dtype,
                        device=c_gas.device)
    return torch.cat([torch.cat([c_gas, c_sol], dim=1), t_all],
                     dim=0).reshape(-1)


def m12_physical_state(spec: M13Spec, p):
    """The physical startup state of M12 (and of the M12 sweep's default):
    the dimensionless feed at every (r, z) node, theta = 0 (rmt_tpu's
    run_m12_sweep default; the reference's 1e-6 seed is singular)."""
    c_in = p["SpCoi0"] / torch.max(p["SpCoi0"])
    c = c_in[:, None, None].expand(spec.n_comp, spec.r_no + 1, spec.z_no)
    return torch.cat([c, torch.zeros_like(c[:1])], dim=0).reshape(-1)


def _ergun_march(p, d, ga_de, dz):
    """Explicit Ergun pressure march on the real gas density: node z sees
    P0 + dz*sum_{k<z} RHS_ergun(GaDe_k) (pbReactor.py:4856-4865), frozen
    for differentiation (rmt_tpu's stop_gradient)."""
    eps = p["BeVoFr"]
    su_ga_ve_re = d["vDl"] * p["vf"]
    erg_a = 150.0 * p["GaViMix0"] * su_ga_ve_re / p["PaDi"] ** 2
    erg_b = (1 - eps) ** 2 / eps**3
    erg_c = 1.75 * ga_de * su_ga_ve_re**2 / p["PaDi"]
    erg_d = (1 - eps) / eps**3
    rhs_erg = -(erg_a * erg_b + erg_c * erg_d)
    p_march = p["P0"] + dz * torch.cat(
        [torch.zeros_like(rhs_erg[:1]), torch.cumsum(rhs_erg, 0)[:-1]])
    return p_march.detach()


def _split_state(spec, y):
    """(c_gas (n_comp, zNo), T_gas (zNo,), c_solid (n_comp, rNo, zNo),
    T_solid (rNo, zNo)) of an M10-M12 state."""
    n_comp = spec.n_comp
    Y = y.reshape(n_comp + 1, spec.r_no + 1, spec.z_no)
    return Y[:n_comp, 0], Y[n_comp, 0], Y[:n_comp, 1:], Y[n_comp, 1:]


def _join_state(dcdt_gas, dtdt_gas, dcs, dts):
    dc = torch.cat([dcdt_gas[:, None], dcs], dim=1)
    dt = torch.cat([dtdt_gas[None], dts], dim=0)
    return torch.cat([dc, dt[None]], dim=0).reshape(-1)


def make_m11_rhs(spec: M13Spec, scaled_sources: bool = True, mesh=None):
    """Coupled dynamic heterogeneous MoL RHS (reference modelEquationM7,
    pbReactor.py:4389-5491): row 0 the M13 gas phase with the NEGATIVE
    interphase-flux sign against the CLAMPED solid surface row
    (:4774,5062,5268), rows 1..rNo the dynamic FDM particle whose bulk
    values are the local raw gas state (:5288,5468) and whose kinetics
    see the live Ergun march P_z (:4856-4865,4953; frozen for the
    Jacobian). On a refined mesh the march steps by the normal-zone dz
    (:4865). scaled_sources=False pins the reference's unscaled particle
    sources (rmt_tpu's docstring: no integrator advances past ~1e-8 s on
    them); the driver integrates the scaled form."""
    ax = AxialStencil(spec.z_no, mesh)
    nu = DeviceTables(nu=spec.stoich.nu_comp)

    def rhs(t, y, p, d):
        c_raw, T_dl, cs_store, ts_store = _split_state(spec, y)
        dcdt_gas, dtdt_gas, ga_de = _gas_phase(
            spec, ax, p, d, c_raw, T_dl,
            torch.clamp(cs_store[:, 0], min=EPS_CONST), ts_store[0])
        p_march = _ergun_march(p, d, ga_de, ax.dz)
        dcs, dts = _fd_particle(spec, nu(y)["nu"], p, d, cs_store, ts_store,
                                c_raw, T_dl, p_march, scaled_sources)
        return _join_state(dcdt_gas, dtdt_gas, dcs, dts)

    return rhs


def _oc_ops(r_no: int, model: str):
    ops = oc_particle.oc_operator()
    assert ops["N"] == r_no, (
        f"{model} uses the {ops['N']}-point OC basis; got rNo={r_no}")
    return ops


def _m12_interface(spec, p, d, y, A):
    """(cs_cl, cs_hat, ts_hat, beta_c, beta_t) of an M12 state: the clamped
    stored concentrations (n_comp, rNo, zNo) and the algebraically updated
    interface profiles, concentrations (n_comp, zNo, rNo) and temperature
    (zNo, rNo), the radial axis last."""
    rf = p["PaDi"] / 2
    c_raw, T_dl, cs_store, ts_store = _split_state(spec, y)
    cs_cl = torch.clamp(cs_store, min=EPS_CONST)
    beta_c = (rf / p["GaDii0"]) * d["MaTrCo"]                # (n_comp,)
    cs_hat = oc_particle.interface_update(cs_cl.movedim(1, 2), c_raw,
                                          beta_c[:, None], A)
    so_th_eff_conv = p["CaPo"] * p["GaThCoMix0"] / 1000.0
    beta_t = (rf / so_th_eff_conv) * (-(d["HeTrCo"] / 1000.0) / p["CaPo"])
    ts_hat = oc_particle.interface_update(ts_store.T, T_dl, beta_t, A)
    return cs_cl, cs_hat, ts_hat, beta_c, beta_t


def _static_surface(x):
    """x (..., rNo) with its surface (last) entry pinned to 0."""
    return torch.cat([x[..., :-1], torch.zeros_like(x[..., -1:])], dim=-1)


def make_m12_rhs(spec: M13Spec, cp_at_real_temperature: bool = True,
                 clamp_interface: bool = False, mesh=None):
    """Coupled dynamic heterogeneous MoL RHS with an orthogonal-collocation
    particle and a static algebraic gas-solid interface (reference
    modelEquationM8, pbReactor.py:6050-7181, salvaged as rmt_tpu salvages
    it: the reference's own OC assembly crashes). Gas rows are _gas_phase
    against the updated surface values with the live Ergun march; solid
    rows 1..rNo are the OC points center-first, the surface row dead
    storage (derivative 0). cp_at_real_temperature=False reproduces the
    reference's Cp/enthalpy at the dimensionless temperature
    (:6665,6684); clamp_interface=True projects the interface onto
    c >= EPS (the driver's choice)."""
    n_comp = spec.n_comp
    ax = AxialStencil(spec.z_no, mesh)
    nu = DeviceTables(nu=spec.stoich.nu_comp)
    ops = _oc_ops(spec.r_no, "M12")

    def rhs(t, y, p, d):
        rf = p["PaDi"] / 2
        ca_po = p["CaPo"]
        c_raw, T_dl, cs_store, ts_store = _split_state(spec, y)
        cs_cl, cs_hat, ts_hat, beta_c, beta_t = _m12_interface(
            spec, p, d, y, oc_particle.table(ops, "A", y))
        if clamp_interface:
            cs_hat = torch.clamp(cs_hat, min=EPS_CONST)

        dcdt_gas, dtdt_gas, ga_de = _gas_phase(
            spec, ax, p, d, c_raw, T_dl, cs_hat[..., -1], ts_hat[:, -1])
        p_march = _ergun_march(p, d, ga_de, ax.dz)

        # kinetics/energetics on the STORED clamped state (quirk)
        cs_re = cs_cl * d["Cmax"]
        ts_re = ts_store * p["T0"] + p["T0"]
        cos_sp_re = torch.sum(cs_re, dim=0)
        mo_frsi = cs_re / cos_sp_re
        r0 = spec.rates(ts_re, p_march, mo_frsi, cs_re,
                        p["kinetic_overrides"]).to(y.dtype)
        ri_r = torch.einsum("mk,mrz->krz", nu(y)["nu"], r0)

        t_for_cp = ts_re if cp_at_real_temperature else ts_store
        so_cp_mix = torch.sum(mo_frsi.movedim(0, -1)
                              * thermo.cp_mean(t_for_cp, spec.comp_idx), -1)
        so_cp_eff_re = (cos_sp_re * so_cp_mix * ca_po
                        + (1 - ca_po) * p["CaDe"] * p["CaSpHeCa"])
        ov_he_re_t = torch.sum(
            r0.movedim(0, -1) * _reaction_energetics(spec, t_for_cp), -1)

        ri_term = (1.0 / d["SoMaDiTe0"])[:, None, None] * (1 - ca_po) * ri_r
        k_c = (ca_po / p["CaTo"]) * 1.0                      # SoDiiEff_DiLe
        res_c = oc_particle.oc_residual(cs_hat, k_c, ri_term.movedim(1, 2),
                                        beta_c[:, None], 0.0, ops)
        dcs = res_c * (p["GaDii0"] / (ca_po * rf**2))[:, None, None]

        dh_term = (1.0 / d["SoHeDiTe0"]) * (1 - ca_po) * (-ov_he_re_t)
        res_t = oc_particle.oc_residual(ts_hat, ca_po * 1.0, dh_term.T,
                                        beta_t, 0.0, ops)
        dts = res_t / (so_cp_eff_re.T * p["T0"] / d["SoHeDiTe0"])
        # the Robin row is exactly zero after the update: pin it
        return _join_state(dcdt_gas, dtdt_gas,
                           _static_surface(dcs).movedim(-1, 1),
                           _static_surface(dts).T)

    return rhs


def m12_surface_values(spec: M13Spec, p, d, y):
    """The algebraic gas-solid interface values of a state y for output
    (the state's surface row is dead storage): (cs_hat (n_comp, rNo, zNo),
    ts_hat (rNo, zNo)), OC order center-first."""
    ops = _oc_ops(spec.r_no, "M12")
    _, cs_hat, ts_hat, _, _ = _m12_interface(
        spec, p, d, y, oc_particle.table(ops, "A", y))
    return cs_hat.movedim(-1, 1), ts_hat.T


# hard-coded film-property constants of the reference's M6 RHS
# (pbReactor.py:3398 GaViMix = 2.5e-5, :3415 GaThCoMix = 0.125)
_M10_GA_VI_MIX = 2.5e-5
_M10_GA_TH_CO_MIX = 0.125


def m10_params(model_input: Mapping[str, Any], dtype=None,
               device=None) -> dict[str, Any]:
    """M10 inputs (reference runM6, pbReactor.py:2668-2860) as tensors on
    ``device``; the diffusivities come from the feed (the reference RHS
    hard-codes the DME vector, :3432)."""
    oc = model_input["operating-conditions"]
    feed = model_input["feed"]
    re_spec = model_input["reactor"]
    ex_he = model_input.get("external-heat", _NO_HEAT)
    return _with_overrides(model_input, _params({
        "P0": oc["pressure"],
        "T0": oc["temperature"],
        "opT": oc.get("period", 1.0),
        "VoFlRa0": feed["volumetric-flowrate"],
        "SpCoi0": feed["concentration"],
        "GaDii": feed["diffusivity"],
        "GaMiVi": feed["mixture-viscosity"],
        "U": ex_he["OvHeTrCo"],
        "EfHeTrAr": ex_he["EfHeTrAr"],
        "Tm": ex_he["MeTe"],
        "ReInDi": re_spec["ReInDi"],
        "ReLe": re_spec["ReLe"],
        "PaDi": re_spec["PaDi"],
        "BeVoFr": re_spec["BeVoFr"],
        "CaBeDe": re_spec["CaBeDe"],
        "CaDe": re_spec["CaDe"],
        "CaSpHeCa": re_spec["CaSpHeCa"],
        "CaPo": re_spec["CaPo"],
        "CaTo": re_spec["CaTo"],
        "CaThCo": re_spec["CaThCo"],
    }, dtype, device))


def m10_initial_state(spec: M13Spec, p):
    """M10 IV (pbReactor.py:2786-2813): feed concentrations and feed
    temperature everywhere (gas and particle), real units."""
    c = p["SpCoi0"][:, None, None].expand(spec.n_comp, spec.r_no + 1,
                                          spec.z_no)
    t = p["T0"].expand(1, spec.r_no + 1, spec.z_no)
    return torch.cat([c, t], dim=0).reshape(-1)


def _m10_march(spec, p, z_no, dz, v0, sp_su_ar, ga_de, co_sp, T_z,
               dxdt_v_T, cp_z, mimo_z, gap):
    """The (P, v) march of M10 over the nodes in order (pbReactor.py:
    3585-3640), on inputs detached from the state: per node z the Ergun
    pressure drop, the film coefficients of the local velocity and the
    velocity change of the EOS/flux balance, with rmt_tpu's velocity floor
    at 5% of the inlet velocity. Returns (P_z, v_z, dxdt_v, ma_tr_z
    (n_comp, zNo), he_tr_z), each node's values before its update. The
    terms that do not depend on (P, v) are computed for every node at
    once, in the reference's order of operations."""
    eps = p["BeVoFr"]
    mu, k = _M10_GA_VI_MIX, _M10_GA_TH_CO_MIX
    erg_b = (1 - eps) ** 2 / eps**3
    erg_d = (1 - eps) / eps**3
    erg_c0 = 1.75 * ga_de                                 # (zNo,)
    sh_c = 1.1 * film.schmidt(ga_de[None], mu, p["GaDii"][:, None]) ** (
        1 / 3)                                           # (n_comp, zNo)
    inv_c = 1.0 / (co_sp * 1000.0)
    P, v = p["P0"], v0
    Ps, vs, dvs, mas, res = [], [], [], [], []
    for z in range(z_no):
        erg_a = 150.0 * p["GaMiVi"] * v / p["PaDi"] ** 2
        erg_c = erg_c0[z] * v**2 / p["PaDi"]
        dxdt_p = -(erg_a * erg_b + erg_c * erg_d)
        re_nu = film.reynolds(ga_de[z], v, p["PaDi"], mu)
        sh_nu = 2 + sh_c[:, z] * re_nu**0.6              # FROSSLING
        ma_tr = film.mass_transfer_coefficient(sh_nu, p["GaDii"], p["PaDi"])
        to_ma_tr = torch.sum(ma_tr * gap[:, z]) * sp_su_ar
        T_c = T_z[z]
        dxdt_v = inv_c[z] * (
            (-v / R_CONST) * ((1.0 / T_c) * dxdt_p - (P / T_c**2)
                              * dxdt_v_T[z])
            - to_ma_tr * 1000.0)
        Ps.append(P)
        vs.append(v)
        dvs.append(dxdt_v)
        mas.append(ma_tr)
        res.append(re_nu)
        v = torch.maximum(v + dz * dxdt_v, 0.05 * v0)
        P = P + dz * dxdt_p
    re_z = torch.stack(res)
    nu_nu = film.nusselt(film.prandtl(cp_z, mu, k, mimo_z), re_z)
    he_tr_z = film.heat_transfer_coefficient(nu_nu, k, p["PaDi"])
    return (torch.stack(Ps), torch.stack(vs), torch.stack(dvs),
            torch.stack(mas, dim=1), he_tr_z)


def make_m10_rhs(spec: M13Spec, clamp_interface: bool = False):
    """Dynamic heterogeneous packed bed in REAL units with an OC particle
    and live velocity/pressure marches (reference modelEquationM6,
    pbReactor.py:3053-3801, salvaged as make_m12_rhs: OC rows aligned with
    their points, a static surface row). rhs(t, y, p, d=None).

    Retained quirks: the film fluxes use the STORED innermost OC row as
    the catalyst surface (:3326,3584,3768); film coefficients per node
    with the hard-coded GaViMix/GaThCoMix (:3398,3415) while Ergun uses
    the feed viscosity; BC2 sets the forward neighbour to 0 and interior
    backward neighbours are EPS-clamped (:3679-3686); axial heat
    dispersion is zeroed (:3764); the gas balance carries -Ci*dv/dz; the
    solid heat capacity is the gas mixture's at the gas temperature
    (:3510). The (P, v) march and its film coefficients are frozen for
    differentiation; the film fluxes themselves stay live."""
    n_comp, r_no, z_no = spec.n_comp, spec.r_no, spec.z_no
    idx = spec.comp_idx
    ops = _oc_ops(r_no, "M10")
    tables = DeviceTables(nu=spec.stoich.nu_comp, mw=DB.MW[idx])

    def rhs(t, y, p, d=None):
        tb = tables(y)
        eps = p["BeVoFr"]
        pa_ra = p["PaDi"] / 2
        ca_po = p["CaPo"]
        dz = p["ReLe"] / (z_no - 1)
        cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
        sp_su_ar = (3 / pa_ra) * (1 - eps)
        so_dii_eff = (ca_po / p["CaTo"]) * p["GaDii"]
        so_th_co_eff = p["CaThCo"] * (1 - ca_po) / p["CaTo"]
        c_raw, T_z, cs_store, ts_store = _split_state(spec, y)

        # --- per-node gas state (vectorized) ---
        c_cl = torch.clamp(c_raw, min=EPS_CONST)
        co_sp = torch.sum(c_cl, dim=0)
        mo_fri = c_cl / co_sp
        mi_mo_we = thermo.mixture_molecular_weight(mo_fri.T, tb["mw"],
                                                   "kg/mol")
        ga_de = thermo.density_ig(mi_mo_we, co_sp * 1000.0)
        ga_cp_mix = torch.sum(mo_fri.T * thermo.cp_mean(T_z, idx), dim=-1)

        v0 = p["VoFlRa0"] / cr_se_ar                 # SuGaVe0 (:3205-3207)
        ga_th_co_eff = eps * _M10_GA_TH_CO_MIX

        # dT/dz for the dv/dz balance; BC1 ghost via the /1000 constant
        # (:3602), BC2/interior use the backward state value
        mo_fl0 = co_sp[0] * v0
        c1_v = ga_th_co_eff / (mo_fl0 * ga_cp_mix[0] / 1000.0)
        t_b0_v = (p["T0"] * dz + c1_v * T_z[1]) / (dz + c1_v)
        dxdt_v_T = (T_z - torch.cat([t_b0_v[None], T_z[:-1]])) / dz

        # clamped stored "surface" rows for the film fluxes (:3320,3326)
        cs_surf_st = torch.clamp(cs_store[:, 0], min=EPS_CONST)
        ts_surf_st = ts_store[0]

        P_z, v_z, dxdt_v, ma_tr_z, he_tr_z = _m10_march(
            spec, p, z_no, dz, v0.detach(), sp_su_ar,
            *(x.detach() for x in (ga_de, co_sp, T_z, dxdt_v_T, ga_cp_mix,
                                   mi_mo_we, c_raw - cs_surf_st)))

        # live film fluxes with the frozen coefficients
        mo_fli = ma_tr_z * (c_raw - cs_surf_st)      # (n_comp, zNo)

        # --- gas species balance ---
        kv = (p["GaDii"] * eps / v_z[0])[:, None]
        c_bc1 = (p["SpCoi0"][:, None] * dz + kv * c_raw[:, 1:2]) / (kv + dz)
        c_back = torch.cat([c_bc1, torch.clamp(c_raw[:, :-1],
                                               min=EPS_CONST)], dim=1)
        c_fwd = torch.cat([c_raw[:, 1:], torch.zeros_like(c_raw[:, :1])],
                          dim=1)
        dcdz = (c_raw - c_back) / dz
        d2c = (c_back - 2 * c_raw + c_fwd) / dz**2
        dcdt_gas = (1.0 / eps) * (
            -v_z[None, :] * dcdz
            - c_raw * dxdt_v[None, :]
            + p["GaDii"][:, None] * eps * d2c
            - mo_fli * sp_su_ar)

        # --- gas energy balance (dispersion zeroed, :3764) ---
        mo_fl = co_sp * v_z
        c1_t = ga_th_co_eff / (mo_fl[0] * ga_cp_mix[0] * 1000.0)
        t_b0 = (p["T0"] * dz + c1_t * T_z[1]) / (dz + c1_t)
        dtdz = (T_z - torch.cat([t_b0[None], T_z[:-1]])) / dz
        qm = _heat_exchange(p["Tm"], T_z, p["U"], p["EfHeTrAr"]) * 1e-3
        in_fl_t = he_tr_z * (ts_surf_st - T_z) * 1e-3
        dtdt_gas = (1.0 / (co_sp * ga_cp_mix * eps)) * (
            -(mo_fl * ga_cp_mix) * dtdz + in_fl_t * sp_su_ar + qm)

        # --- solid phase, every node at once (OC order, center-first) ---
        cs_cl = torch.clamp(cs_store, min=EPS_CONST)
        cos_sp = torch.sum(cs_cl, dim=0)
        mo_frsi = cs_cl / cos_sp
        r0 = spec.rates(ts_store, P_z, mo_frsi, cs_cl,
                        p["kinetic_overrides"]).to(y.dtype)
        ri_r = torch.einsum("mk,mrz->krz", tb["nu"], r0)
        ov_he_re_t = torch.sum(
            r0.movedim(0, -1) * _reaction_energetics(spec, ts_store), -1)
        # solid heat capacity: GAS mixture Cp at the gas temperature
        so_cp_eff = (co_sp * ga_cp_mix * ca_po
                     + (1 - ca_po) * p["CaDe"] * p["CaSpHeCa"])

        beta_c = pa_ra * (ma_tr_z / so_dii_eff[:, None])     # (n_comp, zNo)
        beta_t = -1.0 * he_tr_z * pa_ra / so_th_co_eff       # (zNo,)
        A = oc_particle.table(ops, "A", y)
        cs_hat = oc_particle.interface_update(cs_cl.movedim(1, 2), c_raw,
                                              beta_c, A)
        if clamp_interface:
            cs_hat = torch.clamp(cs_hat, min=EPS_CONST)
        ts_hat = oc_particle.interface_update(ts_store.T, T_z, beta_t, A)

        src_c = pa_ra**2 * ri_r                      # (:3722) source x PaRa^2
        res_c = oc_particle.oc_residual(cs_hat, so_dii_eff[:, None, None],
                                        src_c.movedim(1, 2), 0.0, 0.0, ops)
        dcs = res_c / (ca_po * pa_ra**2)
        src_t = pa_ra**2 * (-ov_he_re_t)             # (:3790)
        res_t = oc_particle.oc_residual(ts_hat, so_th_co_eff / 1000.0,
                                        src_t.T, 0.0, 0.0, ops)
        dts = res_t / (so_cp_eff[:, None] * pa_ra**2)
        return _join_state(dcdt_gas, dtdt_gas,
                           _static_surface(dcs).movedim(-1, 1),
                           _static_surface(dts).T)

    return rhs


# ---------------------------------------------------------------------------
# The M13 split driver over a batch of members
# ---------------------------------------------------------------------------

def _lead(tree):
    """tree with a leading member axis of 1 on every leaf."""
    if isinstance(tree, Mapping):
        return {k: _lead(v) for k, v in tree.items()}
    return tree[None]


def no_axes(params):
    """The in_dims tree of an unbatched parameter dict (every leaf None)."""
    if isinstance(params, Mapping):
        return {k: no_axes(v) for k, v in params.items()}
    return None


def per_member(fn, params, axes):
    """fn(p) of every member of a sweep (params with the in_dims tree
    axes), stacked on a leading member axis; a parameter dict with no
    batched leaf is one member."""
    if _swept(params, axes) is None:
        return _lead(fn(params))
    return vmap(fn, in_dims=(axes,))(params)


def _swept(params, axes):
    """The sub-dict of params' swept leaves (axis 0), None if none."""
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            sub = _swept(v, axes[k])
            if sub:
                out[k] = sub
        elif axes[k] is not None:
            out[k] = v
    return out or None


def _merged(params, swept):
    out = dict(params)
    for k, v in swept.items():
        out[k] = _merged(params[k], v) if isinstance(v, Mapping) else v
    return out


def over_members(fn, params, axes):
    """g(*args) = fn(*args, p) of every member: each arg carries a leading
    member axis, p is the member's parameters (params' swept leaves
    mapped, the rest shared). Only the swept leaves pass through vmap's
    input tree: with a few dozen shared leaves, mapping the whole dict
    costs more host time than the function itself."""
    swept = _swept(params, axes)
    if swept is None:
        return vmap(lambda *args: fn(*args, params))
    inner = vmap(lambda sw, *args: fn(*args, _merged(params, sw)))
    return lambda *args: inner(swept, *args)


def make_m13_driver(spec: M13Spec, mesh=None, rtol=1e-5, atol=1e-7):
    """Operator-splitting M13 driver (reference time loop
    pbHeterReactor.py:995-1148) over a batch of members. Per interval: the
    gas MoL phase on radau.odeint_batched with the previous interval's
    solid-surface values, then every node's particle BVP by
    pseudo-transient continuation (radau.odeint_batched over all nodes of
    all members to pseudo-time 1, rtol 1e-6, atol 1e-9, 4000 steps) and
    damped Newton (newton.root_batched like_root, 40 iterations, tol
    1e-9) against the previous interval's gas bulk, clamped with max(EPS)
    (refined mesh: the smooth clamp of width 1e-3).

    Salvages of rmt_tpu's driver, kept: the flux sign of the sister model,
    the gas state carried across intervals (the reference re-seeds a dead
    variable, :1148), the smooth clamps on refined meshes.

    run(params, axes=None, y_gas0=None, y_solid0=None, t_start=0.0,
    timings=None) -> (gas_t (B, tNo, n_layer*zNo), solid_t (B, tNo,
    n_layer, rNo, zNo), conv_t (B, tNo) bool, unr_t (B, tNo) int,
    ts_grid (tNo+1,)). axes: the in_dims tree of a sweep's params (the
    period opT must be shared); None runs params as one member (B = 1).
    y_gas0 (B, n_layer*zNo) / y_solid0 (B, n_layer, rNo, zNo) / t_start
    resume a run (the "checkpoint" of rmtExe M13): every interval restarts
    from the carried state alone, so chained runs reproduce one run.
    timings: an optional dict to which the seconds of the gas phase
    ("gas"), the continuation ("ptc") and the Newton polish ("polish")
    are added, each closed by a device synchronisation."""
    from ..solvers import newton, radau

    gas_rhs = make_m13_gas_rhs(spec, flux_sign=-1.0, mesh=mesh,
                               clamp_width=1e-3 if mesh is not None else 0.0)
    solid = make_m13_solid_residual(spec)
    n_comp, n_layer, r_no, z_no = (spec.n_comp, spec.n_layer, spec.r_no,
                                   spec.z_no)
    n_node = n_layer * r_no

    def clamp_bulk(cb):
        # a negative bulk (refined-mesh inlet undershoot) drives the
        # particle Newton into unphysical states
        if mesh is not None:
            return 0.5 * (cb + EPS_CONST
                          + torch.sqrt((cb - EPS_CONST) ** 2 + 1e-6))
        return torch.clamp(cb, min=EPS_CONST)

    def run(params, axes=None, y_gas0=None, y_solid0=None, t_start=0.0,
            timings=None):
        axes = no_axes(params) if axes is None else axes
        d = per_member(lambda q: m13_feed(spec, q), params, axes)
        y_gas = (per_member(lambda q: m13_gas_initial_state(spec, q), params,
                            axes) if y_gas0 is None else y_gas0)
        y_solid = (per_member(lambda q: m13_solid_initial_state(spec, q),
                              params, axes) if y_solid0 is None else y_solid0)
        B, dev, dt = y_gas.shape[0], y_gas.device, y_gas.dtype
        gas_b = over_members(lambda t, y, dd, cs, ts, pp: gas_rhs(
            t, y, pp, dd, cs, ts), params, axes)
        gas_st = over_members(lambda t, y, dd, cs, ts, pp: vmap(
            lambda tt, yy: gas_rhs(tt, yy, pp, dd, cs, ts))(t, y),
            params, axes)
        solid_b = over_members(lambda y, cb, tb, dd, pp: solid(
            y, cb, tb, pp, dd), params, axes)

        def nodes(x, cb, tb):
            """Residuals of node rows x (B*K, n_node), member-major, K
            nodes a member with bulk values cb (B, n_comp, K), tb (B, K)."""
            K = cb.shape[-1]
            y = x.reshape(B, K, n_layer, r_no).permute(0, 2, 3, 1)
            return solid_b(y, cb, tb, d).permute(0, 3, 1, 2).reshape(
                B * K, n_node)

        def solve_solid(y_sol, c_bulk, t_bulk):
            cb = clamp_bulk(c_bulk)
            cb3, tb3 = cb.repeat_interleave(3, -1), t_bulk.repeat_interleave(
                3, -1)
            x0 = y_sol.permute(0, 3, 1, 2).reshape(B * z_no, n_node)
            clock = time.perf_counter()
            ys, _ = radau.odeint_batched(
                lambda t, x: nodes(x, cb, t_bulk), x0,
                torch.tensor([0.0, 1.0], dtype=dt, device=dev),
                rtol=1e-6, atol=1e-9, max_steps=4000,
                f_stages=lambda t_st, X: nodes(
                    X.reshape(-1, n_node), cb3, tb3).reshape(X.shape))
            clock = lap(clock, "ptc")
            sol = newton.root_batched(lambda x: nodes(x, cb, t_bulk),
                                      ys[:, -1], max_iter=40, n_backtrack=8,
                                      tol=1e-9, like_root=True)
            lap(clock, "polish")
            return (sol.x.reshape(B, z_no, n_layer, r_no).permute(0, 2, 3, 1),
                    sol.converged.reshape(B, z_no).all(dim=1))

        def lap(t0, key):
            if timings is None:
                return t0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[key] = timings.get(key, 0.0) + now - t0
            return now

        cs_surf, ts_surf = y_solid[:, :n_comp, 0], y_solid[:, n_comp, 0]
        g0 = y_gas.reshape(B, n_layer, z_no)
        c_bulk, t_bulk = g0[:, :n_comp], g0[:, n_comp]
        ts_grid = (t_start + params["opT"] * torch.linspace(
            0.0, 1.0, spec.t_no + 1, dtype=dt, device=dev)).to(dt)
        out = []
        for k in range(spec.t_no):
            clock = time.perf_counter()
            ys, stats = radau.odeint_batched(
                lambda t, y: gas_b(t, y, d, cs_surf, ts_surf), y_gas,
                ts_grid[k:k + 2], rtol=rtol, atol=atol,
                f_stages=lambda t_st, Y: gas_st(t_st, Y, d, cs_surf, ts_surf))
            lap(clock, "gas")
            y_gas = ys[:, -1]
            y_solid, conv = solve_solid(y_solid, c_bulk, t_bulk)
            cs_surf, ts_surf = y_solid[:, :n_comp, 0], y_solid[:, n_comp, 0]
            Yg = y_gas.reshape(B, n_layer, z_no)
            c_bulk, t_bulk = Yg[:, :n_comp], Yg[:, n_comp]
            out.append((y_gas, y_solid, conv, stats.n_unreached))
        gas_t, solid_t, conv_t, unr_t = (torch.stack(v, dim=1)
                                         for v in zip(*out))
        return gas_t, solid_t, conv_t, unr_t, ts_grid

    return run
