# Heterogeneous packed-bed models M5 and M14 (port of
# rmt_tpu/models/hetero.py), as plain functions on tensors.
#
# M5 (reference PackedBedHeteroReactorClass.runM1/modelEquationM1,
# PyREMOT/docs/pbHeterReactor.py:70-506): steady "plug-flow heterogenous
# reactor" in molar-flow variables. Reproduced quirks:
#   * kinetics are HARD-CODED first order in species 0 with
#     k = 8.2e14*exp(-284.5e3/RT)*1e7 -- the reference ignores the DSL here
#     (pbHeterReactor.py:428-437);
#   * formation rates are scaled by the catalyst bed density inside the
#     stoichiometry loop (pbHeterReactor.py:449);
#   * the reference's runM1 routine itself crashes (`for i in len(opTSpan)-1`
#     iterates an int, pbHeterReactor.py:204), so this is the intended
#     single integration over z.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from .. import config
from ..constants import PI_CONST, R_CONST, Tref
from ..data import species as DB
from ..kinetics.dsl import RateProgram
from ..kinetics.stoich import Stoichiometry
from ..props import film, thermo
from ..utils.tables import DeviceTables
from . import homo


def _params(values: Mapping[str, Any], dtype, device) -> dict[str, Any]:
    """{name: tensor} of numbers or arrays, in dtype on device."""
    dtype = dtype or config.default_float()
    device = config.resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                               device=device) for k, v in values.items()}


_NO_HEAT = {"OvHeTrCo": 0.0, "EfHeTrAr": 0.0, "MeTe": 0.0}


@dataclass(frozen=True)
class HeteroSpec:
    comp_list: tuple[str, ...]
    stoich: Stoichiometry = field(hash=False, compare=False)
    z_out: int = 25

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)


def build_spec(model_input: Mapping[str, Any], **overrides) -> HeteroSpec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    return HeteroSpec(
        comp_list=comp_list,
        stoich=Stoichiometry(model_input["reactions"], comp_list),
        **overrides,
    )


def build_params(model_input: Mapping[str, Any], dtype=None,
                 device=None) -> dict[str, Any]:
    """M5's numeric parameter dict of tensors on ``device`` (default: the
    CUDA card; without one, a call that names no device raises, see
    config.resolve_device)."""
    oc = model_input["operating-conditions"]
    feed = model_input["feed"]
    re_spec = model_input["reactor"]
    ex_he = model_input.get("external-heat", _NO_HEAT)
    return _params({
        "P0": oc["pressure"],
        "T0": oc["temperature"],
        "MoFri0": feed["mole-fraction"],
        "MoFlRa0": feed["molar-flowrate"],
        "GaMiVi": feed["mixture-viscosity"],
        "U": ex_he["OvHeTrCo"],
        "EfHeTrAr": ex_he["EfHeTrAr"],
        "Tm": ex_he["MeTe"],
        "ReInDi": re_spec["ReInDi"],
        "ReLe": re_spec["ReLe"],
        "PaDi": re_spec["PaDi"],
        "BeVoFr": re_spec["BeVoFr"],
        "CaBeDe": re_spec["CaBeDe"],
    }, dtype, device)


def m5_initial_state(spec: HeteroSpec, p):
    cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
    fi0 = p["MoFlRa0"] * p["MoFri0"]
    flux0 = p["MoFlRa0"] / cr_se_ar
    return torch.cat([fi0, flux0[None], p["T0"][None], p["P0"][None]])


def make_m5_rhs(spec: HeteroSpec):
    idx = spec.comp_idx
    n_comp = spec.n_comp
    st = spec.stoich
    eq_idx = st.eq_idx
    # stoichiometry of the FIRST reaction only (hard-coded kinetics)
    tables = DeviceTables(nu0=st.nu_comp[0], mw=DB.MW[idx],
                          eq_nu=st.eq_nu[0], dh25=st.dh_rxn_25[0])

    def rhs(z, y, p):
        tb = tables(y)
        nu0, mw, eq_nu, dh25 = tb["nu0"], tb["mw"], tb["eq_nu"], tb["dh25"]
        cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
        fi = y[:n_comp]
        flux = y[n_comp]
        T = y[n_comp + 1]
        P = y[n_comp + 2]

        vo_fl = thermo.volumetric_flowrate_ig(P, T, fi)
        conc = fi / vo_fl
        conc_tot = torch.sum(conc)
        mo_fri = conc / conc_tot
        su_ga_ve = flux * T * R_CONST / P

        mi_mo_we = thermo.mixture_molecular_weight(mo_fri, mw, "kg/mol")
        ga_de = thermo.density_ig(mi_mo_we, conc_tot)
        eps = p["BeVoFr"]
        erg_a = 150 * p["GaMiVi"] * su_ga_ve / p["PaDi"] ** 2
        erg_b = (1 - eps) ** 2 / eps**3
        erg_c = 1.75 * ga_de * su_ga_ve**2 / p["PaDi"]
        erg_d = (1 - eps) / eps**3
        dP = -(erg_a * erg_b + erg_c * erg_d)

        # hard-coded first-order kinetics (reference quirk)
        k1 = 8.2e14 * torch.exp(-284.5e3 / (R_CONST * T)) * 1e7
        r0 = k1 * conc[0]
        ri = nu0 * r0 * p["CaBeDe"]
        ov_r = torch.sum(ri)

        cp_mix = thermo.cp_mix(mo_fri, thermo.cp_mean(T, idx))
        en_ch = torch.dot(thermo.cp_mean(T, eq_idx), eq_nu) * (T - Tref)
        ov_he_re_t = r0 * (en_ch + dh25)
        qm = p["U"] * p["EfHeTrAr"] * (p["Tm"] - T)

        dF = (cr_se_ar / eps) * ri
        dT = (-ov_he_re_t + qm) / (flux * cp_mix)
        return torch.cat([dF, ov_r[None], dT[None], dP[None]])

    return rhs


# ---------------------------------------------------------------------------
# M14: steady heterogeneous packed bed with axial dispersion and a lumped
# (rNo = 1) catalyst phase, solved as a nonlinear root problem with ramped
# kinetics continuation.
#
# Reference: PackedBedReactorClass.runM9/modelEquationM9
# (PyREMOT/docs/pbReactor.py:7188-8850), dispatched as M14 via
# rmtCore.py:377-388. State layout (noLayer = compNo+1, rows = rNo+1,
# zNo): row 0 holds the gas phase, row 1 the catalyst surface values.
# Reproduced quirks:
#   * gas/solid concentrations are NOT EPS-clamped (pbReactor.py:8126,8146);
#   * the solid-phase heat of reaction is evaluated at the DIMENSIONLESS
#     temperature Ts* rather than the real one (pbReactor.py:8391-8395);
#   * the Ergun march uses VoFlRa0/CrSeAr while convection is normalized by
#     the user's superficial velocity (pbReactor.py:8236,8479);
#   * rNo is fixed at 1 -- the reference's indexed assignment
#     dxdtMat[i][1][z] = ri_r[:, i] crashes for rNo > 1.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class M14Spec:
    comp_list: tuple[str, ...]
    iso_thermal: bool
    stoich: Stoichiometry = field(hash=False, compare=False)
    rates: RateProgram = field(hash=False, compare=False)
    z_no: int = 30                  # solverSetting['M9']['zNo']

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)


def m14_build_spec(model_input: Mapping[str, Any], **overrides) -> M14Spec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    process_type = model_input["operating-conditions"].get("process-type", "")
    rr = model_input["reaction-rates"]
    return M14Spec(
        comp_list=comp_list,
        iso_thermal=(process_type == "iso-thermal"),
        stoich=Stoichiometry(model_input["reactions"], comp_list),
        rates=RateProgram(rr["VARS"], rr["RATES"]),
        **overrides,
    )


def m14_params(model_input: Mapping[str, Any], dtype=None,
               device=None) -> dict[str, Any]:
    """M14's numeric parameter dict of tensors on ``device`` (default: the
    CUDA card; see build_params)."""
    oc = model_input["operating-conditions"]
    feed = model_input["feed"]
    re_spec = model_input["reactor"]
    ex_he = model_input.get("external-heat", _NO_HEAT)
    p = _params({
        "P0": oc["pressure"],
        "T0": oc["temperature"],
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
        "CaPo": re_spec["CaPo"],
        "CaTo": re_spec["CaTo"],
    }, dtype, device)
    p["kinetic_overrides"] = _params(model_input.get("kinetic-overrides", {}),
                                     p["T0"].dtype, p["T0"].device)
    return p


def m14_feed(spec: M14Spec, p: Mapping[str, Any]) -> dict[str, Any]:
    """Feed scales (homo.t3_feed: the same gas phase) + FIXED transfer
    coefficients (pbReactor.py:7325-7460)."""
    d = homo.t3_feed(spec, p)
    ga_de0, mi_mo_we0 = d["GaDe0"], d["MiMoWe0"]
    vf = p["vf"]
    # fixed gas/solid transfer coefficients from the feed state
    # (MODEL_SETTING MaTrCo/HeTrCo == "FIX", pbReactor.py:7448-7452)
    re0 = film.reynolds(ga_de0, vf, p["PaDi"], p["GaViMix0"])
    sc0 = film.schmidt(ga_de0, p["GaViMix0"], p["GaDii0"])
    sh0 = film.sherwood(sc0, re0, film.FROSSLING)
    pr0 = film.prandtl(d["GaCpMeanMix0"], p["GaViMix0"], p["GaThCoMix0"],
                       mi_mo_we0)
    nu0 = film.nusselt(pr0, re0)
    pa_ra = p["PaDi"] / 2
    d.update({
        "MaTrCo": film.mass_transfer_coefficient(sh0, p["GaDii0"],
                                                 p["PaDi"]),
        "HeTrCo": film.heat_transfer_coefficient(nu0, p["GaThCoMix0"],
                                                 p["PaDi"]),
        "SpSuAr": (3 / pa_ra) * (1 - p["BeVoFr"]),
    })
    return d


def make_m14_residual(spec: M14Spec, mesh=None):
    """Steady residual of the gas/solid system, vectorized over z nodes
    (mirrors modelEquationM9, pbReactor.py:7748-8850, rNo = 1). ramp
    scales the kinetic source (the reference's rampList continuation,
    pbReactor.py:7609-7643). mesh: a two_zone_mesh(...) result for
    solver-config mesh != "normal" (the reference's refined branches,
    pbReactor.py:8532-8565); the axial stencils are T3's
    (homo.AxialStencil), the Ergun march on the uniform-zone dz."""
    idx = spec.comp_idx
    n_comp = spec.n_comp
    z_no = spec.z_no
    st = spec.stoich
    ax = homo.AxialStencil(z_no, mesh)
    tables = DeviceTables(nu=st.nu_comp, eq_nu=st.eq_nu, dh25=st.dh_rxn_25)

    def residual(y, p, d, ramp=1.0):
        tb = tables(y)
        nu_comp, eq_nu, dh25 = tb["nu"], tb["eq_nu"], tb["dh25"]
        Y = y.reshape(n_comp + 1, 2, z_no)
        c_g = Y[:n_comp, 0]                     # gas, dimensionless (raw)
        c_s = Y[:n_comp, 1]                     # solid surface
        T_g = Y[n_comp, 0]
        T_s = Y[n_comp, 1]

        co_g_re = c_g * d["Cmax"]               # NOT clamped (quirk)
        co_s_re = c_s * d["Cmax"]
        co_g_sum = torch.sum(co_g_re, dim=0)
        co_s_sum = torch.sum(co_s_re, dim=0)
        Tg_re = T_g * p["T0"] + p["T0"]
        Ts_re = T_s * p["T0"] + p["T0"]
        mo_fri_g = co_g_re / co_g_sum
        mo_fri_s = co_s_re / co_s_sum
        mi_mo_we = thermo.mixture_molecular_weight(mo_fri_g.T, d["mw"],
                                                   "kg/mol")
        ga_de = thermo.density_ig(mi_mo_we, co_g_sum * 1000.0)
        ga_de_dl = ga_de / d["GaDe0"]
        P_z = ax.ergun_pressure(p, d, ga_de)

        # kinetics at the SOLID state, ramped (pbReactor.py:8330-8345)
        r0 = ramp * spec.rates(Ts_re, P_z, mo_fri_s, co_s_re,
                               p["kinetic_overrides"]).to(y.dtype)
        ri_s = torch.einsum("mk,mz->kz", nu_comp, r0)

        cp_mean_g = thermo.cp_mean(Tg_re, idx)
        cp_mix_g = torch.sum(mo_fri_g.T * cp_mean_g, dim=-1)
        cp_mix_dl = cp_mix_g / d["GaCpMeanMix0"]
        # QUIRK: enthalpy of reaction at the dimensionless Ts
        en_ch = (thermo.cp_mean(T_s, st.eq_idx) @ eq_nu.T) * (
            T_s[..., None] - Tref)
        ov_he_re_t = torch.sum(r0.T * (en_ch + dh25), dim=-1)
        qm = homo._heat_exchange(p["Tm"], Tg_re, p["U"],
                                 p["EfHeTrAr"]) * 1e-3

        eps = p["BeVoFr"]
        v_dl = d["vDl"]

        # film fluxes between phases (dimensionless concentrations x Cmax)
        mo_fli = d["MaTrCo"][:, None] * d["Cmax"] * (c_g - c_s)
        in_flux_T = d["HeTrCo"] * d["SpSuAr"] * p["T0"] * (T_s - T_g) * 1e-3

        # gas mass: backward d1 / central d2, Danckwerts inlet ghost
        dcdz, d2c = ax.derivatives(c_g, ax.mass_ghost(p, d, c_g))
        res_cg = (
            -v_dl * dcdz
            + (eps / d["PeNuMa0"])[:, None] * d2c
            - (d["SpSuAr"] / d["GaMaCoTe0"]) * mo_fli
        )
        # solid mass: film inflow balances the ramped reaction source
        res_cs = mo_fli * d["SpSuAr"] + ri_s

        # gas heat (GaThCoEff_DiLeVa = BeVoFr here, pbReactor.py:8282)
        dtdz, d2t = ax.derivatives(T_g, ax.heat_ghost(d, T_g))
        res_tg = (
            -v_dl * ga_de_dl * cp_mix_dl * dtdz
            + (eps / d["PeNuHe0"]) * d2t
            + (in_flux_T + qm) / d["GaHeCoTe0"]
        )
        # solid heat: reaction exotherm balances the film outflow
        res_ts = (1 - eps) * (-ov_he_re_t) - in_flux_T

        out = torch.cat([torch.stack([res_cg, res_cs], dim=1),
                         torch.stack([res_tg, res_ts], dim=0)[None]], dim=0)
        return out.reshape(-1)

    return residual


def m14_row_scales(spec: M14Spec, p, d):
    """Diagonal row scaling for the M14 solve (flat, same layout as the
    residual). The raw residual mixes O(1) dimensionless gas rows with
    O(1e3) dimensional solid rows (kmol/m^3.s and kJ/m^3.s), which stalls
    both Newton and pseudo-transient continuation; dividing the solid rows
    by their film-transfer scale makes the system O(1) without moving the
    root."""
    s_cm = d["MaTrCo"] * d["Cmax"] * d["SpSuAr"]          # (n_comp,)
    s_T = d["HeTrCo"] * d["SpSuAr"] * p["T0"] * 1e-3
    solid = torch.cat([s_cm, s_T[None]])                 # (n_comp + 1,)
    S = torch.stack([torch.ones_like(solid), solid], dim=1)
    return S[:, :, None].expand(spec.n_comp + 1, 2, spec.z_no).reshape(-1)


def m14_initial_state(spec: M14Spec, p, d):
    """The feed profile: gas and solid at the inlet concentrations,
    theta = 0."""
    c_in = (p["SpCoi0"] / d["Cmax"])[:, None, None].expand(
        spec.n_comp, 2, spec.z_no)
    return torch.cat([c_in, torch.zeros_like(c_in[:1])], dim=0).reshape(-1)


def m14_ramps(model_input: Mapping[str, Any]) -> tuple[float, ...]:
    """solver-config rampList, the kinetics continuation (reference
    solSetting.py:62, pbReactor.py:7615-7643: solve at each ramp in turn
    from the previous solution; default [1] = one full-kinetics solve)."""
    return tuple(float(r) for r in model_input.get(
        "solver-config", {}).get("rampList", [1.0]))


def make_m14_runner(spec: M14Spec, mesh=None, ramp_list=(1.0,)):
    """Pure steady-state M14 solve: pp -> (x, converged, res_norm).

    Pseudo-transient continuation from the feed profile on the row-scaled
    residual, then a damped-Newton polish per rampList entry (reference
    runM9 continuation, pbReactor.py:7615-7643). The member-batched form,
    the design-space sweep, is parallel.ensemble.run_m14_sweep."""
    from ..solvers import newton, radau

    res_fn = make_m14_residual(spec, mesh=mesh)
    ramp_list = tuple(float(r) for r in ramp_list)

    def run(pp):
        d = m14_feed(spec, pp)
        S = m14_row_scales(spec, pp, d)
        y0 = m14_initial_state(spec, pp, d)
        ys, _ = radau.odeint(
            lambda t, yy: res_fn(yy, pp, d, ramp_list[0]) / S, y0,
            torch.tensor([0.0, 20.0], dtype=y0.dtype, device=y0.device),
            rtol=1e-7, atol=1e-10)
        x = ys[-1]
        converged = True
        res_norm = torch.zeros((), dtype=x.dtype, device=x.device)
        for ramp in ramp_list:
            sol = newton.root(lambda yy, r=ramp: res_fn(yy, pp, d, r) / S,
                              x, max_iter=60, tol=1e-8)
            x = sol.x
            converged = converged and bool(sol.converged)
            res_norm = torch.maximum(res_norm, sol.residual_norm)
        return x, converged, res_norm

    return run
