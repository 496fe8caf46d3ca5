# Pseudo-homogeneous packed-bed reactor, steady model N1, dynamic model N2
# and the steady axial-dispersion model T3 (port of the N1, N2 and T3
# slices of rmt_tpu/models/homo.py), dimensionless formulation, as plain
# functions on tensors.
#
# Same math as the reference's modelEquationN1 (PyREMOT/docs/
# pbHomoReactor.py:3017-3314; z is the integration variable) and
# modelEquationN2 (:3706-4134): the per-node python loop becomes tensor
# stencils, the explicit axial pressure march a closed-form affine
# recurrence, and the user's kinetics DSL runs on all axial nodes at once.
# Deliberate quirk-for-quirk reproductions are marked QUIRK with the
# reference line they mirror. Functions take ONE member (state (n,)); the
# ensemble driver maps them over members with torch.func.vmap.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from .. import config
from ..constants import EPS_CONST, PI_CONST, R_CONST, Tref
from ..data import species as DB
from ..kinetics.dsl import RateProgram
from ..kinetics.stoich import Stoichiometry
from ..ops import df32 as _df32
from ..ops import stencils as _stencils
from ..props import thermo, transport
from ..utils.tables import DeviceTables

ISO_THERMAL = "iso-thermal"


@dataclass(frozen=True)
class HomoSpec:
    """Static description of a homogeneous reactor model."""

    comp_list: tuple[str, ...]
    iso_thermal: bool
    stoich: Stoichiometry = field(hash=False, compare=False)
    rates: RateProgram = field(hash=False, compare=False)
    z_no: int = 20          # N2 axial nodes
    t_no: int = 5           # N2 outer time intervals
    times_no: int = 5       # N2 saved points per interval
    z_out: int = 100        # N1 output points (zNo in solverSetting['N1'])

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)

    @property
    def var_no_n1(self) -> int:
        return self.n_comp + (1 if self.iso_thermal else 2)

    @property
    def var_no_n2(self) -> int:
        return self.n_comp + (0 if self.iso_thermal else 1)


def build_spec(model_input: Mapping[str, Any], **solver_overrides) -> HomoSpec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    process_type = model_input["operating-conditions"].get(
        "process-type", ISO_THERMAL)
    stoich = Stoichiometry(model_input["reactions"], comp_list)
    rates = RateProgram(
        model_input["reaction-rates"]["VARS"],
        model_input["reaction-rates"]["RATES"],
    )
    return HomoSpec(
        comp_list=comp_list,
        iso_thermal=(process_type == ISO_THERMAL),
        stoich=stoich,
        rates=rates,
        **solver_overrides,
    )


def build_params(model_input: Mapping[str, Any], dtype=None,
                 device=None) -> dict[str, Any]:
    """Numeric parameter dict of tensors (every leaf may be swept), on
    ``device`` (default: the CUDA card; without one, a call that names no
    device raises, see config.resolve_device)."""
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
        "opT": f(oc.get("period", 1.0)),
        "VoFlRa0": f(feed["volumetric-flowrate"]),
        "SpCoi0": f(feed["concentration"]),
        "U": f(ex_he["OvHeTrCo"]),
        "Tm": f(ex_he["MeTe"]),
        "ReInDi": f(re_spec["ReInDi"]),
        "ReLe": f(re_spec["ReLe"]),
        "PaDi": f(re_spec["PaDi"]),
        "BeVoFr": f(re_spec["BeVoFr"]),
        "CaBeDe": f(re_spec["CaBeDe"]),
        "kinetic_overrides": {
            k: f(v) for k, v in model_input.get("kinetic-overrides", {}).items()
        },
    }


def feed_state(spec: HomoSpec, p: Mapping[str, Any]) -> dict[str, Any]:
    """Inlet/feed-derived reference scales (pbHomoReactor.py:2744-2827)."""
    idx = spec.comp_idx
    T0 = p["T0"]
    mw = torch.as_tensor(DB.MW[idx], dtype=T0.dtype, device=T0.device)

    cr_se_ar = PI_CONST * p["ReInDi"] ** 2 / 4
    sp_coi0 = p["SpCoi0"]
    sp_co0 = torch.sum(sp_coi0)
    su_ga_ve0 = p["VoFlRa0"] / cr_se_ar
    in_ga_ve0 = p["VoFlRa0"] / (cr_se_ar * p["BeVoFr"])
    mo_fri0 = sp_coi0 / sp_co0

    ga_vii0 = transport.viscosity(T0, idx)
    ga_mi_vi = transport.wilke_mixture(ga_vii0, mo_fri0, mw)

    cp_mean0 = thermo.cp_mean(T0, idx)                  # [kJ/kmol.K]
    cp_mix0 = thermo.cp_mix(mo_fri0, cp_mean0)
    mi_mo_we0 = thermo.mixture_molecular_weight(mo_fri0, mw, "kg/mol")
    ga_de0 = thermo.density_ig(mi_mo_we0, sp_co0)

    # QUIRK: MODEL_SETTING['GaMaCoTe0'] == "MAX" -- the mass convective
    # reference scale uses max(Cif) for every species, and dimensionless
    # concentrations are y_i = C_i / max(C_f) (modelSetting.py:17,
    # pbHomoReactor.py:2819-2821,2833)
    c_max = torch.max(sp_coi0)
    vf = su_ga_ve0
    zf = p["ReLe"]
    ga_ma_co_te0 = (vf / zf) * c_max
    ga_he_co_te0 = ga_de0 * vf * T0 * (cp_mix0 / mi_mo_we0) / zf

    # QUIRK: the heat-exchange area term is always 4/ReInDi, the user's
    # EfHeTrAr input is ignored (pbHomoReactor.py:2778,3411)
    a_eff = 4 / p["ReInDi"]

    return {
        "mw": mw,
        "CrSeAr": cr_se_ar,
        "SpCo0": sp_co0,
        "SuGaVe0": su_ga_ve0,
        "InGaVe0": in_ga_ve0,
        "MoFri0": mo_fri0,
        "GaMiVi": ga_mi_vi,
        "GaCpMeanMix0": cp_mix0,
        "MiMoWe0": mi_mo_we0,
        "GaDe0": ga_de0,
        "Cmax": c_max,
        "vf": vf,
        "zf": zf,
        "GaMaCoTe0": ga_ma_co_te0,
        "GaHeCoTe0": ga_he_co_te0,
        "aEff": a_eff,
    }


def _heat_exchange(Tm, T, U, a):
    """Qm [J/m^3.s]; Tm == 0 means adiabatic (rmtUtility.py:437-444)."""
    return torch.where(Tm == 0, torch.zeros_like(T), U * a * (Tm - T))


def _reaction_energetics(spec: HomoSpec, T_real):
    """Heat of reaction at T [kJ/kmol] per reaction (rmtThermo.py:258-312).
    T_real scalar (N1) or (zNo,) (N2) -> (..., n_rxn)."""
    st = spec.stoich
    eq_cp_mean = thermo.cp_mean(T_real, st.eq_idx)      # (z, n_eq)
    eq_nu = torch.as_tensor(st.eq_nu, dtype=T_real.dtype,
                            device=T_real.device)
    en_ch = (eq_cp_mean @ eq_nu.T) * (T_real[..., None] - Tref)
    return en_ch + torch.as_tensor(st.dh_rxn_25, dtype=T_real.dtype,
                                   device=T_real.device)


# ---------------------------------------------------------------------------
# N1: steady-state dimensionless model (z is the integration variable)
# ---------------------------------------------------------------------------

def n1_initial_state(spec: HomoSpec, p, d):
    iv_c = p["SpCoi0"] / d["Cmax"]                     # pbHomoReactor.py:2833
    iv = [iv_c, torch.ones_like(iv_c[:1])]             # P/Pf = 1
    if not spec.iso_thermal:
        iv.append(torch.zeros_like(iv_c[:1]))          # theta = (T-Tf)/Tf = 0
    return torch.cat(iv)


def make_n1_rhs(spec: HomoSpec):
    """RHS of the steady model for one member: rhs(z, y (var_no_n1,), p,
    d) (mirrors modelEquationN1, pbHomoReactor.py:3017-3314)."""
    idx = spec.comp_idx
    n_comp = spec.n_comp

    def rhs(z, y, p, d):
        nu_comp = torch.as_tensor(spec.stoich.nu_comp, dtype=y.dtype,
                                  device=y.device)
        co_spi = y[:n_comp]
        P_dl = y[n_comp]
        T_dl = y[n_comp + 1] if not spec.iso_thermal else y.new_zeros(())

        co_spi_re = co_spi * d["Cmax"]
        co_sp_re = torch.sum(co_spi_re)
        T_re = T_dl * p["T0"] + p["T0"]
        P_re = P_dl * p["P0"]
        mo_fri = co_spi_re / co_sp_re

        # velocity from EOS (rmtUtility.py:405-421)
        in_ga_ve = d["InGaVe0"] * (co_sp_re / d["SpCo0"]) * (p["P0"] / P_re)
        in_ga_ve_dl = in_ga_ve / d["InGaVe0"]
        su_ga_ve = in_ga_ve * p["BeVoFr"]
        su_ga_ve_dl = su_ga_ve / d["SuGaVe0"]

        mi_mo_we = thermo.mixture_molecular_weight(mo_fri, d["mw"], "kg/mol")
        ga_de_eos = thermo.density_ig_eos(P_re, T_re, mi_mo_we)
        ga_de_dl = ga_de_eos / d["GaDe0"]

        # Ergun momentum balance (pbHomoReactor.py:3214-3220)
        eps = p["BeVoFr"]
        erg_a = 150 * d["GaMiVi"] * su_ga_ve / p["PaDi"] ** 2
        erg_b = (1 - eps) ** 2 / eps**3
        erg_c = 1.75 * ga_de_eos * su_ga_ve**2 / p["PaDi"]
        erg_d = (1 - eps) / eps**3
        dxdt_p = -(erg_a * erg_b + erg_c * erg_d) / (p["P0"] / d["zf"])

        # kinetics: DSL program -> reaction rates -> formation rates
        r0 = spec.rates(T_re, P_re, mo_fri, co_spi_re,
                        p["kinetic_overrides"]).to(y.dtype)    # (n_rxn,)
        ri = r0 @ nu_comp                               # (n_comp,)

        # energy balance pieces
        cp_mean_i = thermo.cp_mean(T_re, idx)
        cp_mix = thermo.cp_mix(mo_fri, cp_mean_i)
        cp_mix_dl = cp_mix / d["GaCpMeanMix0"]
        cp_mix_eff_dl = cp_mix_dl * eps
        he_re_t = _reaction_energetics(spec, T_re)      # (n_rxn,)
        ov_he_re_t = torch.dot(r0, he_re_t)
        qm = _heat_exchange(p["Tm"], T_re, p["U"], d["aEff"])

        dxdt_c = (1 / su_ga_ve_dl) * (ri / d["GaMaCoTe0"])
        out = [dxdt_c, dxdt_p[None]]
        if not spec.iso_thermal:
            const_t1 = 1 / (ga_de_dl * cp_mix_eff_dl * in_ga_ve_dl)
            dxdt_t = const_t1 * ((-ov_he_re_t + qm) / d["GaHeCoTe0"])
            out.append(dxdt_t[None])
        return torch.cat(out)

    return rhs


# ---------------------------------------------------------------------------
# N2: dynamic dimensionless model (method of lines in z, time integration)
# ---------------------------------------------------------------------------

def n2_initial_state(spec: HomoSpec, p, d):
    c0 = (p["SpCoi0"] / d["Cmax"])[:, None] * torch.ones(
        (1, spec.z_no), dtype=p["SpCoi0"].dtype, device=p["SpCoi0"].device)
    rows = [c0]
    if not spec.iso_thermal:
        rows.append(torch.zeros_like(c0[:1]))
    return torch.cat(rows, dim=0).reshape(-1)


def make_n2_rhs(spec: HomoSpec, frozen_pressure_jac: bool = False,
                accurate_rates=False):
    """RHS of the dynamic model for one member: rhs(t, y (n,), p, d).

    frozen_pressure_jac=True detaches the axial pressure march, making
    the Jacobian exactly block-bidiagonal in z; use it ONLY to build the
    stage-solve Jacobian blocks (residuals use the exact RHS).

    accurate_rates="df32" evaluates the kinetics chain, the
    stoichiometric sum nu@R and the r-weighted heat-of-reaction sum in
    compensated double-float32 pairs (ops/df32.py). accurate_rates=True
    evaluates the same chain in float64 inside an evaluation in the
    state's dtype: its inputs (temperature, pressure, mole fractions,
    concentrations) are cast up, and nu@R and the heat-of-reaction sum
    are cast back to the state's dtype (near equilibrium nu@R is a small
    difference of large rates, so float32 rate rounding is amplified
    about 1e3 times). accurate_rates=False evaluates everything in the
    dtype of the state (f32 or f64).
    """
    if accurate_rates not in (False, True, "df32"):
        raise ValueError(
            "make_n2_rhs supports accurate_rates False, True or 'df32'")
    idx = spec.comp_idx
    n_comp = spec.n_comp
    z_no = spec.z_no
    var_no = spec.var_no_n2
    dz = 1.0 / (z_no - 1)
    df32_mode = accurate_rates == "df32"

    def rhs(t, y, p, d):
        Y = y.reshape(var_no, z_no)
        c_raw = Y[:n_comp]                              # (n_comp, zNo)
        # QUIRK: concentrations are clamped at EPS for the source/kinetics
        # path but the *raw* center value feeds the convection stencil
        # (pbHomoReactor.py:3899 vs 4086)
        c_clamped = torch.clamp(c_raw, min=EPS_CONST)
        T_dl = Y[n_comp] if not spec.iso_thermal else torch.zeros_like(Y[0])
        nu_comp = torch.as_tensor(spec.stoich.nu_comp, dtype=y.dtype,
                                  device=y.device)

        co_spi_re = c_clamped * d["Cmax"]
        T_re = T_dl * p["T0"] + p["T0"]
        mo_fri = co_spi_re / torch.sum(co_spi_re, dim=0, keepdim=True)
        mi_mo_we = thermo.mixture_molecular_weight(mo_fri.T, d["mw"],
                                                   "kg/mol")

        # frozen-velocity assumption: v_z[z+1] = v_z[z] = SuGaVe0
        # (QUIRK, pbHomoReactor.py:4066)
        su_ga_ve = d["SuGaVe0"]
        v_dl = su_ga_ve / d["vf"]
        in_ga_ve_dl = (su_ga_ve / p["BeVoFr"]) / d["InGaVe0"]

        # explicit axial pressure march (QUIRK: an algebraic forward-Euler
        # update inside the RHS, pbHomoReactor.py:3970-3979), solved in
        # closed form: P_{z+1} = a_z*P_z + b
        eps = p["BeVoFr"]
        erg_a = 150 * d["GaMiVi"] * su_ga_ve / p["PaDi"] ** 2
        erg_b = (1 - eps) ** 2 / eps**3
        erg_c_coef = 1.75 * su_ga_ve**2 / p["PaDi"]
        erg_d = (1 - eps) / eps**3
        rg_t = (R_CONST / mi_mo_we) * T_re              # (zNo,)
        if frozen_pressure_jac:
            rg_t = rg_t.detach()

        a_co = 1.0 - (erg_c_coef * erg_d / rg_t) * dz
        b_co = -(erg_a * erg_b) * dz
        A_cum = torch.cat([torch.ones_like(a_co[:1]),
                           torch.cumprod(a_co[:-1], dim=0)])
        D = b_co / (A_cum * a_co)
        S = torch.cat([torch.zeros_like(a_co[:1]),
                       torch.cumsum(D[:-1], dim=0)])
        P_z = A_cum * (p["P0"] + S)

        ga_de_eos = P_z / rg_t
        ga_de_dl = ga_de_eos / d["GaDe0"]

        ko = p["kinetic_overrides"]
        # the kinetics chain's dtype: float64 under accurate_rates=True
        hi = torch.float64 if accurate_rates and not df32_mode else y.dtype
        if df32_mode:
            DF = _df32.DF32.from_value
            r0_df = spec.rates(DF(T_re), DF(P_z), DF(mo_fri), DF(co_spi_re),
                               ko)                      # DF32 (n_rxn, zNo)
            nu32 = nu_comp.to(torch.float32)
            ri_df = None                                # nu^T @ r0, pairs
            for m in range(nu32.shape[0]):
                term = r0_df[m] * nu32[m][:, None]      # DF32 (n_comp, zNo)
                ri_df = term if ri_df is None else ri_df + term
            ri = ri_df.value(y.dtype)
        else:
            r0 = spec.rates(T_re.to(hi), P_z.to(hi), mo_fri.to(hi),
                            co_spi_re.to(hi), ko).to(hi)  # (n_rxn, z)
            ri = torch.einsum("mk,mz->kz", nu_comp.to(hi), r0).to(y.dtype)

        cp_mean_i = thermo.cp_mean(T_re, idx)           # (zNo, n_comp)
        cp_mix = torch.sum(mo_fri.T * cp_mean_i, dim=-1)
        cp_mix_dl = cp_mix / d["GaCpMeanMix0"]
        cp_mix_eff_dl = cp_mix_dl * eps
        he_re_t = _reaction_energetics(spec, T_re.to(hi))  # (zNo, n_rxn)
        if df32_mode:
            # energetics stay plain f32; the r0-weighted sum keeps the
            # rate pairs so no re-rounding enters
            he32 = he_re_t.to(torch.float32)
            ov_df = None
            for m in range(nu32.shape[0]):
                term = r0_df[m] * he32[:, m]
                ov_df = term if ov_df is None else ov_df + term
            ov_he_re_t = ov_df.value(y.dtype)
        else:
            ov_he_re_t = torch.sum(r0.T * he_re_t, dim=-1).to(y.dtype)
        qm = _heat_exchange(p["Tm"], T_re, p["U"], d["aEff"])

        const_f1 = 1 / (eps * (d["zf"] / d["vf"]))
        const_t2 = 1 / (ga_de_dl * cp_mix_dl * eps * (d["zf"] / d["vf"]))

        # backward-difference convection with inlet BC1
        # (pbHomoReactor.py:4082-4099)
        c_in = (p["SpCoi0"] / d["Cmax"])[:, None]
        c_back = torch.cat([c_in, c_clamped[:, :-1]], dim=1)
        dcdz = (c_raw - c_back) / dz
        dxdt_c = const_f1 * (-v_dl * dcdz + ri / d["GaMaCoTe0"])

        rows = [dxdt_c]
        if not spec.iso_thermal:
            t_back = torch.cat([torch.zeros_like(T_dl[:1]), T_dl[:-1]])
            dtdz = (T_dl - t_back) / dz
            convective = -in_ga_ve_dl * ga_de_dl * cp_mix_eff_dl * dtdz
            formation = -ov_he_re_t / d["GaHeCoTe0"]
            exchange = qm / d["GaHeCoTe0"]
            dxdt_t = const_t2 * (convective + formation + exchange)
            rows.append(dxdt_t[None])

        return torch.cat(rows, dim=0).reshape(-1)

    return rhs


def make_n2_colored_jacobian(spec: HomoSpec):
    """Per-member dense (n, n) Jacobian of the N2 RHS for the
    Newton-Schulz preconditioners: with the pressure march frozen it is
    block bidiagonal in z, so 2*var_no colored JVPs
    (ops.jacobian.colored_jacobian) give it exactly."""
    from ..ops.jacobian import colored_jacobian

    return colored_jacobian(
        make_n2_rhs(spec, frozen_pressure_jac=True), spec.var_no_n2,
        spec.z_no
    )


def make_n2_bidiag_blocks(spec: HomoSpec):
    """Per-member (Jd, Jl) block Jacobian of the N2 RHS, each
    (z_no, var_no, var_no), gathered from 2*var_no colored JVPs
    (ops.jacobian.colored_bidiag_blocks) of the frozen-pressure RHS."""
    from ..ops.jacobian import colored_bidiag_blocks

    return colored_bidiag_blocks(
        make_n2_rhs(spec, frozen_pressure_jac=True), spec.var_no_n2,
        spec.z_no
    )


def _member_last(tree):
    """(B, k) leaves of a member-first parameter dict as (k, B); (B,)
    leaves and the kinetic overrides as they are."""
    return {k: (_member_last(v) if isinstance(v, Mapping)
                else v.T if v.dim() == 2 else v) for k, v in tree.items()}


def make_n2_rhs_b(spec: HomoSpec, frozen_pressure_jac: bool = False,
                  accurate_rates=False):
    """Natively batched N2 RHS with a member-last internal layout:
    rhs_b(t (B,), y (B, n), p, d) -> (B, n), the leaves of p and d
    broadcast to a leading member axis ((B,) scalars, (B, n_comp)
    vectors). Same math as make_n2_rhs, quirks included.

    It is the fused RHS kernel's plain-PyTorch core
    (ops/cuda_rhs.n2_core_ml) on Y (var, z, B), so its float32 evaluation
    takes the kernel's order of operations; float64 states evaluate with
    float64 constants. Only accurate_rates False or "df32" (rmt_tpu's
    make_n2_rhs_b: the float64-kinetics legs keep the vmapped RHS).
    frozen_pressure_jac as in make_n2_rhs."""
    from ..ops import cuda_rhs

    if accurate_rates not in (False, "df32"):
        raise ValueError(
            "make_n2_rhs_b supports accurate_rates False or 'df32' only")
    df32_mode = accurate_rates == "df32"
    var_no, z_no = spec.var_no_n2, spec.z_no

    def rhs(t, y, p, d):
        Bsz = y.shape[0]
        Y = y.reshape(Bsz, var_no, z_no).permute(1, 2, 0)  # (var, z, B)
        out = cuda_rhs.n2_core_ml(spec, df32_mode, Y, _member_last(p),
                                  _member_last(d),
                                  frozen_pressure=frozen_pressure_jac)
        return out.permute(2, 0, 1).reshape(Bsz, -1)

    return rhs


def make_n2_colored_jacobian_b(spec: HomoSpec):
    """Batched colored Jacobian (B, n, n) through the member-last RHS
    with the pressure march frozen: 2*var_no JVP tangents broadcast
    across the batch (members never mix)."""
    from ..ops.jacobian import banded_coloring, batched_colored_jacobian

    rhs_b = make_n2_rhs_b(spec, frozen_pressure_jac=True)
    coloring = banded_coloring(spec.var_no_n2, spec.z_no)

    def jac(t, y, p, d):
        return batched_colored_jacobian(lambda yy: rhs_b(t, yy, p, d),
                                        coloring)(y)

    return jac


# ---------------------------------------------------------------------------
# T3: steady axial-dispersion pseudo-homogeneous model, posed as a nonlinear
# root problem F(y) = 0 (reference: PyREMOT/examples/homoModels.py:49-539,
# the runT1 routine, and :540-1421, modelEquationT1; the reference registers
# it as T3Init, rmtCore.py:440-449, but never routes "T3"). Both mesh
# branches: uniform (solver-config mesh == "normal") and the two-zone
# refined mesh (ops/stencils.two_zone_mesh).
# ---------------------------------------------------------------------------

def t3_params(model_input: Mapping[str, Any], dtype=None,
              device=None) -> dict[str, Any]:
    """build_params + the transport feed fields T3 needs
    (homoModels.py:105-134)."""
    p = build_params(model_input, dtype=dtype, device=device)
    feed = model_input["feed"]
    ex_he = model_input.get(
        "external-heat", {"OvHeTrCo": 0.0, "EfHeTrAr": 0.0, "MeTe": 0.0})

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=p["T0"].dtype, device=p["T0"].device)

    p.update({
        # vf: the user-given superficial velocity (homoModels.py:113,294)
        "vf": f(feed["superficial-velocity"]),
        "GaDii0": f(feed["diffusivity"]),
        "GaThCoMix0": f(feed["mixture-thermal-conductivity"]),
        "GaViMix0": f(feed["mixture-viscosity"]),
        # T3 uses the user's heat-transfer area as given -- unlike N1/N2's
        # 4/ReInDi quirk (homoModels.py:1099-1104)
        "EfHeTrAr": f(ex_he["EfHeTrAr"]),
    })
    return p


def t3_feed(spec, p: Mapping[str, Any]) -> dict[str, Any]:
    """Feed scales for T3 (homoModels.py:280-340), and the gas phase of
    M14 (models/hetero.m14_feed).

    Differences vs feed_state (the N-models): SpCoi0 is taken in kmol/m^3
    and density uses SpCo0*1000; the heat convective scale carries a 1e-3
    (kJ) factor; Peclet numbers appear because of the dispersion terms.
    """
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
    # MAX-mode scalar mass scale (homoModels.py:304-307)
    ga_ma_co_te0 = (vf / zf) * c_max
    # heat convective scale in kJ (homoModels.py:310)
    ga_he_co_te0 = (ga_de0 * vf * p["T0"] * (cp_mix0 / mi_mo_we0) / zf) * 1e-3
    pe_ma0 = vf * zf / p["GaDii0"]                     # (n_comp,)
    pe_he0 = zf * ga_de0 * (cp_mix0 / mi_mo_we0) * vf / p["GaThCoMix0"]
    # QUIRK: the Ergun equation uses VoFlRa0/CrSeAr while convection uses
    # its ratio to the user's vf (homoModels.py:928,1141)
    su_ga_ve0 = p["VoFlRa0"] / cr_se_ar
    return {
        "mw": mw,
        "Cmax": c_max,
        "MiMoWe0": mi_mo_we0,
        "GaDe0": ga_de0,
        "GaCpMeanMix0": cp_mix0,
        "GaMaCoTe0": ga_ma_co_te0,
        "GaHeCoTe0": ga_he_co_te0,
        "PeNuMa0": pe_ma0,
        "PeNuHe0": pe_he0,
        "SuGaVe0eq": su_ga_ve0,
        "vDl": su_ga_ve0 / vf,
    }


def t3_initial_guess(spec: HomoSpec, dtype=None, device=None):
    """Flat initial iterate: C* = 0.5, theta = 0.25 (homoModels.py:235-258)."""
    n_layer = spec.n_comp + (0 if spec.iso_thermal else 1)
    g = torch.full((n_layer, spec.z_no), 0.5,
                   dtype=dtype or config.default_float(),
                   device=config.resolve_device(device))
    if not spec.iso_thermal:
        g[-1] = 0.25
    return g.reshape(-1)


class AxialStencil:
    """The axial stencils of an axial-dispersion model on its mesh (the
    uniform grid, or a two_zone_mesh(...) result): the per-node weight
    rows of ops/stencils.axial_stencil_weights (backward first
    derivative, central second derivative), the spacing of the Danckwerts
    inlet ghost (dz_bc1), and the dz of the Ergun march, which stays the
    UNIFORM-zone dz on a refined mesh, as the reference keeps it
    (homoModels.py:963). The weight tables go to a device once per dtype
    and device."""

    def __init__(self, z_no: int, mesh=None):
        ws = _stencils.axial_stencil_weights(z_no, mesh)
        self.weights = DeviceTables(W1=ws["W1"], W2=ws["W2"])
        self.dz_bc1 = ws["dz_bc1"]
        self.dz = (float(mesh["dz_uniform"]) if mesh is not None
                   else 1.0 / (z_no - 1))

    def derivatives(self, F, ghost):
        """(dF/dz, d2F/dz2) of profiles F (..., zNo) with the inlet ghost
        value(s) ghost and the zero-gradient outlet mirror."""
        w = self.weights(F)
        return (_stencils.apply_axial_weights(w["W1"], F, ghost),
                _stencils.apply_axial_weights(w["W2"], F, ghost))

    def ergun_pressure(self, p, d, ga_de):
        """The Ergun pressure at every node: no P feedback, so a prefix
        sum (homoModels.py:950-966, pbReactor.py:8231-8240)."""
        eps = p["BeVoFr"]
        su0 = d["SuGaVe0eq"]
        erg_a = 150 * p["GaViMix0"] * su0 / p["PaDi"] ** 2
        erg_b = (1 - eps) ** 2 / eps**3
        erg_c = 1.75 * ga_de * su0**2 / p["PaDi"]       # (zNo,)
        erg_d = (1 - eps) / eps**3
        rhs_erg = -(erg_a * erg_b + erg_c * erg_d)
        return p["P0"] + self.dz * torch.cat(
            [torch.zeros_like(rhs_erg[:1]), torch.cumsum(rhs_erg[:-1], 0)])

    def mass_ghost(self, p, d, c):
        """The Danckwerts inlet ghost of the dimensionless concentrations
        c (n_comp, zNo), (n_comp, 1)."""
        inv_m = 1.0 / (d["PeNuMa0"] * self.dz_bc1)      # (n_comp,)
        c_in = p["SpCoi0"] / d["Cmax"]
        return ((c_in + inv_m * c[:, 1]) / (inv_m + 1.0))[:, None]

    def heat_ghost(self, d, T_dl):
        """The Danckwerts inlet ghost of the dimensionless temperature
        (T*_in = 0)."""
        inv_h = 1.0 / (d["PeNuHe0"] * self.dz_bc1)
        return (inv_h * T_dl[1]) / (inv_h + 1.0)


def make_t3_residual(spec: HomoSpec, mesh=None):
    """Steady residual F(y) of the axial-dispersion model, vectorized over
    the z nodes (mirrors modelEquationT1, homoModels.py:540-1421).

    Stencils (solverSetting['T1']: dFdz=BD, d2Fdz2=CD) as per-node weight
    rows (AxialStencil): backward first derivative (non-uniform in the
    dense zone of a refined mesh), central second derivative with a
    Danckwerts ghost node at the inlet and a zero-gradient mirror at the
    outlet; the raw (unclamped) state feeds the stencils while kinetics
    and properties see EPS-clamped concentrations (homoModels.py:885-894).

    mesh: a two_zone_mesh(...) result for solver-config mesh != "normal"
    (reference FiDiMeshGenerator path, homoModels.py:149-161); None for
    the uniform grid.
    """
    n_comp = spec.n_comp
    z_no = spec.z_no
    n_layer = n_comp + (0 if spec.iso_thermal else 1)
    ax = AxialStencil(z_no, mesh)
    tables = DeviceTables(nu=spec.stoich.nu_comp)

    def residual(y, p, d):
        Y = y.reshape(n_layer, z_no)
        c_raw = Y[:n_comp]
        T_dl = Y[n_comp] if not spec.iso_thermal else torch.zeros(
            (z_no,), dtype=y.dtype, device=y.device)

        c_cl = torch.clamp(c_raw, min=EPS_CONST)
        co_spi_re = c_cl * d["Cmax"]                    # (n_comp, zNo) kmol/m^3
        co_sp_re = torch.sum(co_spi_re, dim=0)
        T_re = T_dl * p["T0"] + p["T0"]
        mo_fri = co_spi_re / co_sp_re
        mi_mo_we = thermo.mixture_molecular_weight(mo_fri.T, d["mw"],
                                                   "kg/mol")
        ga_de = thermo.density_ig(mi_mo_we, co_sp_re * 1000.0)
        ga_de_dl = ga_de / d["GaDe0"]
        P_z = ax.ergun_pressure(p, d, ga_de)

        # kinetics at every node (homoModels.py:1023-1037)
        r0 = spec.rates(T_re, P_z, mo_fri, co_spi_re,
                        p["kinetic_overrides"]).to(y.dtype)  # (n_rxn, zNo)
        ri = torch.einsum("mk,mz->kz", tables(y)["nu"], r0)

        cp_mean_i = thermo.cp_mean(T_re, spec.comp_idx)
        cp_mix = torch.sum(mo_fri.T * cp_mean_i, dim=-1)
        cp_mix_dl = cp_mix / d["GaCpMeanMix0"]
        ov_he_re_t = torch.sum(r0.T * _reaction_energetics(spec, T_re),
                               dim=-1)
        # Qm in kJ/m^3.s with the user's EfHeTrAr (homoModels.py:1099-1112)
        qm = _heat_exchange(p["Tm"], T_re, p["U"], p["EfHeTrAr"]) * 1e-3

        eps = p["BeVoFr"]
        v_dl = d["vDl"]
        dcdz, d2c = ax.derivatives(c_raw, ax.mass_ghost(p, d, c_raw))
        res_c = (
            -v_dl * dcdz
            + (eps / d["PeNuMa0"])[:, None] * d2c
            + ri / d["GaMaCoTe0"]
        )

        rows = [res_c]
        if not spec.iso_thermal:
            dtdz, d2t = ax.derivatives(T_dl, ax.heat_ghost(d, T_dl))
            res_t = (
                -v_dl * ga_de_dl * cp_mix_dl * dtdz
                + (1.0 / d["PeNuHe0"]) * d2t
                + (-ov_he_re_t + qm) / d["GaHeCoTe0"]
            )
            rows.append(res_t[None])

        return torch.cat(rows, dim=0).reshape(-1)

    return residual
