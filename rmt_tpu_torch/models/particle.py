# Single catalyst-particle diffusion-reaction models (reference ids T1, T2;
# port of rmt_tpu/models/particle.py), as plain functions on tensors.
#
# T1: dynamic dimensionless particle (Cs_i, Ts over the radial grid),
# spherical FDM with a Robin gas-solid interface BC
# (reference: PyREMOT/examples/particleModels.py:59-1103), or the same
# equations on the 7-point orthogonal-collocation basis.
# T2: the steady version solved as a root problem on the same residuals
# (reference: particleModels.py:1108-2212), on the FDM, OC or OCFE grid.
#
# The reference's OC branch crashes upstream (buildOrCoMatrix indexes an
# empty const3 tuple, solvers/solCatParticle.py:150,198); rmt_tpu
# reconstructs the intended OC and OCFE systems, and this port keeps its
# reconstruction (ops/oc_particle.py, ops/ocfe.py). Each function takes
# ONE particle (state (n,)); the integrators map stages with
# torch.func.vmap.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from .. import config
from ..constants import EPS_CONST
from ..data import species as DB
from ..kinetics.dsl import RateProgram
from ..kinetics.stoich import Stoichiometry
from ..ops import oc_particle, ocfe, particle_fd
from ..props import film, thermo, transport
from ..utils.tables import DeviceTables
from .homo import _reaction_energetics

ISO_THERMAL = "iso-thermal"


@dataclass(frozen=True)
class ParticleSpec:
    comp_list: tuple[str, ...]
    iso_thermal: bool
    stoich: Stoichiometry = field(hash=False, compare=False)
    rates: RateProgram = field(hash=False, compare=False)
    r_no: int = 7            # solverSetting['ParticleModel']['rNo']['fdm']
    t_no: int = 10           # outer time intervals
    times_no: int = 5

    @property
    def n_comp(self) -> int:
        return len(self.comp_list)

    @property
    def comp_idx(self) -> np.ndarray:
        return DB.species_indices(self.comp_list)

    @property
    def n_layer(self) -> int:
        return self.n_comp + (0 if self.iso_thermal else 1)


def build_spec(model_input: Mapping[str, Any], **overrides) -> ParticleSpec:
    comp_list = tuple(model_input["feed"]["components"]["shell"])
    process_type = model_input["operating-conditions"].get(
        "process-type", ISO_THERMAL)
    return ParticleSpec(
        comp_list=comp_list,
        iso_thermal=(process_type == ISO_THERMAL),
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
    tc = model_input.get("test-const", {})

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    return {
        "P0": f(oc["pressure"]),
        "T0": f(oc["temperature"]),
        "opT": f(oc.get("period", 1.0)),
        "SpCoi0": f(feed["concentration"]),
        "SuGaVe0": f(feed.get("superficial-velocity", 0.0)),
        "GaDii0": f(feed.get("diffusivity", np.zeros(1))),
        "GaThCoMix0": f(feed.get("mixture-thermal-conductivity", 0.0)),
        "PaDi": f(re_spec["PaDi"]),
        "CaPo": f(re_spec["CaPo"]),
        "CaTo": f(re_spec["CaTo"]),
        "CaDe": f(re_spec["CaDe"]),
        "CaSpHeCa": f(re_spec["CaSpHeCa"]),
        "CaThCo": f(re_spec.get("CaThCo", 0.0)),
        "BeVoFr": f(re_spec["BeVoFr"]),
        # frozen transport/bulk oracle values (T1; reference tests)
        "MaTrCo": f(tc.get("MaTrCo0", np.zeros(1))),
        "HeTrCo": f(tc.get("HeTrCo0", 0.0)),
        "Cbi": f(tc.get("Cbi", np.zeros(1))),
        "Tb": f(tc.get("Tb", 0.0)),
        "kinetic_overrides": {
            k: f(v) for k, v in model_input.get("kinetic-overrides", {}).items()
        },
    }


def _particle_state(spec: ParticleSpec, y, p, nu: DeviceTables):
    """The pieces every particle equation reads from a state y (n,):
    clamped dimensionless concentrations cs (n_comp, rNo), the
    dimensionless temperature ts (rNo,), real concentrations and
    temperature, the kinetics r0 (n_rxn, rNo) at the bulk pressure and
    the formation rates ri_r (n_comp, rNo)."""
    n_comp, r_no = spec.n_comp, spec.r_no
    Y = y.reshape(spec.n_layer, r_no)
    cs = torch.clamp(Y[:n_comp], min=EPS_CONST)
    c_max = torch.max(p["SpCoi0"])
    cs_re = cs * c_max
    ts = Y[n_comp] if not spec.iso_thermal else torch.zeros(
        (r_no,), dtype=y.dtype, device=y.device)
    ts_re = ts * p["T0"] + p["T0"]
    cos_sp_re = torch.sum(cs_re, dim=0)                  # (rNo,)
    mo_fri = cs_re / cos_sp_re                           # (n_comp, rNo)
    r0 = spec.rates(ts_re, p["P0"], mo_fri, cs_re,
                    p["kinetic_overrides"]).to(y.dtype)  # (n_rxn, rNo)
    ri_r = torch.einsum("mk,mz->kz", nu(y)["nu"], r0)
    return dict(Y=Y, cs=cs, c_max=c_max, ts=ts, ts_re=ts_re,
                cos_sp_re=cos_sp_re, mo_fri=mo_fri, r0=r0, ri_r=ri_r)


def _overall_heat(spec, s):
    """The overall heat of reaction at each radial node [kJ/m^3.s]."""
    return torch.sum(s["r0"].T * _reaction_energetics(spec, s["ts_re"]),
                     dim=-1)


def _cp_eff(spec, s, p):
    """The particle's effective volumetric heat capacity at each node."""
    cp_mean_i = thermo.cp_mean(s["ts_re"], spec.comp_idx)    # (rNo, n_comp)
    so_cp_mix = torch.sum(s["mo_fri"].T * cp_mean_i, dim=-1)
    ca_po = p["CaPo"]
    return (s["cos_sp_re"] * so_cp_mix * ca_po
            + (1 - ca_po) * p["CaDe"] * p["CaSpHeCa"])


def t1_initial_state(spec: ParticleSpec, p):
    """1e-6 dimensionless concentrations, theta=0 (particleModels.py:224-244)."""
    c0 = torch.full((spec.n_comp, spec.r_no), 1e-6, dtype=p["P0"].dtype,
                    device=p["P0"].device)
    rows = [c0]
    if not spec.iso_thermal:
        rows.append(torch.zeros_like(c0[:1]))
    return torch.cat(rows, dim=0).reshape(-1)


def make_t1_rhs(spec: ParticleSpec):
    """Dynamic particle RHS (reference modelEquationT1,
    particleModels.py:605-1103), FDM path, vectorized over radial nodes."""
    nu = DeviceTables(nu=spec.stoich.nu_comp)

    def rhs(t, y, p):
        rf = p["PaDi"] / 2
        ca_po = p["CaPo"]
        s = _particle_state(spec, y, p, nu)

        # dimensionless reference scale of the heat equation
        # (particleModels.py:338-345)
        so_he_di_te0 = (p["GaThCoMix0"] * p["T0"] / rf**2) * 1e-3

        # diffusivities (FIX setting -> feed values)
        ga_dii_dile = p["GaDii0"] / p["GaDii0"]      # ones
        so_dii_eff = (ca_po / p["CaTo"]) * p["GaDii0"]
        c_b = p["Cbi"] / torch.max(p["Cbi"])         # dimensionless bulk

        a = particle_fd.build_c_residual(
            s["cs"], s["ri_r"], ga_dii_dile, p["MaTrCo"], c_b, so_dii_eff,
            rf, flux_dir="lr")
        dcs = a / (ca_po * rf**2 / p["GaDii0"])[:, None]

        rows = [dcs]
        if not spec.iso_thermal:
            so_th_eff_dile = ca_po * 1.0             # SoThCoMix/SoThCoMix0 = 1
            k_ref = p["GaThCoMix0"] / 1000.0
            he_conv = p["HeTrCo"] / 1000.0
            tb_dile = (p["Tb"] - p["T0"]) / p["T0"]
            a_t = particle_fd.build_t_residual(
                s["ts"], -_overall_heat(spec, s), so_th_eff_dile, he_conv,
                tb_dile, k_ref, rf)
            dts = a_t / (_cp_eff(spec, s, p) * p["T0"] / so_he_di_te0)
            rows.append(dts[None])

        return torch.cat(rows, dim=0).reshape(-1)

    return rhs


def _oc_ops(r_no: int):
    ops = oc_particle.oc_operator()
    assert ops["N"] == r_no, (
        f"the OC branch uses the {ops['N']}-point basis; got rNo={r_no}"
    )
    return ops


def _t1_oc_interface(spec, p, Y, ops):
    """(cs_hat, ts_hat, beta_c, beta_t, c_b, tb_dile) of the OC T1 branch:
    the clamped concentrations and the temperature with their surface
    values replaced by the Robin rows' solutions."""
    rf = p["PaDi"] / 2
    A = oc_particle.table(ops, "A", Y)
    cs = torch.clamp(Y[:spec.n_comp], min=EPS_CONST)
    c_b = p["Cbi"] / torch.max(p["Cbi"])
    beta_c = (rf / p["GaDii0"]) * p["MaTrCo"]           # (n_comp,)
    cs_hat = oc_particle.interface_update(cs, c_b, beta_c, A)
    so_th_conv = p["GaThCoMix0"] / 1000.0               # SoThCoEff_Conv (:1073)
    beta_t = (rf / so_th_conv) * (p["HeTrCo"] / 1000.0) / p["CaPo"]
    tb_dile = (p["Tb"] - p["T0"]) / p["T0"]
    ts_hat = None
    if not spec.iso_thermal:
        ts_hat = oc_particle.interface_update(Y[spec.n_comp], tb_dile,
                                              beta_t, A)
    return cs_hat, ts_hat, beta_c, beta_t, c_b, tb_dile


def make_t1_rhs_oc(spec: ParticleSpec, scaled_sources: bool = True,
                   clamp_interface: bool = False):
    """Dynamic particle RHS on the 7-point orthogonal-collocation basis
    (reference modelEquationT1 OC branch, particleModels.py:1016-1030 mass
    and :1070-1090 heat, which crashes before one evaluation; rmt_tpu
    reconstructs the intended semantics on the aligned assembler, and
    rmt_tpu/models/particle.py::make_t1_rhs_oc gives the reasoning).

    Layout: radial index in OC order, 0 = innermost point, rNo-1 = the
    gas-solid surface. The surface value is updated algebraically from
    the Robin row each call (static row, zero derivative).
    scaled_sources=True reproduces the OC branch's scaled _Ri/_H sources
    (:1023,1079); rmtExe integrates scaled_sources=False (the FDM
    branch's raw sources on the OC basis) with clamp_interface=True (a
    non-negative interface projection)."""
    nu = DeviceTables(nu=spec.stoich.nu_comp)
    ops = _oc_ops(spec.r_no)

    def rhs(t, y, p):
        rf = p["PaDi"] / 2
        ca_po = p["CaPo"]
        # kinetics/energetics on the stored clamped state (as the FDM
        # branch and the reference OC branch both do)
        s = _particle_state(spec, y, p, nu)
        cs_hat, ts_hat, beta_c, beta_t, c_b, tb_dile = _t1_oc_interface(
            spec, p, s["Y"], ops)
        if clamp_interface:
            # non-negative interface projection: the OC surface
            # extrapolation swings negative during transients and the
            # EPS-clamped kinetics then collapse the step size
            cs_hat = torch.clamp(cs_hat, min=EPS_CONST)

        so_ma_di_te0 = (p["GaDii0"] * s["c_max"]) / rf**2
        so_he_di_te0 = (p["GaThCoMix0"] * p["T0"] / rf**2) * 1e-3

        if scaled_sources:
            ri_term = (1.0 / so_ma_di_te0)[:, None] * (1 - ca_po) * s["ri_r"]
        else:
            ri_term = s["ri_r"]                 # raw, as the FDM branch
        # SoDiiEff_DiLe = 1 (:943)
        res_c = oc_particle.oc_residual(cs_hat, 1.0, ri_term, beta_c, c_b,
                                        ops)
        dcs = res_c * (p["GaDii0"] / (ca_po * rf**2))[:, None]
        dcs = torch.cat([dcs[:, :-1], torch.zeros_like(dcs[:, -1:])],
                        dim=1)                  # static surface row

        rows = [dcs]
        if not spec.iso_thermal:
            dh_term = -_overall_heat(spec, s)
            if scaled_sources:
                dh_term = (1.0 / so_he_di_te0) * (1 - ca_po) * dh_term
            res_t = oc_particle.oc_residual(ts_hat, ca_po * 1.0, dh_term,
                                            beta_t, tb_dile, ops)
            dts = res_t / (_cp_eff(spec, s, p) * p["T0"] / so_he_di_te0)
            dts = torch.cat([dts[:-1], torch.zeros_like(dts[-1:])])
            rows.append(dts[None])

        return torch.cat(rows, dim=0).reshape(-1)

    return rhs


def t1_oc_surface_values(spec: ParticleSpec, p, y):
    """Recomputed algebraic interface values for post-processing,
    (n_layer, rNo)."""
    ops = _oc_ops(spec.r_no)
    Y = y.reshape(spec.n_layer, spec.r_no)
    cs_hat, ts_hat, *_ = _t1_oc_interface(spec, p, Y, ops)
    out = [cs_hat] + ([] if spec.iso_thermal else [ts_hat[None]])
    return torch.cat(out, dim=0)


def _make_t2_residual_basis(spec: ParticleSpec, residual_fn, ops):
    """Steady particle residual on a collocation basis (OC or OCFE): the
    same equations as make_t2_residual_fn with an active Robin surface
    row and the FDM-matched transfer numbers (rmt_tpu's
    make_t2_residual_oc / make_t2_residual_ocfe)."""
    nu = DeviceTables(nu=spec.stoich.nu_comp)

    def residual(y, p, d):
        rf = p["PaDi"] / 2
        ca_po = p["CaPo"]
        s = _particle_state(spec, y, p, nu)

        so_dii_eff = (ca_po / p["CaTo"]) * d["GaDii0"]
        ri_scaled = (1 / d["SoMaDiTe0"])[:, None] * (1 - ca_po) * s["ri_r"]
        beta_c = rf * d["MaTrCo"] / so_dii_eff

        fc = residual_fn(s["cs"], 1.0, ri_scaled, beta_c, d["Cb_DiLe"], ops)
        rows = [fc]
        if not spec.iso_thermal:
            dh_scaled = ((1 / d["SoHeDiTe0"]) * (1 - ca_po)
                         * (-_overall_heat(spec, s)))
            beta_t = rf * d["HeTrCo"] / (d["GaThCoMix0"] * ca_po)
            ft = residual_fn(s["ts"], ca_po * 1.0, dh_scaled, beta_t,
                             d["Tb_DiLe"], ops)
            rows.append(ft[None])
        return torch.cat(rows, dim=0).reshape(-1)

    return residual


def make_t2_residual_oc(spec: ParticleSpec):
    """Steady particle residual on the 7-point OC basis (the intended
    `numerical-method: "oc"` form of runT2; see rmt_tpu's
    make_t2_residual_oc): interior rows CaPo-free mass Laplacian + scaled
    reaction source, an active Robin surface row, transfer numbers matched
    to the FDM ghost construction (beta_c = rf*MaTrCo/SoDiiEff)."""
    return _make_t2_residual_basis(spec, oc_particle.oc_residual,
                                   _oc_ops(spec.r_no))


def make_t2_residual_ocfe(spec: ParticleSpec, nu_el: int = 6):
    """Steady particle residual on the OCFE basis (nu_el 4-point Lobatto
    elements) -- the reference's `numerical-method: "fem"` route of runT2
    (particleModels.py:1126,1270-1282 grid; rmt_tpu's
    make_t2_residual_ocfe): the OC equations on the multi-element grid
    with value and flux continuity at element interfaces."""
    ops = ocfe.ocfe_operator(nu_el)
    assert ops["NuToCoPo"] == spec.r_no, (
        f"the OCFE branch with NuEl={nu_el} has {ops['NuToCoPo']} radial "
        f"points; got rNo={spec.r_no}"
    )
    return _make_t2_residual_basis(spec, ocfe.ocfe_residual, ops)


def t2_derived(spec: ParticleSpec, p):
    """Computed transport/bulk state for the steady model (reference
    runT2, particleModels.py:1200-1470): Chapman-Enskog diffusivities,
    viscosity/conductivity + Wilke mixtures, Re/Sc/Sh/Pr/Nu, and the
    gas-solid transfer coefficients."""
    idx = spec.comp_idx
    sp_coi0 = p["SpCoi0"]                   # [mol/m^3] for T2
    mw = torch.as_tensor(DB.MW[idx], dtype=sp_coi0.dtype,
                         device=sp_coi0.device)
    sp_co0 = torch.sum(sp_coi0)
    mo_fri0 = sp_coi0 / sp_co0

    ga_dii0 = transport.diffusivity_chapman_enskog(p["T0"], p["P0"], mo_fri0,
                                                   idx)
    ga_vii0 = transport.viscosity(p["T0"], idx)
    ga_mi_vi = transport.wilke_mixture(ga_vii0, mo_fri0, mw)
    ga_th_coi0 = transport.thermal_conductivity(p["T0"], idx)
    ga_th_co_mix0 = transport.wilke_mixture(ga_th_coi0, mo_fri0, mw)

    mi_mo_we0 = thermo.mixture_molecular_weight(mo_fri0, mw, "kg/mol")
    ga_de0 = thermo.density_ig(mi_mo_we0, sp_co0)
    cp0 = thermo.cp_mean(p["T0"], idx)
    cp_mix0 = thermo.cp_mix(mo_fri0, cp0)

    su_ga_ve0 = p["SuGaVe0"]
    re0 = film.reynolds(ga_de0, su_ga_ve0, p["PaDi"], ga_mi_vi)
    sc0 = film.schmidt(ga_de0, ga_mi_vi, ga_dii0)
    sh0 = film.sherwood(sc0, re0, film.FROSSLING)
    pr0 = film.prandtl(cp_mix0, ga_mi_vi, ga_th_co_mix0, mi_mo_we0)
    nu0 = film.nusselt(pr0, re0)
    ma_tr_co0 = film.mass_transfer_coefficient(sh0, ga_dii0, p["PaDi"])
    he_tr_co0 = film.heat_transfer_coefficient(nu0, ga_th_co_mix0, p["PaDi"])

    rf = p["PaDi"] / 2
    c_max = torch.max(sp_coi0)
    so_ma_di_te0 = (ga_dii0 * c_max) / rf**2
    so_he_di_te0 = ga_th_co_mix0 * p["T0"] / rf**2   # [J/m^3.s] (no 1e-3)
    return {
        "GaDii0": ga_dii0,
        "GaThCoMix0": ga_th_co_mix0,
        "MaTrCo": ma_tr_co0,
        "HeTrCo": he_tr_co0,
        "SoMaDiTe0": so_ma_di_te0,
        "SoHeDiTe0": so_he_di_te0,
        "Cb_DiLe": sp_coi0 / c_max,
        "Tb_DiLe": torch.zeros((), dtype=sp_coi0.dtype,
                               device=sp_coi0.device),   # Tb = T0
    }


def t2_initial_state(spec: ParticleSpec, p):
    """Uniform dimensionless concentration at the bulk value, theta = 0
    (reference particleModels.py:1330-1350)."""
    c_max = torch.max(p["SpCoi0"])
    c0 = (p["SpCoi0"] / c_max)[:, None].expand(spec.n_comp, spec.r_no)
    rows = [c0]
    if not spec.iso_thermal:
        rows.append(torch.zeros_like(c0[:1]))
    return torch.cat(rows, dim=0).reshape(-1)


def make_t2_residual_fn(spec: ParticleSpec):
    """Steady particle residual F(y) (reference modelEquationT2,
    particleModels.py:1669-2212). Unlike T1 the reaction/heat terms enter
    pre-scaled by the diffusive reference terms and all heat quantities
    stay in J units."""
    nu = DeviceTables(nu=spec.stoich.nu_comp)

    def residual(y, p, d):
        rf = p["PaDi"] / 2
        ca_po = p["CaPo"]
        s = _particle_state(spec, y, p, nu)

        so_dii_eff = (ca_po / p["CaTo"]) * d["GaDii0"]
        ga_dii_dile = torch.ones_like(d["GaDii0"])
        ri_scaled = (1 / d["SoMaDiTe0"])[:, None] * (1 - ca_po) * s["ri_r"]

        a = particle_fd.build_c_residual(
            s["cs"], ri_scaled, ga_dii_dile, d["MaTrCo"], d["Cb_DiLe"],
            so_dii_eff, rf, flux_dir="lr")
        fc = a / (ca_po * rf**2 / d["GaDii0"])[:, None]
        rows = [fc]
        if not spec.iso_thermal:
            dh_scaled = ((1 / d["SoHeDiTe0"]) * (1 - ca_po)
                         * (-_overall_heat(spec, s)))
            so_th_eff_dile = ca_po * 1.0
            a_t = particle_fd.build_t_residual(
                s["ts"], dh_scaled, so_th_eff_dile, d["HeTrCo"],
                d["Tb_DiLe"], d["GaThCoMix0"], rf,
            )
            ft = a_t / (_cp_eff(spec, s, p) * p["T0"] / d["SoHeDiTe0"])
            rows.append(ft[None])
        return torch.cat(rows, dim=0).reshape(-1)

    return residual
