# Public API: rmtExe(modelInput) / rmtCom() (port of rmt_tpu/api/rmt.py,
# every model id of rmt_tpu).
#
# Same dict-in / dataPack-out contract as the reference
# (PyREMOT/rmt.py:21-92, PyREMOT/docs/rmtCore.py:63-127): modelInput
# validated, model id dispatched, result wrapped as {"resModel": ...,
# "comTime": ...}, with rmt_tpu's keys and value shapes. Every model runs
# in config.default_float() on the CUDA card, or on the device the caller
# names: N1, N2 and the steady M0, M1, M4, M7, M8 and batch M3 on the
# sequential integrators of solvers/ (radau, dopri5, fixed.precorr3), the
# dynamic M2 and M9 on the lockstep integrator in block mode (B = 1, the
# block kernels of ops/cuda_block.py on the card), M5 and the dynamic
# particle T1 on radau, the steady T2 (newton), T3 and M14 (radau
# pseudo-transient continuation, then newton) as root problems, the
# coupled dynamic heterogeneous M10, M11 and M12 on radau with a two-phase
# colored Jacobian, and M13 by operator splitting
# (models/hetero_dyn.make_m13_driver: radau on the gas phase, radau
# pseudo-transient continuation and newton on every node's particle).
# Eager PyTorch compiles nothing, so there is no cache of built programs.
# display-result "True" plots the result after the run through io/plot
# (matplotlib on the host), as rmt_tpu does; RMT_TORCH_PROFILE=<dir>
# writes a torch.profiler trace of the call.

from __future__ import annotations

import os
import time
import warnings
from timeit import default_timer as timer
from typing import Any, Mapping

import numpy as np
import torch

from .. import config
from ..data.species import SPECIES, species_index
from ..models import batch, homo, pb, pf
from ..solvers import dopri5, fixed, radau, stiff_ensemble
from ..utils import roundNum

ISO = homo.ISO_THERMAL

# model ids of rmt_tpu, every one of them ported (_PORTED); an id outside
# them raises NotImplementedError
_MODEL_IDS = {
    "M2": "dynamic packed-bed reactor, concentration variables",
    "M3": "batch reactor",
    "M9": "dynamic packed-bed reactor, concentration + velocity march",
    "M5": "plug-flow heterogenous reactor",
    "M0": "plug-flow reactor",
    "M1": "packed bed reactor, steady-state, molar-flow variables",
    "M4": "plug-flow reactor",
    "M7": "steady-state packed-bed reactor, concentration variables",
    "M8": "steady-state packed-bed reactor, concentration + velocity",
    "T1": "dynamic catalyst particle diffusion-reaction",
    "T2": "steady-state catalyst particle diffusion-reaction",
    "N1": "steady-state homogenous packed bed reactor non-isothermal plug-flow",
    "N2": "dynamic homogenous packed bed reactor non-isothermal plug-flow",
    "T3": "steady-state pseudo-homogeneous packed bed with axial dispersion",
    "M11": "dynamic heterogenous packed bed, coupled gas + FDM particle",
    "M10": "dynamic heterogenous packed bed, OC particle, real units",
    "M12": "dynamic heterogenous packed bed, OC particle, static interface",
    "M13": "dynamic heterogenous packed bed, gas/solid operator splitting",
    "M14": "steady-state heterogenous packed bed, gas + lumped catalyst phase",
}
_PORTED = ("N1", "N2", "M0", "M1", "M2", "M3", "M4", "M5", "M7", "M8",
           "M9", "M10", "M11", "M12", "M13", "M14", "T1", "T2", "T3")

_SOLVER_SETTING = {
    "N1": {"zNo": 100},
    "N2": {"zNo": 20, "tNo": 5, "timesNo": 5},
    "AM_n": 100,
}

_DEFAULT_RTOL = 1e-7
_DEFAULT_ATOL = 1e-10

# solver-config keys the framework honors. Unknown keys are rejected (the
# reference silently drops them; silently accepting-and-ignoring user config
# hides typos like "rtoll")
_SOLVER_CONFIG_KEYS = {
    "ivp", "root", "mesh", "display-result", "rtol", "atol",
    "zNo", "tNo", "timesNo", "rNo", "rampList", "numerical-method", "NuEl",
}
_ROOT_METHODS = {"default", "fsolve", "root", "least_squares"}
# reference configs name scipy methods (pbHomoReactor.py:2916-2932); the
# stiff ones (LSODA/BDF/Radau and the "default" placeholder) all route to
# solvers/radau.py, explicit ones to dopri5, "AM" to fixed.precorr3 --
# anything else (typos included) must raise, not silently run radau
_IVP_METHODS = {"default", "LSODA", "BDF", "Radau", "AM", "RK45", "dopri5"}
# models whose reference honors the two-zone refined mesh
_MESH_MODELS = {"T3", "M11", "M12", "M13", "M14"}


def _stats_dict(stats):
    """Solver stats as plain ints (scalar fields) or int lists (per-member
    fields)."""
    out = {}
    for k, v in stats._asdict().items():
        a = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = int(a) if a.ndim == 0 else [int(x) for x in a.reshape(-1)]
    return out


def _check_integration(stats, context: str):
    """Fail loudly when the integrator exhausted its step budget: the
    trailing output rows would hold states at the wrong times (the
    reference likewise raises on solve_ivp failure,
    pbHomoReactor.py:2944-2947)."""
    d = _stats_dict(stats)
    bad = d.get("n_unreached", 0)
    if bad:
        raise RuntimeError(
            f"{context}: integrator failed to reach {bad} output time(s) "
            f"within the step budget (stats: {d})"
        )
    return d


def _check_finite(ys, context: str, ivp: str = ""):
    """Fail loudly on non-finite states. Catches divergence the budget
    check cannot see -- the fixed steppers (ivp="AM") have no adaptive
    budget, so a blown-up fixed-step march (e.g. PreCorr3 on the stiff
    N1/N2 chemistry at AM_n steps) would otherwise return NaN silently.
    (The reference CRASHES on these inputs instead: its "AM" string
    reaches scipy solve_ivp, which rejects it, pbHomoReactor.py:2931.)"""
    if not np.all(np.isfinite(ys)):
        if ivp == "AM":
            raise RuntimeError(
                f"{context}: integration produced non-finite states. The "
                "fixed-step marcher (solver-config ivp='AM') diverged on "
                "a stiff problem -- raise AM_n or use a stiff method "
                "(default/Radau/BDF/LSODA)."
            )
        raise RuntimeError(
            f"{context}: integration produced non-finite states (the "
            "adaptive solver accepted a step into a non-finite region; "
            "check the feed/initial state and kinetics for out-of-domain "
            "values, or tighten rtol/atol)."
        )


def rmtCom() -> str:
    """List components available in the database (reference: rmt.py:83-92)."""
    return ",".join(SPECIES)


# modelInput schema: the reference accepts the raw dict verbatim and
# silently ignores anything it doesn't read (SURVEY §5 config system);
# here unknown sections and malformed required sections fail loudly.
_TOP_LEVEL_KEYS = {
    "model", "operating-conditions", "feed", "reactions", "reaction-rates",
    "external-heat", "reactor", "solver-config",
    # reference particleModels reads numerical-method from "test-const"
    # (particleModels.py:165-184)
    "test-const",
    # extensions: checkpoint/resume round-trip, kinetic-constant
    # overrides (named VARS scalars)
    "resume-state",
    "kinetic-overrides",
}
_OPERATING_CONDITION_KEYS = {
    "pressure", "temperature", "period", "process-type", "numerical-method",
}


def _validate_model_input(model_input: Mapping[str, Any]) -> None:
    """Typed-schema gate for the modelInput dict: unknown top-level keys
    and malformed required sections raise with the supported layout
    (solver-config keys are checked separately in _solver_options)."""
    if not isinstance(model_input, Mapping):
        raise TypeError("modelInput must be a dict-like mapping")
    if "model" not in model_input or not isinstance(model_input["model"], str):
        raise ValueError('modelInput["model"] must be a model-id string '
                         f"(one of {sorted(_MODEL_IDS)})")
    unknown = set(model_input) - _TOP_LEVEL_KEYS
    if unknown:
        raise ValueError(
            f"unknown modelInput key(s) {sorted(unknown)}; "
            f"supported: {sorted(_TOP_LEVEL_KEYS)}"
        )
    oc = model_input.get("operating-conditions", {})
    if not isinstance(oc, Mapping):
        raise TypeError('modelInput["operating-conditions"] must be a dict')
    unknown_oc = set(oc) - _OPERATING_CONDITION_KEYS
    if unknown_oc:
        raise ValueError(
            f"unknown operating-conditions key(s) {sorted(unknown_oc)}; "
            f"supported: {sorted(_OPERATING_CONDITION_KEYS)}"
        )
    feed = model_input.get("feed")
    if not isinstance(feed, Mapping) or not isinstance(
        feed.get("components"), Mapping
    ):
        raise ValueError(
            'modelInput["feed"]["components"] is required (a dict with a '
            '"shell" component list, reference rmt.py:52-57)'
        )
    rxn = model_input.get("reactions", {})
    if not isinstance(rxn, Mapping) or not all(
        isinstance(v, str) for v in rxn.values()
    ):
        raise ValueError(
            'modelInput["reactions"] must map reaction ids to reaction '
            'strings like "CO2 + 3H2 <=> CH3OH + H2O"'
        )
    rr = model_input.get("reaction-rates", {})
    if rr and (
        not isinstance(rr, Mapping)
        or not isinstance(rr.get("VARS", {}), Mapping)
        or not isinstance(rr.get("RATES", {}), Mapping)
    ):
        raise ValueError(
            'modelInput["reaction-rates"] must be {"VARS": {...}, '
            '"RATES": {...}} (the kinetics dict-program, '
            "reference rmtReaction.py:11-61)"
        )


def _check_components(model_input: Mapping[str, Any]) -> None:
    comps: list[str] = []
    fe_com = model_input["feed"]["components"]
    for key in ("shell", "tube", "medium"):
        if fe_com.get(key):
            comps.extend(fe_com[key])
    for c in dict.fromkeys(comps):
        species_index(c)  # raises UnknownComponentError on miss


def _solver_options(model_input: Mapping[str, Any]) -> dict[str, Any]:
    sc = model_input.get("solver-config", {})
    unknown = set(sc) - _SOLVER_CONFIG_KEYS
    if unknown:
        raise ValueError(
            f"unknown solver-config key(s) {sorted(unknown)}; "
            f"supported: {sorted(_SOLVER_CONFIG_KEYS)}"
        )
    root = sc.get("root", "default")
    if root not in _ROOT_METHODS:
        raise ValueError(
            f"unknown solver-config root {root!r}; supported: "
            f"{sorted(_ROOT_METHODS)} (all route to the damped-Newton/PTC "
            "solver -- scipy's fsolve/root/least_squares distinctions have "
            "no accelerator analogue)"
        )
    ivp = sc.get("ivp", "default")
    if ivp not in _IVP_METHODS:
        raise ValueError(
            f"unknown solver-config ivp {ivp!r}; supported: "
            f"{sorted(_IVP_METHODS)} (the reference's stiff scipy methods "
            "LSODA/BDF/Radau all route to the Radau IIA(5) integrator, "
            "'RK45'/'dopri5' to the explicit Dopri5 path, 'AM' to the "
            "fixed-step PreCorr3 stepper -- see MIGRATION.md)"
        )
    return {
        "ivp": ivp,
        "root": root,
        "mesh": sc.get("mesh", "normal"),
        "rtol": float(sc.get("rtol", _DEFAULT_RTOL)),
        "atol": float(sc.get("atol", _DEFAULT_ATOL)),
        "display": sc.get("display-result", "False") == "True",
    }


def _zero_stats(like):
    zero = torch.zeros((), dtype=torch.int32, device=like.device)
    return dopri5.Dopri5Stats(zero, zero, zero, zero)


def _integrate(f, y0, ts, opts):
    """ys (T, n) and stats of the adaptive integrator opts["ivp"] names."""
    if opts["ivp"] in ("RK45", "dopri5"):
        return dopri5.odeint(f, y0, ts, rtol=opts["rtol"], atol=opts["atol"])
    # default / LSODA / BDF / Radau -> stiff Radau IIA(5)
    return radau.odeint(f, y0, ts, rtol=opts["rtol"], atol=opts["atol"])


# ---------------------------------------------------------------------------
# N1
# ---------------------------------------------------------------------------

def _n1_solve(spec: homo.HomoSpec, p, opts):
    """(ys (varNo, z_out+1), stats) of the steady model over z."""
    rhs = homo.make_n1_rhs(spec)
    d = homo.feed_state(spec, p)
    y0 = homo.n1_initial_state(spec, p, d)

    def f(t, y):
        return rhs(t, y, p, d)

    if opts["ivp"] == "AM":
        n = _SOLVER_SETTING["AM_n"]
        ys = fixed.precorr3(f, 0.0, 1.0, n, y0)
        idxs = np.round(np.linspace(0, n, spec.z_out + 1)).astype(int)
        return ys[idxs].T, _zero_stats(y0)
    ts = torch.linspace(0.0, 1.0, spec.z_out + 1, dtype=y0.dtype,
                        device=y0.device)
    ys, stats = _integrate(f, y0, ts, opts)
    return ys.T, stats


def _run_n1(model_input, spec: homo.HomoSpec, opts, device, dtype):
    start = timer()
    p = homo.build_params(model_input, dtype=dtype, device=device)
    ys, stats = _n1_solve(spec, p, opts)
    stats_d = _check_integration(stats, "N1")
    ys = ys.cpu().numpy()
    _check_finite(ys, "N1", opts["ivp"])

    comp_list = list(spec.comp_list)
    n_comp = spec.n_comp
    iso = spec.iso_thermal
    n_cols = spec.z_out + 1

    sp_coi0 = p["SpCoi0"].cpu().numpy()
    c_max = np.max(sp_coi0)
    Pf = float(p["P0"])
    Tf = float(p["T0"])

    conc_dl = ys[:n_comp]
    press_dl = ys[n_comp]
    temp_dl = ys[n_comp + 1] if not iso else np.zeros(n_cols)

    conc_re = conc_dl * c_max
    press_re = (press_dl * Pf).reshape(1, n_cols)
    temp_re = (temp_dl * Tf + Tf).reshape(1, n_cols)

    mo_fri = conc_re / np.sum(conc_re, axis=0)
    if not iso:
        data_ys_all = np.concatenate([mo_fri, press_re, temp_re], axis=0)
    else:
        data_ys_all = np.concatenate([mo_fri, press_re], axis=0)

    label_list = comp_list + ["Pressure"] + ([] if iso else ["Temperature"])
    data_xs = np.linspace(0.0, 1.0, n_cols)
    elapsed = roundNum(timer() - start)

    return [
        {
            "modelId": model_input["model"],
            "processType": ISO if iso else model_input["operating-conditions"]["process-type"],
            "successStatus": True,
            "computation-time": elapsed,
            "dataShape": data_xs.shape,
            "labelList": label_list,
            "indexList": [n_comp, n_comp, n_comp + 1],
            "dataTime": [],
            "dataXs": data_xs,
            "dataYCons1": conc_dl,
            "dataYCons2": conc_re,
            "dataYTemp1": temp_dl,
            "dataYTemp2": temp_re,
            "dataYs": data_ys_all,
            "solverStats": stats_d,
        }
    ]


# ---------------------------------------------------------------------------
# N2
# ---------------------------------------------------------------------------

def _n2_solve(spec: homo.HomoSpec, p, y0, t_start: float, opts):
    """(ys (tNo+1, varNo*zNo), stats) of the dynamic model from y0 at
    t_start over the period opT."""
    rhs = homo.make_n2_rhs(spec)
    d = homo.feed_state(spec, p)

    def f(t, y):
        return rhs(t, y, p, d)

    ts = (t_start + p["opT"] * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=p["opT"].dtype,
        device=p["opT"].device)).to(y0.dtype)
    if opts["ivp"] == "AM":
        n = _SOLVER_SETTING["AM_n"]
        ys = [y0]
        for k in range(spec.t_no):
            ys.append(fixed.precorr3(f, ts[k], ts[k + 1], n, ys[-1])[-1])
        return torch.stack(ys), _zero_stats(y0)
    return _integrate(f, y0, ts, opts)


def _run_n2(model_input, spec: homo.HomoSpec, opts, device, dtype):
    start = timer()
    p = homo.build_params(model_input, dtype=dtype, device=device)

    # checkpoint/resume: the reference's dynamic models re-seed the IV from
    # the previous interval in memory only (pbHomoReactor.py:3684-3685);
    # here the raw integration state is a first-class artifact -- every run
    # returns a "checkpoint" and accepts one back via
    # modelInput["resume-state"] to continue where it stopped
    resume = model_input.get("resume-state")
    if resume is not None:
        if resume.get("model") != model_input["model"]:
            raise ValueError(
                f"resume-state is for model {resume.get('model')!r}, "
                f"not {model_input['model']!r}"
            )
        y_init = torch.as_tensor(np.asarray(resume["state"], dtype=np.float64),
                                 dtype=dtype, device=device)
        expect = spec.var_no_n2 * spec.z_no
        if tuple(y_init.shape) != (expect,):
            raise ValueError(
                f"resume-state has {tuple(y_init.shape)} entries; this grid "
                f"needs ({expect},)"
            )
        t_start = float(resume.get("t", 0.0))
    else:
        d0 = homo.feed_state(spec, p)
        y_init = homo.n2_initial_state(spec, p, d0)
        t_start = 0.0
    ys, stats = _n2_solve(spec, p, y_init, t_start, opts)
    stats_d = _check_integration(stats, "N2")
    ys = ys.cpu().numpy()
    _check_finite(ys, "N2", opts["ivp"])

    comp_list = list(spec.comp_list)
    n_comp = spec.n_comp
    iso = spec.iso_thermal
    z_no = spec.z_no
    var_no = spec.var_no_n2

    sp_coi0 = p["SpCoi0"].cpu().numpy()
    c_max = np.max(sp_coi0)
    Tf = float(p["T0"])
    op_t = float(p["opT"])
    t_bounds = t_start + op_t * np.linspace(0.0, 1.0, spec.t_no + 1)

    label_list = comp_list + ["Temperature"]
    data_xs = np.linspace(0.0, 1.0, z_no)

    data_pack = []
    for i in range(spec.t_no):
        reshaped = ys[i + 1].reshape(var_no, z_no)
        # QUIRK: dataYCons1 always drops the last row even in iso mode
        # (pbHomoReactor.py:3638)
        conc_dl = reshaped[:-1]
        temp_dl = reshaped[-1] if not iso else np.zeros(z_no)

        conc_all = reshaped[:-1] if not iso else reshaped
        conc_re = conc_all * c_max
        temp_re = (temp_dl * Tf + Tf).reshape(1, z_no)

        mo_fri = conc_re / np.sum(conc_re, axis=0)
        data_ys_all = np.concatenate([mo_fri, temp_re], axis=0)

        data_pack.append(
            {
                "modelId": model_input["model"],
                "processType": ISO if iso else model_input["operating-conditions"]["process-type"],
                "successStatus": True,
                "dataShape": np.array(t_bounds[i + 1]).shape,
                "labelList": label_list,
                "indexList": [n_comp, n_comp + 1, n_comp],
                "dataTime": t_bounds[i + 1],
                "dataXs": data_xs,
                "dataYCons1": conc_dl,
                "dataYCons2": conc_re,
                "dataYTemp1": temp_dl,
                "dataYTemp2": temp_re,
                "dataYs": data_ys_all,
            }
        )

    elapsed = roundNum(timer() - start)
    return {
        "computation-time": elapsed,
        "dataPack": data_pack,
        "solverStats": stats_d,
        "checkpoint": {
            "model": model_input["model"],
            "t": float(t_bounds[-1]),
            "state": ys[-1].copy(),
        },
    }


# ---------------------------------------------------------------------------
# M0/M4 (plug flow), M1 (packed bed, molar-flow variables), M7/M8
# (packed bed, concentration variables): steady profiles over z
# ---------------------------------------------------------------------------

def _steady_profile(rhs, y0, p, n_out, opts, context):
    """(ys (n_var, n_out) numpy, z (n_out,) numpy) of a steady model over
    the reactor length, on the integrator opts["ivp"] names."""
    ts = torch.linspace(0.0, 1.0, n_out, dtype=y0.dtype,
                        device=y0.device) * p["ReLe"]
    ys, stats = _integrate(lambda t, y: rhs(t, y, p), y0, ts, opts)
    _check_integration(stats, context)
    return ys.T.cpu().numpy(), ts.cpu().numpy()


def _xy_result(data_x, rows, labels, opts, x_label, y_label=""):
    """XYList and dataList of rows over data_x, plotted when asked."""
    xy_list = [[data_x, row] for row in rows]
    data_list = [{"x": data_x, "y": xy[1], "leg": leg}
                 for xy, leg in zip(xy_list, labels)]
    if opts["display"]:
        from ..io import plot as _plot

        _plot.plot_xy_series(data_list, x_label, y_label)
    return xy_list, data_list


def _run_pf(model_input, opts, device, dtype):
    spec = pf.build_spec(model_input)
    p = pf.build_params(model_input, dtype=dtype, device=device)
    ys, data_x = _steady_profile(pf.make_rhs(spec), pf.initial_state(spec, p),
                                 p, spec.z_out, opts, "M0/M4")
    xy_list, data_list = _xy_result(
        data_x, ys, list(spec.comp_list) + ["Temperature"], opts,
        "Reactor Length (m)")
    return {"XYList": xy_list, "dataList": data_list}


def _run_m1(model_input, opts, device, dtype):
    spec = pb.build_spec(model_input)
    p = pb.build_params(model_input, dtype=dtype, device=device)
    ys, data_x = _steady_profile(pb.make_m1_rhs(spec),
                                 pb.m1_initial_state(spec, p), p,
                                 spec.z_out, opts, "M1")
    n_comp = spec.n_comp
    # molar flowrates -> mole fractions (reference pbReactor.py:286-303)
    mo_fri = ys[:n_comp] / np.sum(ys[:n_comp], axis=0)
    data_ys_all = np.concatenate([mo_fri, ys[n_comp:n_comp + 3]], axis=0)
    ss_data_ys = np.concatenate([mo_fri, ys[n_comp + 1:n_comp + 2]], axis=0)
    xy_list, data_list = _xy_result(
        data_x, data_ys_all,
        list(spec.comp_list) + ["Flux", "Temperature", "Pressure"], opts,
        "Reactor Length (m)")
    return {"dataYs": ss_data_ys, "XYList": xy_list, "dataList": data_list}


def _run_m_conc_steady(model_input, opts, device, dtype, model_id):
    spec = pb.build_spec(model_input)
    p = pb.build_params(model_input, dtype=dtype, device=device)
    if model_id == "M7":
        rhs, y0 = pb.make_m3_rhs(spec), pb.m3_initial_state(spec, p)
    else:
        rhs, y0 = pb.make_m4_rhs(spec), pb.m4_initial_state(spec, p)
    # output points: solverSetting M9.zNo (M7), S3.timesNo (M8)
    n_out = 30 if model_id == "M7" else 25
    ys, data_x = _steady_profile(rhs, y0, p, n_out, opts, model_id)
    n_comp = spec.n_comp
    mo_fri = ys[:n_comp] / np.sum(ys[:n_comp], axis=0)
    data_ys = np.concatenate([mo_fri, ys[n_comp:n_comp + 1]], axis=0)
    labels = list(spec.comp_list) + ["Temperature", "Pressure"]
    if model_id == "M8":
        labels.append("Velocity")
    xy_list, data_list = _xy_result(data_x, data_ys, labels, opts,
                                    "Reactor Length (m)")
    return {"dataYs": data_ys, "XYList": xy_list, "dataList": data_list}


# ---------------------------------------------------------------------------
# M3: batch reactor
# ---------------------------------------------------------------------------

def _run_batch(model_input, opts, device, dtype):
    spec = batch.build_spec(model_input)
    p = batch.build_params(model_input, dtype=dtype, device=device)
    rhs = batch.make_rhs(spec)
    y0 = batch.initial_state(spec, p)
    ts = (p["opT"] * torch.linspace(0.0, 1.0, spec.t_out, dtype=dtype,
                                    device=device)).to(y0.dtype)
    # rmt_tpu runs M3 on Radau whatever ivp says
    ys, stats = radau.odeint(lambda t, y: rhs(t, y, p), y0, ts,
                             rtol=opts["rtol"], atol=opts["atol"])
    _check_integration(stats, "M3")
    labels = list(spec.comp_list) + ([] if spec.iso_thermal
                                     else ["Temperature"])
    xy_list, data_list = _xy_result(
        ts.cpu().numpy(), ys.T.cpu().numpy(), labels, opts, "Time (s)",
        "Concentration (mol/m^3)")
    return {"XYList": xy_list, "dataList": data_list}


# ---------------------------------------------------------------------------
# M2/M9: dynamic packed bed in dimensional concentration variables
# ---------------------------------------------------------------------------

def _resume_or(model_input, default_y0, expect_len, model_id):
    """The initial state and time of a dynamic run: the default, or the
    {"model", "t", "state"} checkpoint of modelInput["resume-state"] (as
    every dynamic run returns it), on default_y0's device and dtype."""
    resume = model_input.get("resume-state")
    if resume is None:
        return default_y0, 0.0
    if resume.get("model") not in (None, model_id):
        raise ValueError(
            f"resume-state is for model {resume.get('model')!r}, not "
            f"{model_id!r}")
    y = torch.as_tensor(np.asarray(resume["state"], dtype=np.float64),
                        dtype=default_y0.dtype,
                        device=default_y0.device).reshape(-1)
    if y.shape[0] != expect_len:
        raise ValueError(
            f"resume-state has {y.shape[0]} entries; this grid needs "
            f"{expect_len}")
    return y, float(resume.get("t", 0.0))


def _m2_solve(spec, p, y_init, t_start, opts, model_id):
    """(ys (tNo+1, n), ts, stats) of M2 or M9 from y_init at t_start over
    the period opT: the lockstep integrator at B = 1 in block mode, its
    blocks extracted from the dense colored Jacobian of the frozen-march
    RHS, its stage solves the block kernels."""
    from ..ops.jacobian import banded_coloring, batched_colored_jacobian

    if model_id == "M9":
        rhs = pb.make_m9_rhs(spec)
        rhs_frozen = pb.make_m9_rhs(spec, frozen_march_jac=True)
    else:
        rhs = pb.make_m2_rhs(spec)
        rhs_frozen = pb.make_m2_rhs(spec, frozen_pressure_jac=True)
    var_no = spec.n_comp + 1
    # the RHS reads no t, and takes any leading batch dimensions: every
    # member and stage in one call
    jac_x = batched_colored_jacobian(lambda x: rhs_frozen(None, x, p),
                                     banded_coloring(var_no, spec.z_no))
    y0 = y_init[None]
    ts = (t_start + p["opT"] * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=y0.dtype,
        device=y0.device)).to(y0.dtype)
    # attempt budget scales with the number of output intervals: the
    # reference integrates each interval with a fresh LSODA budget
    ys, stats = stiff_ensemble.odeint_ensemble(
        lambda t, y: rhs(t, y, p), y0, ts, rtol=opts["rtol"],
        atol=opts["atol"], jac=lambda t, y: jac_x(y),
        max_steps=max(1024, 256 * spec.t_no), block=(var_no, spec.z_no),
        f_stages=lambda ts3, Y: rhs(ts3, Y, p), batched=True)
    return ys[:, 0, :], ts, stats


def _run_m2(model_input, opts, device, dtype, model_id="M2"):
    sc = model_input.get("solver-config", {})
    spec = pb.build_spec(
        model_input,
        z_no=int(sc.get("zNo", 100)),
        t_no=int(sc.get("tNo", 10)),
        times_no=int(sc.get("timesNo", 5)),
    )
    p = pb.build_params(model_input, dtype=dtype, device=device)
    y_default = pb.m2_initial_state(spec, p)
    y_init, t_start = _resume_or(model_input, y_default,
                                 int(y_default.shape[0]), model_id)
    ys, ts, stats = _m2_solve(spec, p, y_init, t_start, opts, model_id)
    seg = int(stats.seg[0])
    if seg != spec.t_no:
        raise RuntimeError(
            f"{model_id}: lockstep integrator exhausted its attempt budget "
            f"at output segment {seg}/{spec.t_no}")
    ys = ys.cpu().numpy()
    t_bounds = ts.cpu().numpy()

    n_comp = spec.n_comp
    z_no = spec.z_no
    data_xs = np.linspace(0, float(p["ReLe"]), z_no)
    label_list = list(spec.comp_list) + ["Temperature"]

    data_pack = []
    data_packtime = np.zeros((n_comp + 1, spec.t_no, z_no))
    for i in range(spec.t_no):
        Y = ys[i + 1].reshape(n_comp + 1, z_no)
        conc = Y[:n_comp]
        mo_fri = conc / np.sum(conc, axis=0)
        temp = Y[n_comp:n_comp + 1]
        data_ys_all = np.concatenate([mo_fri, temp], axis=0)
        data_pack.append({
            "successStatus": True,
            "dataTime": t_bounds[i + 1],
            "dataYCons": conc,
            "dataYTemp": temp,
            "dataYs": data_ys_all,
        })
        data_packtime[:, i, :] = data_ys_all

    # QUIRK: the reference returns only the XY series of the *last* state
    # variable over time (pbReactor.py:806-841); dataPack is an extension
    xy_list = [[data_xs, row] for row in data_packtime[-1]]
    labels_t = [f"{label_list[-1]} at t={t_bounds[t + 1]}"
                for t in range(spec.t_no)]
    data_list = [{"x": data_xs, "y": xy[1], "leg": leg}
                 for xy, leg in zip(xy_list, labels_t)]
    if opts["display"]:
        from ..io import plot as _plot

        _plot.plot_xy_series(data_list, "Reactor Length (m)", "")
    return {
        "XYList": xy_list,
        "dataList": data_list,
        "dataPack": data_pack,
        "dataPacktime": data_packtime,
        "solverStats": _stats_dict(stats),
        "checkpoint": {
            "model": model_id,
            "t": float(t_bounds[-1]),
            "state": ys[-1].copy(),
        },
    }


# ---------------------------------------------------------------------------
# M5: steady plug-flow heterogeneous reactor, molar-flow variables
# ---------------------------------------------------------------------------

def _run_m5(model_input, opts, device, dtype):
    from ..models import hetero

    spec = hetero.build_spec(model_input)
    p = hetero.build_params(model_input, dtype=dtype, device=device)
    # rmt_tpu runs M5 on Radau whatever ivp says
    ts = torch.linspace(0.0, 1.0, spec.z_out, dtype=dtype,
                        device=device) * p["ReLe"]
    rhs = hetero.make_m5_rhs(spec)
    ys, stats = radau.odeint(lambda t, y: rhs(t, y, p),
                             hetero.m5_initial_state(spec, p), ts,
                             rtol=opts["rtol"], atol=opts["atol"])
    _check_integration(stats, "M5")
    xy_list, data_list = _xy_result(
        ts.cpu().numpy(), ys.T.cpu().numpy(),
        list(spec.comp_list) + ["Flux", "Temperature", "Pressure"], opts,
        "Reactor Length (m)")
    return {"XYList": xy_list, "dataList": data_list}


# ---------------------------------------------------------------------------
# T1/T2: single catalyst-particle diffusion-reaction
# ---------------------------------------------------------------------------

def _particle_pack(spec, resh, p):
    """The dataPack entry of a particle state resh (n_layer, rNo) in
    numpy: dimensionless and real concentrations and temperature, mole
    fractions."""
    c_max = float(torch.max(p["SpCoi0"]))
    Tf = float(p["T0"])
    iso = spec.iso_thermal
    conc_dl = resh[:-1] if not iso else resh
    temp_dl = (resh[-1:].reshape(1, spec.r_no) if not iso
               else np.zeros((1, spec.r_no)))
    conc_re = conc_dl * c_max
    temp_re = temp_dl * Tf + Tf
    return {
        "successStatus": True,
        "dataYCo_DiLe": conc_dl,
        "dataYCo": conc_re,
        "dataYMoFr": conc_re / np.sum(conc_re, axis=0),
        "dataYT_DiLe": temp_dl,
        "dataYT": temp_re,
        "dataY": np.concatenate([conc_re, temp_re], axis=0),
    }


def _run_t1(model_input, opts, device, dtype):
    from ..models import particle

    # T1 honors the reference's LSODA default tolerances unless the user
    # overrides them: the model's unscaled reaction-term quirk
    # (ops/particle_fd.py) makes the early transient explosively unstable
    # (autocatalytic modes with Re(lambda) ~ +1e12), and resolving it at
    # tight tolerance stalls any integrator -- the reference only ever runs
    # it at rtol=1e-3/atol=1e-6 (scipy defaults)
    sc = model_input.get("solver-config", {})
    rtol, atol = float(sc.get("rtol", 1e-3)), float(sc.get("atol", 1e-6))
    # radial discretization: "fdm" (default) or "oc" (reference
    # test-const numerical-method, particleModels.py:165-184; its OC
    # branch crashes -- models.particle.make_t1_rhs_oc)
    method = (
        model_input.get("test-const", {}).get("numerical-method")
        or model_input.get("operating-conditions", {}).get("numerical-method")
        or "fdm"
    )
    spec = particle.build_spec(model_input)
    p = particle.build_params(model_input, dtype=dtype, device=device)
    # OC drives the FDM branch's (raw-source) equations on the OC basis
    rhs = (particle.make_t1_rhs_oc(spec, scaled_sources=False,
                                   clamp_interface=True)
           if method == "oc" else particle.make_t1_rhs(spec))
    y_default = particle.t1_initial_state(spec, p)
    y_init, t_start = _resume_or(model_input, y_default,
                                 int(y_default.shape[0]), "T1")
    ts = (t_start + p["opT"] * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=dtype, device=device)).to(dtype)
    ys, stats = radau.odeint(lambda t, y: rhs(t, y, p), y_init, ts,
                             rtol=rtol, atol=atol)
    _check_integration(stats, "T1")
    t_bounds = ts.cpu().numpy()

    data_pack = []
    for i in range(spec.t_no):
        if method == "oc":
            # the OC surface row is dead storage; report the recomputed
            # algebraic interface value
            resh = particle.t1_oc_surface_values(spec, p, ys[i + 1])
        else:
            resh = ys[i + 1].reshape(spec.n_layer, spec.r_no)
        pack = _particle_pack(spec, resh.cpu().numpy(), p)
        data_pack.append({"successStatus": True,
                          "dataTime": t_bounds[i + 1], **pack})
    xy_list, data_list = _xy_result(
        np.linspace(0.0, 1.0, spec.r_no), data_pack[-1]["dataY"],
        list(spec.comp_list) + ["Temperature"], opts,
        "Dimensionless Particle Radius")
    return {
        "XYList": xy_list,
        "dataList": data_list,
        "dataPack": data_pack,
        "solverStats": _stats_dict(stats),
        "checkpoint": {
            "model": "T1",
            "t": float(t_bounds[-1]),
            "state": ys[-1].cpu().numpy().copy(),
        },
    }


def _run_t2(model_input, opts, device, dtype):
    from ..models import particle
    from ..ops import ocfe, oc_particle
    from ..solvers import newton

    sc = model_input.get("solver-config", {})
    # radial discretization: "fdm" (default), "oc" or "fem" (reference
    # reads solver-config numerical-method for T2, particleModels.py:1126)
    method = (
        sc.get("numerical-method")
        or model_input.get("test-const", {}).get("numerical-method")
        or model_input.get("operating-conditions", {}).get("numerical-method")
        or "fdm"
    )
    # "fem" = OCFE: NuEl 4-point Lobatto elements over the radius
    # (reference particleModels.py:1270-1282; NuEl default solSetting.py:101)
    nu_el = int(sc.get("NuEl", 6))
    if method == "fem":
        spec = particle.build_spec(model_input, r_no=3 * nu_el + 1)
        res_fn = particle.make_t2_residual_ocfe(spec, nu_el)
        # the radial output grid: the discretization's own nodes
        # (reference particleModels.py:1255-1282)
        data_rs = np.asarray(ocfe.ocfe_basis(nu_el)["xi"], dtype=np.float64)
    else:
        spec = particle.build_spec(model_input)
        if method == "oc":
            res_fn = particle.make_t2_residual_oc(spec)
            data_rs = np.asarray(oc_particle.oc_operator()["Xc"],
                                 dtype=np.float64)
        else:
            res_fn = particle.make_t2_residual_fn(spec)
            data_rs = np.linspace(0.0, 1.0, spec.r_no)
    p = particle.build_params(model_input, dtype=dtype, device=device)
    d = particle.t2_derived(spec, p)
    sol = newton.root(lambda y: res_fn(y, p, d),
                      particle.t2_initial_state(spec, p), max_iter=80)
    if not bool(sol.converged):
        raise RuntimeError(
            f"T2 root solve did not converge (|F|={float(sol.residual_norm):.2e})")

    pack = _particle_pack(
        spec, sol.x.reshape(spec.n_layer, spec.r_no).cpu().numpy(), p)
    xy_list, data_list = _xy_result(
        data_rs, pack["dataY"], list(spec.comp_list) + ["Temperature"], opts,
        "Dimensionless Particle Radius")
    return {"XYList": xy_list, "dataList": data_list, "dataPack": [pack]}


# ---------------------------------------------------------------------------
# T3 and M14: steady axial-dispersion models, solved as root problems
# ---------------------------------------------------------------------------

def _axial_grid(model_input, default_z_no):
    """(mesh, zNo, data_xs) of a steady axial-dispersion model
    (stencils.solver_grid, and the nodes' positions)."""
    from ..ops import stencils

    mesh, z_no = stencils.solver_grid(model_input, default_z_no)
    return mesh, z_no, (np.linspace(0.0, 1.0, z_no) if mesh is None
                        else np.asarray(mesh["xs"]))


def _run_t3(model_input, opts, device, dtype):
    """Steady axial-dispersion pseudo-homogeneous model (reference:
    examples/homoModels.py runT1; registered as T3Init in rmtCore.py:440
    but unreachable through the reference dispatcher -- routed here).

    Solved by pseudo-transient continuation (Radau to a large pseudo-time)
    followed by a damped-Newton polish; the reference's fsolve from the
    0.5/0.25 flat guess diverges for strongly exothermic cases."""
    from ..solvers import newton

    mesh, z_no, data_xs = _axial_grid(model_input, 10)
    spec = homo.build_spec(model_input, z_no=z_no)
    p = homo.t3_params(model_input, dtype=dtype, device=device)
    d = homo.t3_feed(spec, p)
    res_fn = homo.make_t3_residual(spec, mesh=mesh)
    c_in = (p["SpCoi0"] / d["Cmax"])[:, None].expand(spec.n_comp, z_no)
    rows = [c_in] + ([] if spec.iso_thermal else [torch.zeros_like(c_in[:1])])
    y0 = torch.cat(rows, dim=0).reshape(-1)
    # pseudo-transient continuation to the attractor of F
    ys, _ = radau.odeint(lambda t, y: res_fn(y, p, d), y0,
                         torch.tensor([0.0, 20.0], dtype=dtype, device=device),
                         rtol=1e-6, atol=1e-9)
    sol = newton.root(lambda y: res_fn(y, p, d), ys[-1], max_iter=50,
                      tol=1e-8)
    if not bool(sol.converged):
        raise RuntimeError(
            f"T3 root solve did not converge (|F|={float(sol.residual_norm):.2e})")

    n_layer = spec.n_comp + (0 if spec.iso_thermal else 1)
    resh = sol.x.reshape(n_layer, z_no).cpu().numpy()
    c_dl = resh[: spec.n_comp]
    theta = resh[spec.n_comp] if not spec.iso_thermal else np.zeros(z_no)
    c_max = float(np.max(np.asarray(model_input["feed"]["concentration"])))
    conc_re = c_dl * c_max                              # MAX-mode real values
    temp_re = (1.0 + theta) * float(
        model_input["operating-conditions"]["temperature"])
    mo_fri = conc_re / np.sum(conc_re, axis=0, keepdims=True)
    data_y = np.concatenate([mo_fri, temp_re[None]], axis=0)
    xy_list, data_list = _xy_result(
        data_xs, data_y, list(spec.comp_list) + ["Temperature"], opts,
        "Reactor Length (m)", "Concentration (mol/m^3)")
    return {"dataYs": data_y, "XYList": xy_list, "dataList": data_list}


def _run_m14(model_input, opts, device, dtype):
    """Steady heterogeneous packed bed with a lumped catalyst phase
    (reference: pbReactor.runM9 via rmtCore.M14Init, with a rampList
    kinetics continuation), solved on a row-scaled residual
    (hetero.m14_row_scales) by pseudo-transient continuation + damped
    Newton from the feed profile (hetero.make_m14_runner)."""
    from ..models import hetero

    mesh, z_no, data_xs = _axial_grid(model_input, 30)
    spec = hetero.m14_build_spec(model_input, z_no=z_no)
    if spec.iso_thermal:
        # the reference's iso-thermal branch pins T* = 0 but keeps the
        # temperature unknowns in the root system (pbReactor.py:8101-8104),
        # leaving them unconstrained -- a singular Jacobian for any root
        # solver. Refuse instead of silently solving the wrong system.
        raise NotImplementedError(
            "M14 iso-thermal is degenerate in the reference formulation "
            "(temperature unknowns decouple); use process-type "
            "'non-iso-thermal'"
        )
    p = hetero.m14_params(model_input, dtype=dtype, device=device)
    x, converged, res_norm = hetero.make_m14_runner(
        spec, mesh=mesh, ramp_list=hetero.m14_ramps(model_input))(p)
    if not converged:
        raise RuntimeError(
            f"M14 root solve did not converge (|F|={float(res_norm):.2e})")

    resh = x.reshape(spec.n_comp + 1, 2, z_no).cpu().numpy()
    c_max = float(np.max(np.asarray(model_input["feed"]["concentration"])))
    T0 = float(model_input["operating-conditions"]["temperature"])
    conc_gas = resh[: spec.n_comp, 0] * c_max
    conc_sol = resh[: spec.n_comp, 1] * c_max
    temp_gas = (1.0 + resh[spec.n_comp, 0]) * T0
    temp_sol = (1.0 + resh[spec.n_comp, 1]) * T0
    mo_fri = conc_gas / np.sum(conc_gas, axis=0, keepdims=True)
    labels = (list(spec.comp_list) + ["Gas Temp"]
              + list(spec.comp_list) + ["Solid Temp"])
    data_y = np.concatenate([mo_fri, temp_gas[None], conc_sol,
                             temp_sol[None]], axis=0)
    xy_list, data_list = _xy_result(data_xs, data_y, labels, opts,
                                    "Reactor Length (m)")
    return {"dataYs": data_y, "XYList": xy_list, "dataList": data_list,
            "dataPack": [{
                "successStatus": True,
                "dataYCoGas": conc_gas, "dataYCoSolid": conc_sol,
                "dataYTempGas": temp_gas, "dataYTempSolid": temp_sol,
            }]}


# ---------------------------------------------------------------------------
# M10-M13: dynamic heterogeneous packed beds
# ---------------------------------------------------------------------------

def _hetero_dyn_tols(model_input):
    """M10-M12's tolerance defaults, rtol 1e-5 / atol 1e-6 (rmt_tpu's: the
    near-zero product concentrations after the seed transient make a tight
    atol reject forever); explicit solver-config values win."""
    sc = model_input.get("solver-config", {})
    return float(sc.get("rtol", 1e-5)), float(sc.get("atol", 1e-6))


def _dyn_packs(spec, ys, t_bounds, solid=None):
    """dataPack of an M10-M12 run: ys (tNo, n) states in numpy; solid: the
    particle profiles to report per interval ((tNo, n_comp, rNo, zNo),
    (tNo, rNo, zNo)), by default the state's particle rows."""
    n_comp, z_no = spec.n_comp, spec.z_no
    packs = []
    for i in range(spec.t_no):
        Y = ys[i].reshape(spec.n_layer, spec.r_no + 1, z_no)
        conc_gas = Y[:n_comp, 0, :]
        temp_gas = Y[n_comp, 0, :][None]
        mo_fri = conc_gas / np.sum(conc_gas, axis=0)
        packs.append({
            "successStatus": True,
            "dataTime": t_bounds[i + 1],
            "dataYCon": conc_gas,
            "dataYTemp": temp_gas,
            "dataYs": np.concatenate([mo_fri, temp_gas], axis=0),
            "dataYCons": (Y[:n_comp, 1:, :] if solid is None
                          else solid[0][i]),
            "dataYTemps": (Y[n_comp, 1:, :] if solid is None
                           else solid[1][i]),
        })
    return packs


def _dyn_result(spec, packs, data_xs, x_label, opts, start, extra):
    labels = list(spec.comp_list) + ["Temperature"]
    xy_list, data_list = _xy_result(data_xs, packs[-1]["dataYs"], labels,
                                    opts, x_label)
    return {"XYList": xy_list, "dataList": data_list, "dataPack": packs,
            "computation-time": roundNum(timer() - start), **extra}


def _run_coupled_dyn(model_input, opts, device, dtype, model_id):
    """M10, M11 or M12: one stiff MoL system over (noLayer, rNo+1, zNo),
    gas row + particle rows, integrated across the tNo output intervals in
    one multi-segment Radau run with the two-phase colored Jacobian
    (rmt_tpu's column colors by forward mode; here row colors by reverse
    mode, ops/jacobian.two_phase_row_coloring: the same matrix).

    M11 (reference pbReactor.runM7): the FDM particle, rNo from
    solver-config (default 7), zNo 10, tNo 5, the refined mesh honored.
    M12 (runM8): the OC particle (rNo pinned to the 7-point basis, the
    surface row dead storage; dataYCons/dataYTemps report the recomputed
    interface values), zNo 10, tNo 5, the refined mesh honored, the
    interface projected onto c >= EPS. M10 (runM6): real units, the OC
    particle, the (P, v) march, zNo 100, tNo 10 (solverSetting S2), the
    uniform grid. Each whose reference cannot run is rmt_tpu's salvage
    (models/hetero_dyn.py)."""
    from ..models import hetero_dyn
    from ..ops import jacobian as jac_ops
    from ..ops import stencils

    sc = model_input.get("solver-config", {})
    if model_id == "M10":
        zmesh, z_no = None, int(sc.get("zNo", 100))
        r_no, t_no = 7, int(sc.get("tNo", 10))
    else:
        zmesh, z_no = stencils.solver_grid(model_input, 10)
        r_no = int(sc.get("rNo", 7)) if model_id == "M11" else 7
        t_no = int(sc.get("tNo", 5))
    spec = hetero_dyn.m13_build_spec(model_input, z_no=z_no, r_no=r_no,
                                     t_no=t_no)
    rtol, atol = _hetero_dyn_tols(model_input)
    start = timer()
    if model_id == "M10":
        p = hetero_dyn.m10_params(model_input, dtype=dtype, device=device)
        args = (p,)
        rhs = hetero_dyn.make_m10_rhs(spec, clamp_interface=True)
        y_default = hetero_dyn.m10_initial_state(spec, p)
    else:
        p = hetero_dyn.m13_params(model_input, dtype=dtype, device=device)
        args = (p, hetero_dyn.m13_feed(spec, p))
        rhs = (hetero_dyn.make_m11_rhs(spec, mesh=zmesh) if model_id == "M11"
               else hetero_dyn.make_m12_rhs(spec, clamp_interface=True,
                                            mesh=zmesh))
        y_default = hetero_dyn.m11_initial_state(spec, p)
    y_init, t_start = _resume_or(model_input, y_default,
                                 int(y_default.shape[0]), model_id)
    ts = (t_start + p["opT"] * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=dtype, device=device)).to(dtype)
    jac = jac_ops.row_colored_jacobian_from(
        lambda t, y: rhs(t, y, *args), jac_ops.two_phase_row_coloring(
            spec.n_layer, spec.r_no + 1, spec.z_no))
    ys, stats = radau.odeint(lambda t, y: rhs(t, y, *args), y_init, ts,
                             rtol=rtol, atol=atol, jac=jac)
    _check_integration(stats, model_id)
    solid = None
    if model_id == "M12":
        # the dead surface-storage row replaced by the recomputed
        # algebraic interface value (OC order, center-first)
        surf = [hetero_dyn.m12_surface_values(spec, *args, y) for y in ys[1:]]
        solid = tuple(torch.stack(v).cpu().numpy() for v in zip(*surf))
    ys_t = ys[1:].cpu().numpy()
    t_bounds = ts.cpu().numpy()
    if model_id == "M10":
        data_xs, x_label = (np.linspace(0.0, float(p["ReLe"]), z_no),
                            "Reactor Length (m)")
    else:
        data_xs = (np.linspace(0.0, 1.0, z_no) if zmesh is None
                   else np.asarray(zmesh["xs"]))
        x_label = "Dimensionless Reactor Length"
    return _dyn_result(
        spec, _dyn_packs(spec, ys_t, t_bounds, solid), data_xs,
        x_label, opts, start, {
            "solverStats": _stats_dict(stats),
            "checkpoint": {"model": model_input["model"],
                           "t": float(t_bounds[-1]),
                           "state": ys_t[-1].copy()}})


def _m13_resume(model_input, spec, dtype, device):
    """(y_gas0 (1, n_layer*zNo), y_solid0 (1, n_layer, rNo, zNo), t_start)
    of an M13 run: None, None, 0 without resume-state; the checkpoint
    carries both phases ("gas", "solid"), since M13's staggered exchange
    has no flat state."""
    resume = model_input.get("resume-state")
    if resume is None:
        return None, None, 0.0
    if resume.get("model") != "M13":
        raise ValueError(f"resume-state is for model {resume.get('model')!r}, "
                         "not 'M13'")

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    y_gas0 = tensor(resume["gas"]).reshape(-1)
    y_solid0 = tensor(resume["solid"])
    if y_gas0.shape[0] != spec.n_layer * spec.z_no:
        raise ValueError(
            f"resume-state gas has {y_gas0.shape[0]} entries; this grid "
            f"needs {spec.n_layer * spec.z_no}")
    want = (spec.n_layer, spec.r_no, spec.z_no)
    if tuple(y_solid0.shape) != want:
        raise ValueError(f"resume-state solid has shape "
                         f"{tuple(y_solid0.shape)}; this grid needs {want}")
    return y_gas0[None], y_solid0[None], float(resume.get("t", 0.0))


def _run_m13(model_input, opts, device, dtype):
    """Dynamic heterogeneous packed bed by operator splitting (reference
    pbHeterReactor.runM2 via rmtCore.M13Init; models/hetero_dyn.
    make_m13_driver), zNo 10, rNo 7, tNo 5 or the refined mesh, at
    solver-config rtol/atol (defaults 1e-7 / 1e-10). The gas state is
    carried across intervals (rmt_tpu's documented deviation: the
    reference re-seeds a dead variable, :1148). Raises at the first failed
    interval, solid or gas, as rmt_tpu does."""
    from ..models import hetero_dyn
    from ..ops import stencils

    sc = model_input.get("solver-config", {})
    mesh, z_no = stencils.solver_grid(model_input, 10)
    spec = hetero_dyn.m13_build_spec(model_input, z_no=z_no,
                                     r_no=int(sc.get("rNo", 7)),
                                     t_no=int(sc.get("tNo", 5)))
    p = hetero_dyn.m13_params(model_input, dtype=dtype, device=device)
    y_gas0, y_solid0, t_start = _m13_resume(model_input, spec, dtype, device)
    start = timer()
    gas_t, solid_t, conv_t, unr_t, ts_grid = hetero_dyn.make_m13_driver(
        spec, mesh=mesh, rtol=opts["rtol"], atol=opts["atol"])(
            p, y_gas0=y_gas0, y_solid0=y_solid0, t_start=t_start)
    unr = unr_t[0].cpu().numpy()
    conv = conv_t[0].cpu().numpy()
    if unr.sum() or not conv.all():
        # report the FIRST failure: a diverged solid interface poisons all
        # later gas intervals
        first_gas = int(np.argmax(unr > 0)) if unr.sum() else len(unr)
        first_sol = int(np.argmax(~conv)) if not conv.all() else len(conv)
        if first_sol < first_gas:
            bad = [i for i, c in enumerate(conv) if not c]
            raise RuntimeError(f"M13: solid BVP Newton did not converge at "
                               f"interval(s) {bad}")
        raise RuntimeError(
            f"M13: gas-phase integrator failed to reach {int(unr.sum())} "
            f"interval boundary(ies) within the step budget (first at "
            f"interval {first_gas})")

    gas_t = gas_t[0].cpu().numpy()          # (tNo, n_layer*zNo)
    solid_t = solid_t[0].cpu().numpy()      # (tNo, n_layer, rNo, zNo)
    t_bounds = ts_grid.cpu().numpy()
    n_comp = spec.n_comp
    c_max = float(torch.max(p["SpCoi0"]))
    T0 = float(p["T0"])
    packs = []
    for i in range(spec.t_no):
        Yg = gas_t[i].reshape(spec.n_layer, z_no)
        conc_dl = Yg[:n_comp]
        temp_dl = Yg[n_comp:n_comp + 1]
        packs.append({
            "successStatus": True,
            "dataTime": t_bounds[i + 1],
            "dataYCon": conc_dl,
            "dataYTemp": temp_dl,
            "dataYs": np.concatenate(
                [conc_dl / np.sum(conc_dl, axis=0), temp_dl], axis=0),
            # the solid phase's real profiles, r index 0 = interface (the
            # reference returns empty lists here)
            "dataYCons": solid_t[i][:n_comp] * c_max,
            "dataYTemps": solid_t[i][n_comp] * T0 + T0,
        })
    data_xs = (np.linspace(0.0, 1.0, z_no) if mesh is None
               else np.asarray(mesh["xs"]))
    return _dyn_result(
        spec, packs, data_xs, "Dimensionless Reactor Length",
        opts, start, {"checkpoint": {"model": "M13",
                                     "t": float(t_bounds[-1]),
                                     "gas": gas_t[-1].copy(),
                                     "solid": solid_t[-1].copy()}})


# ---------------------------------------------------------------------------

def rmtExe(modelInput: Mapping[str, Any], device=None):
    """Check model input, then start computation (reference: rmt.py:21-80),
    in config.default_float() on ``device`` (default: the CUDA card;
    without one it raises, see config.resolve_device; pass device="cpu"
    for the CPU).

    Set RMT_TORCH_PROFILE=<dir> to write a torch.profiler Chrome trace of
    the call into <dir> (host operations, and the card's kernels when the
    call runs on one; viewable in Perfetto or chrome://tracing), the
    counterpart of rmt_tpu's RMT_TPU_PROFILE.
    """
    profile_dir = os.environ.get("RMT_TORCH_PROFILE")
    if not profile_dir:
        return _rmt_exe_inner(modelInput, device)
    dev = torch.device(device) if device is not None else (
        config.default_device())
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda" and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    # profiler sessions cannot nest: a caller that already holds one must
    # not turn an opt-in debug switch into a failure -- run untraced
    try:
        if torch.autograd._profiler_enabled():
            raise RuntimeError("a profiler is already running")
        prof.start()
    except RuntimeError as e:
        warnings.warn(f"RMT_TORCH_PROFILE: trace not started ({e}); "
                      "running un-profiled", RuntimeWarning)
        return _rmt_exe_inner(modelInput, device)
    try:
        return _rmt_exe_inner(modelInput, device)
    finally:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"rmtExe-{os.getpid()}-{time.time_ns()}.json"))


def _rmt_exe_inner(modelInput: Mapping[str, Any], device):
    tic = timer()
    _validate_model_input(modelInput)
    model_type = modelInput["model"]
    _check_components(modelInput)

    # the two-zone refined mesh exists only where the reference honors it
    # (runM7/runM8/runM9, pbHeterReactor.runM2, homoModels.runT1); for
    # every other model the key would be silently ignored -- reject instead
    sc_mesh = modelInput.get("solver-config", {}).get("mesh", "normal")
    if sc_mesh != "normal" and model_type not in _MESH_MODELS:
        raise ValueError(
            f"solver-config mesh={sc_mesh!r} is not supported by model "
            f"{model_type!r} (refined-mesh models: {sorted(_MESH_MODELS)})"
        )
    if model_type not in _PORTED:
        raise NotImplementedError(
            f"model id {model_type!r} is not implemented (neither rmt_tpu "
            f"nor rmt_tpu_torch has it; ported: {', '.join(_PORTED)})")
    opts = _solver_options(modelInput)
    device = config.resolve_device(device)
    dtype = config.default_float()
    if model_type in ("N1", "N2"):
        spec = homo.build_spec(modelInput)
        run = _run_n1 if model_type == "N1" else _run_n2
        res_model = run(modelInput, spec, opts, device, dtype)
        if opts["display"]:
            from ..io import plot as _plot

            if model_type == "N1":
                _plot.plot_results_steady_state(res_model)
            else:
                _plot.plot_results_dynamic(res_model, spec.t_no)
    elif model_type in ("M0", "M4"):
        res_model = _run_pf(modelInput, opts, device, dtype)
    elif model_type == "M1":
        res_model = _run_m1(modelInput, opts, device, dtype)
    elif model_type in ("M2", "M9"):
        res_model = _run_m2(modelInput, opts, device, dtype, model_type)
    elif model_type == "M3":
        res_model = _run_batch(modelInput, opts, device, dtype)
    elif model_type in ("M7", "M8"):
        res_model = _run_m_conc_steady(modelInput, opts, device, dtype,
                                       model_type)
    elif model_type in ("M10", "M11", "M12"):
        res_model = _run_coupled_dyn(modelInput, opts, device, dtype,
                                     model_type)
    elif model_type == "M13":
        res_model = _run_m13(modelInput, opts, device, dtype)
    else:   # M5, M14, T1, T2, T3
        res_model = {"M5": _run_m5, "M14": _run_m14, "T1": _run_t1,
                     "T2": _run_t2, "T3": _run_t3}[model_type](
            modelInput, opts, device, dtype)

    com_time = (timer() - tic) * 1000
    return {"resModel": res_model, "comTime": com_time}
