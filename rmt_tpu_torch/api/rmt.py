# Public API: rmtExe(modelInput) / rmtCom() (port of the N1/N2 slice of
# rmt_tpu/api/rmt.py).
#
# Same dict-in / dataPack-out contract as the reference
# (PyREMOT/rmt.py:21-92, PyREMOT/docs/rmtCore.py:63-127): modelInput
# validated, model id dispatched, result wrapped as {"resModel": ...,
# "comTime": ...}, with rmt_tpu's keys and value shapes. N1 and N2 run on
# the sequential integrators of solvers/ (radau, dopri5, fixed.precorr3)
# in config.default_float() on the CUDA card, or on the device the caller
# names. Eager PyTorch compiles nothing, so there is no cache of built
# programs. Every other model id of rmt_tpu raises NotImplementedError
# until its port lands. display-result "True" plots the result after the
# run through io/plot (matplotlib on the host), as rmt_tpu does;
# RMT_TORCH_PROFILE=<dir> writes a torch.profiler trace of the call.

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
from ..models import homo
from ..solvers import dopri5, fixed, radau
from ..utils import roundNum

ISO = homo.ISO_THERMAL

# model ids of rmt_tpu; the port runs _PORTED and raises
# NotImplementedError for the rest until their build step lands
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
_PORTED = ("N1", "N2")

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
        where = ("rmt_tpu has it, the port does not have it yet"
                 if model_type in _MODEL_IDS else "no package implements it")
        raise NotImplementedError(
            f"model id {model_type!r} is not implemented in rmt_tpu_torch "
            f"({where}; ported: {', '.join(_PORTED)})"
        )
    opts = _solver_options(modelInput)
    device = config.resolve_device(device)
    dtype = config.default_float()
    spec = homo.build_spec(modelInput)
    run = _run_n1 if model_type == "N1" else _run_n2
    res_model = run(modelInput, spec, opts, device, dtype)
    if opts["display"]:
        from ..io import plot as _plot

        if model_type == "N1":
            _plot.plot_results_steady_state(res_model)
        else:
            _plot.plot_results_dynamic(res_model, spec.t_no)

    com_time = (timer() - tic) * 1000
    return {"resModel": res_model, "comTime": com_time}
