# Ensemble execution of the homogeneous models and the heterogeneous
# design sweeps (port of the N1/N2 slice and of run_m10_sweep,
# run_m11_sweep, run_m12_sweep, run_m13_sweep and run_m14_sweep of
# rmt_tpu/parallel/ensemble.py).
#
# A batch of reactors -- any leaf of the parameter dict may be swept:
# inlet T/P/composition, geometry, heat exchange, and the kinetic
# constants through kinetic overrides -- integrates as one ensemble on one
# device, or over a dp mesh (parallel/mesh.py: a torch.distributed
# process group, mesh=) as one block of members a rank. Entry points:
#
#   * run_n2_ensemble / make_n2_ensemble / make_n1_ensemble: the
#     reference's jax.vmap of the sequential radau.odeint (or
#     dopri5.odeint), here the member-batched loop of
#     solvers/radau.py::odeint_batched (dopri5.odeint_batched), which
#     gives every member the result it gets alone. float64 by default
#     (config.default_float()).
#   * run_m14_sweep: the steady M14 solve of every member (the
#     reference's jax.vmap of models.hetero.make_m14_runner) as
#     radau.odeint_batched and then newton.root_batched(like_root=True).
#   * run_m10_sweep, run_m11_sweep, run_m12_sweep: the coupled dynamic
#     heterogeneous transients of every member (the reference's jax.vmap
#     of radau.odeint with the two-phase colored Jacobian) on
#     radau.odeint_batched, the Jacobian colored over the whole batch.
#   * run_m13_sweep: the M13 split driver of every member; engine="vmap"
#     is models/hetero_dyn.make_m13_driver over the batch, engine=
#     "lockstep" the gas phase on the lockstep integrator in tridiagonal
#     block mode and every node's particle on root_batched in tridiagonal
#     block mode with the bulk-homotopy rescue, one host read an interval
#     deciding whether the rescue runs.
#   * run_n2_ensemble_lockstep: the lockstep integrator, float32 states
#     by default (float64 with dtype=). Stage residuals go through the
#     fused N2 RHS (ops/cuda_rhs.py: the generated CUDA kernel for
#     tensors on the card, its plain twin on the CPU) where the mode
#     allows it, else through the PyTorch RHS (accurate_rates True and
#     "full", batched_rhs, fused_rhs=False, float64). The stage systems
#     are solved either by Newton-Schulz preconditioners kept warm by the
#     fused kernel of ops/cuda_ns.py, from the dense Jacobian, or
#     (exact_solve=True) exactly by the block kernels of
#     ops/cuda_block.py, from Jacobian blocks gathered by colored JVPs.
#     microbatch=K bounds the live state: a host loop integrates the
#     sweep K members at a time and joins the slices.
#
# mesh= follows rmt_tpu's calling convention: every rank passes the same
# whole sweep, the entry point keeps this rank's block of members
# (mesh.shard_batch) and returns, on every rank, the whole batch's
# result in member order (the counterpart of JAX's global array); the
# scalar counters are the whole batch's. Left out: lower_only (XLA
# lowering, which PyTorch has no counterpart for).

from __future__ import annotations

import time
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..models import homo
from ..ops import cuda_rhs
from ..solvers import dopri5, radau, stiff_ensemble
# make_mesh and shard_batch are re-exported: rmt_tpu keeps them here
from .mesh import (any_across, device_for, gather_members, gather_tree,
                   make_mesh, shard_batch, shard_rows)  # noqa: F401

_f32, _f64 = torch.float32, torch.float64


def batch_params(base: Mapping[str, Any], sweep: Mapping[str, Any]):
    """Put swept leaves into the parameter dict.

    sweep maps a top-level parameter name (e.g. "T0", "P0", "SpCoi0") or a
    kinetic-override name (e.g. "K1") to an array whose leading axis is
    the ensemble axis. Returns (params, in_dims) ready for torch.func.vmap:
    in_dims mirrors params with 0 on swept leaves and None elsewhere.
    """
    ref = base["T0"]
    params = dict(base)
    axes = {k: None for k in base}
    axes["kinetic_overrides"] = {k: None for k in base["kinetic_overrides"]}
    ko = dict(base["kinetic_overrides"])
    for name, arr in sweep.items():
        arr = torch.as_tensor(np.asarray(arr), dtype=ref.dtype,
                              device=ref.device)
        if name in params:
            params[name] = arr
            axes[name] = 0
        else:
            ko[name] = arr
            axes["kinetic_overrides"][name] = 0
    params["kinetic_overrides"] = ko
    return params, axes


def _cast(tree, dtype):
    if isinstance(tree, Mapping):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _broadcast(params, axes, Bsz):
    """Every leaf with a leading member axis (the fused RHS reads
    per-member leaves)."""
    out = {}
    for key, val in params.items():
        if isinstance(val, Mapping):
            out[key] = _broadcast(val, axes[key], Bsz)
        elif axes[key] == 0:
            out[key] = val
        else:
            out[key] = val.expand((Bsz,) + tuple(val.shape))
    return out


def _solver(kind: str):
    """The integrator module of a solver name (radau or dopri5)."""
    return {"radau": radau, "dopri5": dopri5}[kind]


def _gathered(mesh, out):
    """A sweep's result dict with every per-member entry gathered over
    the mesh (unchanged without one); the shared output times "ts" and
    the whole batch's counter "rescued" as they are."""
    if mesh is None:
        return out
    return {k: v if k in ("ts", "rescued") else gather_members(mesh, v)
            for k, v in out.items()}


def _batch_size(sweep):
    """The member count of a sweep (its first swept leaf's length)."""
    return len(next(iter(sweep.values())))


def _repeat(params, axes, reps):
    """params with every swept leaf's members repeated ``reps`` times in
    place (member b at rows b*reps ... b*reps + reps - 1)."""
    out = {}
    for key, val in params.items():
        if isinstance(val, Mapping):
            out[key] = _repeat(val, axes[key], reps)
        elif axes[key] == 0:
            out[key] = val.repeat_interleave(reps, dim=0)
        else:
            out[key] = val
    return out


def _batched_problem(spec, params, axes, rhs, initial_state, grid):
    """The member-batched problem of a sweep: (f, f_stages, y0 (B, n),
    ts (B, T)). f(t (B,), y (B, n)) maps the per-member rhs over members;
    f_stages evaluates the three Radau stages of every member as one batch
    of 3B rows (row 3b + i is stage i of member b, with member b's
    parameters and feed state); grid(p) gives a member's output times."""
    def derive(q):
        d = homo.feed_state(spec, q)
        return d, initial_state(spec, q, d), grid(q)

    d, y0, ts = vmap(derive, in_dims=(axes,))(params)
    fB = vmap(rhs, in_dims=(0, 0, axes, 0))
    p3 = _repeat(params, axes, 3)
    d3 = {k: v.repeat_interleave(3, dim=0) for k, v in d.items()}
    n = y0.shape[1]

    def f(t, y):
        return fB(t, y, params, d)

    def f_stages(t_st, Y):
        return fB(t_st.reshape(-1), Y.reshape(-1, n), p3, d3).reshape(Y.shape)

    return f, f_stages, y0, ts.to(y0.dtype)


def _batched_runner(spec, rhs, initial_state, grid, rtol, atol, solver,
                    solver_kwargs):
    """fn(params, axes) -> (ys (B, T, n), stats) of the member-batched
    integrator ``solver`` on a sweep."""
    integrator = _solver(solver)

    def run(params, axes):
        f, f_stages, y0, ts = _batched_problem(spec, params, axes, rhs,
                                               initial_state, grid)
        kw = dict(solver_kwargs)
        if solver == "radau":
            kw["f_stages"] = f_stages
        return integrator.odeint_batched(f, y0, ts, rtol=rtol, atol=atol,
                                         **kw)

    return run


def _runners(spec, rhs, initial_state, grid, rtol, atol, solver, mesh=None):
    """(single, build) of a model on the sequential integrator: single(p)
    integrates one member's parameters, (ys (T, n), n_fev); build(axes)
    returns fn(params) -> (ys (B, T, n), n_fev (B,)) over a sweep whose
    batched leaves ``axes`` marks, every member with the result single
    gives it up to rounding (the stages are batched differently). With a
    mesh, fn takes this rank's share of the sweep (shard_batch) and
    returns the whole batch's result."""
    def single(p):
        d = homo.feed_state(spec, p)
        y0 = initial_state(spec, p, d)
        ys, stats = _solver(solver).odeint(
            lambda t, y: rhs(t, y, p, d), y0, grid(p).to(y0.dtype),
            rtol=rtol, atol=atol)
        return ys, stats.n_fev

    run = _batched_runner(spec, rhs, initial_state, grid, rtol, atol, solver,
                          {})

    def build(axes):
        def fn(params):
            ys, stats = run(params, axes)
            if mesh is not None:
                return gather_members(mesh, ys), gather_members(mesh,
                                                                stats.n_fev)
            return ys, stats.n_fev

        return fn

    return single, build


def _n2_grid(spec):
    """A member's N2 output times: opT * linspace(0, 1, tNo + 1)."""
    def grid(p):
        return p["opT"] * torch.linspace(0.0, 1.0, spec.t_no + 1,
                                         dtype=p["opT"].dtype,
                                         device=p["opT"].device)

    return grid


def make_n2_ensemble(spec: homo.HomoSpec, rtol: float = 1e-7,
                     atol: float = 1e-10, solver: str = "radau", mesh=None):
    """(single, build) runners of the N2 dynamic model on the sequential
    integrator (rmt_tpu's make_n2_ensemble; see _runners): ys
    (tNo+1, n) a member, each member with its own output times when opT
    is swept. With a mesh, build(axes)'s fn takes this rank's share of
    the sweep (shard_batch, as rmt_tpu's callers place theirs) and
    returns the whole batch's result on every rank. For the lockstep
    integrator use run_n2_ensemble_lockstep."""
    if mesh is not None:
        device_for(mesh, None)
    return _runners(spec, homo.make_n2_rhs(spec), homo.n2_initial_state,
                    _n2_grid(spec), rtol, atol, solver, mesh)


def run_n2_ensemble(model_input: Mapping[str, Any], sweep: Mapping[str, Any],
                    rtol: float = 1e-7, atol: float = 1e-10,
                    solver: str = "radau", mesh=None, device=None,
                    return_stats: bool = False, **solver_kwargs):
    """One-call ensemble sweep of the N2 dynamic model on the sequential
    integrator (rmt_tpu's run_n2_ensemble), in config.default_float() on
    ``device`` (default: the CUDA card; without one it raises, see
    config.resolve_device). solver_kwargs (max_steps, timings, ...) go to
    the member-batched integrator.

    Returns (ys, nfev): ys (B, tNo+1, varNo*zNo) dimensionless states,
    nfev (B,); with return_stats=True (ys, stats), the integrator's
    per-member statistics (radau.RadauStats / dopri5.Dopri5Stats). With
    a mesh (on its device) this rank integrates its block of members and
    every rank returns the whole batch's result.
    """
    device = device_for(mesh, device)
    spec = homo.build_spec(model_input)
    base = homo.build_params(model_input, device=device)
    params, axes = batch_params(base, sweep)
    if mesh is not None:
        params = shard_batch(mesh, params, axes)
    run = _batched_runner(spec, homo.make_n2_rhs(spec), homo.n2_initial_state,
                          _n2_grid(spec), rtol, atol, solver, solver_kwargs)
    ys, stats = run(params, axes)
    if mesh is not None:
        ys, stats = gather_members(mesh, ys), gather_tree(mesh, stats)
    return (ys, stats) if return_stats else (ys, stats.n_fev)


def make_n1_ensemble(spec: homo.HomoSpec, rtol: float = 1e-7,
                     atol: float = 1e-10, solver: str = "radau",
                     z_out: int | None = None):
    """(single, build) runners of the steady model, profiles over z
    (rmt_tpu's make_n1_ensemble; see _runners): ys (z_out+1, n) a
    member."""
    n_out = (z_out if z_out is not None else spec.z_out) + 1

    def grid(p):
        return torch.linspace(0.0, 1.0, n_out, dtype=p["T0"].dtype,
                              device=p["T0"].device)

    return _runners(spec, homo.make_n1_rhs(spec), homo.n1_initial_state,
                    grid, rtol, atol, solver)


class N2Ensemble(NamedTuple):
    spec: homo.HomoSpec
    params: dict          # the RHS's parameters, swept leaves batched
    axes: dict            # vmap in_dims of params
    d: dict               # (B, ...) feed state, params' dtype
    y0: torch.Tensor      # (B, n) initial states, the integrator's dtype
    ts: torch.Tensor      # (tNo+1,) output grid, the integrator's dtype
    leaves1: torch.Tensor  # the fused RHS's packed float32 leaves
    leaves2: torch.Tensor
    ko_keys: tuple


def prepare_n2_ensemble(model_input: Mapping[str, Any],
                        sweep: Mapping[str, Any], device=None,
                        dtype=_f32, rhs_dtype=None, mesh=None) -> N2Ensemble:
    """The inputs of an N2 lockstep ensemble on ``device`` (default: the
    CUDA card; without one, a call that names no device raises instead of
    running on the CPU, see config.resolve_device): states and output
    grid in ``dtype`` (float32 by default), parameters and feed state in
    ``rhs_dtype`` (default dtype).

    A float32 RHS follows the reference's hybrid cast
    (rmt_tpu/parallel/ensemble.py, hybrid_cast): parameters are rounded to
    float32 and the feed state is derived from them (here in float64,
    then rounded), so the integrated problem is the one the JAX package
    integrates. A float64 RHS keeps the float64 parameters and derives
    its feed state from them (accurate_rates="full", dtype=float64).
    With a mesh, the inputs of this rank's block of members, on the
    mesh's device.
    """
    if "opT" in sweep:
        raise ValueError("the lockstep integrator requires a shared period")
    if not sweep:
        raise ValueError("the sweep must name at least one batched leaf")
    rhs_dtype = rhs_dtype or dtype
    device = device_for(mesh, device)
    spec = homo.build_spec(model_input)
    base = homo.build_params(model_input, dtype=_f64, device=device)
    params, axes = batch_params(base, sweep)
    if mesh is not None:
        params = shard_batch(mesh, params, axes)
    p_rhs = _cast(params, rhs_dtype)

    def derive(q):
        d = homo.feed_state(spec, q)
        return d, homo.n2_initial_state(spec, q, d)

    dB, y0B = vmap(derive, in_dims=(axes,))(_cast(p_rhs, _f64))
    dB, y0B = _cast(dB, rhs_dtype), y0B.to(dtype)
    ts = (p_rhs["opT"].to(_f64) * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=_f64, device=device)).to(dtype)
    ko_keys = tuple(sorted(p_rhs["kinetic_overrides"]))
    leaves1, leaves2 = cuda_rhs.pack_leaves(
        _broadcast(p_rhs, axes, y0B.shape[0]), dB, ko_keys)
    return N2Ensemble(spec, p_rhs, axes, dB, y0B, ts, leaves1, leaves2,
                      ko_keys)


def _check_lockstep_options(accurate_rates, cheap_sweeps, exact_solve,
                            colored_jacobian, batched_rhs, fused_rhs, dtype):
    """rmt_tpu's argument checks of run_n2_ensemble_lockstep, with its
    error types and messages (no x64 check: float64 is native here), and
    the port's dtype checks."""
    if accurate_rates not in (False, True, "full", "df32"):
        raise ValueError(f"unknown accurate_rates {accurate_rates!r}: "
                         "False, True, 'full' or 'df32'")
    if cheap_sweeps:
        if not accurate_rates:
            raise ValueError(
                "cheap_sweeps only makes sense with an accurate_rates mode "
                "(the plain RHS IS the cheap one otherwise)")
        if batched_rhs:
            raise ValueError("cheap_sweeps + batched_rhs not supported")
    if exact_solve and not colored_jacobian:
        raise ValueError("exact_solve requires colored_jacobian=True")
    if batched_rhs and accurate_rates not in (False, "df32"):
        raise ValueError(
            "batched_rhs supports plain f32 or accurate_rates='df32' only "
            "(the x64-hybrid legs keep the vmapped path)")
    if fused_rhs:
        if accurate_rates not in (False, "df32"):
            raise ValueError(
                "fused_rhs supports plain f32 or accurate_rates='df32' only "
                "(the x64-hybrid legs keep the vmapped path)")
        if batched_rhs:
            raise ValueError("fused_rhs and batched_rhs are exclusive")
    if dtype not in (_f32, _f64):
        raise ValueError(f"dtype {dtype} is neither float32 nor float64")
    if dtype == _f64:
        if accurate_rates:
            raise ValueError(
                "the accurate_rates modes integrate float32 states; "
                "dtype=float64 takes accurate_rates=False")
        if fused_rhs:
            raise ValueError("the fused RHS kernel is float32 only; "
                             "dtype=float64 takes fused_rhs=False or None")


def run_n2_ensemble_lockstep(
    model_input: Mapping[str, Any],
    sweep: Mapping[str, Any],
    rtol: float = 1e-7,
    atol: float = 1e-10,
    mesh=None,
    colored_jacobian: bool = True,
    microbatch: int | None = None,
    exact_solve: bool = False,
    accurate_rates: bool | str = False,
    batched_rhs: bool | None = None,
    cheap_sweeps: int = 0,
    fused_rhs: bool | None = None,
    dtype=_f32,
    device=None,
    **solver_kwargs,
):
    """N2 dynamic ensemble on the lockstep Radau integrator
    (rmt_tpu's run_n2_ensemble_lockstep), float32 states by default.

    exact_solve=False (the default) solves the Radau stage systems with
    float32 Newton-Schulz preconditioners (ns_refresh / ns_step pass
    through to the integrator) from the dense Jacobian: colored JVPs of
    the RHS with the pressure march frozen (colored_jacobian=True), or
    one JVP a state entry of the whole RHS (colored_jacobian=False).
    exact_solve=True solves them exactly through the block-bidiagonal
    structure of the MoL Jacobian (its blocks from the colored JVPs;
    requires colored_jacobian=True).

    accurate_rates: False evaluates the RHS in plain float32; "df32" the
    kinetics chain, nu@R and the heat-of-reaction sum in compensated
    double-float32 pairs (ops/df32.py); True the kinetics chain, nu@R and
    the heat of reaction in float64 inside a float32 evaluation (float32
    parameters); "full" the whole RHS and its Jacobian in float64 on
    float64 parameters and feed state (the state is cast up on entry and
    the results back to float32). The integrator's states, stages, step
    control and stage solves stay float32 in every mode.

    fused_rhs: the residual RHS calls through the generated fused kernel
    (ops/cuda_rhs.py; its plain twin on the CPU). None (the default):
    wherever the mode allows it (plain float32 or "df32", not
    batched_rhs, float32 states); True demands it; False evaluates the
    per-member make_n2_rhs under torch.func.vmap. batched_rhs=True
    evaluates the RHS and its colored Jacobian through
    homo.make_n2_rhs_b, the member-last RHS (plain or "df32"; default
    None: off, as in rmt_tpu). The Jacobian never goes through the
    kernel: it differentiates the PyTorch RHS.

    cheap_sweeps=k (an accurate_rates mode): the first k Newton sweeps of
    every attempt use the plain float32 RHS (the fused kernel unless
    fused_rhs=False; for "full" the float64 RHS, as rmt_tpu's promotion
    lifts it), the rest the accurate one.

    dtype=torch.float64 integrates float64 states (accurate_rates False,
    the fused kernel off): the RHS and its Jacobian in float64, the
    preconditioner algebra and the block solves in float32 (rmt_tpu
    picks float64 by its process's x64 switch; the port takes it per
    call).

    The inputs are made by prepare_n2_ensemble on ``device``: the CUDA
    card unless the caller names another (pass device="cpu" for the
    CPU; with no card and no device= it raises).

    mesh (parallel.mesh.Mesh, on its device): every rank passes the
    whole sweep and integrates its block of members; the integrator ORs
    its per-chunk flags over the ranks, so every rank runs the whole
    batch's chunks and rescues. Every rank returns the whole batch's ys
    (or, with out_members, the probes in the caller's order, each
    recorded by the rank that holds it, and every member's final state)
    and per-member statistics, in member order; n_jev and n_rescue are
    the unsharded run's. Not with microbatch (ValueError, as rmt_tpu).

    microbatch=K (K < B, B a multiple of K): the sweep's members are
    integrated K at a time, one call of the single-batch path for each
    slice in order, and the slices are joined along the member axis: ys
    concatenated, the per-member statistics concatenated and the scalar
    counters (n_jev, n_rescue) summed. Each member's result is the one a
    separate call on its slice gives. Not with out_members (its indices
    are global, the slices local). K >= B is the single call.

    Returns (ys, stats) with ys (tNo+1, B, varNo*zNo) dimensionless
    states; with out_members=<int index array> (forwarded to
    stiff_ensemble.odeint_ensemble) the return is (ys_sel, y_final,
    stats).
    """
    _check_lockstep_options(accurate_rates, cheap_sweeps, exact_solve,
                            colored_jacobian, batched_rhs, fused_rhs, dtype)
    if microbatch is not None:
        b_total = _batch_size(sweep) if sweep else 0
        if b_total > microbatch:
            if mesh is not None:
                raise ValueError("microbatch and mesh are mutually exclusive")
            return _run_microbatches(
                model_input, sweep, b_total, int(microbatch),
                dict(rtol=rtol, atol=atol, exact_solve=exact_solve,
                     accurate_rates=accurate_rates,
                     cheap_sweeps=cheap_sweeps,
                     colored_jacobian=colored_jacobian,
                     batched_rhs=batched_rhs, fused_rhs=fused_rhs,
                     dtype=dtype, device=device, **solver_kwargs))
    full = accurate_rates == "full"
    df32_mode = accurate_rates == "df32"
    use_batched = bool(batched_rhs)
    use_fused = (bool(fused_rhs) if fused_rhs is not None else
                 accurate_rates in (False, "df32") and not use_batched
                 and dtype == _f32)
    e = prepare_n2_ensemble(model_input, sweep, device, dtype=dtype,
                            rhs_dtype=_f64 if full else dtype, mesh=mesh)
    spec, p, axes, dB, y0B = e.spec, e.params, e.axes, e.d, e.y0
    Bsz, n_state = y0B.shape

    rhs_m, jac_m, jbl = n2_mode_functions(spec, accurate_rates)
    if use_batched:
        pB = _broadcast(p, axes, Bsz)
        rhs_b = homo.make_n2_rhs_b(spec, accurate_rates=accurate_rates)
        jac_b = homo.make_n2_colored_jacobian_b(spec)
        p3 = {k: (v.repeat_interleave(3, dim=0) if not isinstance(
            v, Mapping) else {kk: vv.repeat_interleave(3, dim=0)
                              for kk, vv in v.items()})
              for k, v in pB.items()}
        d3 = {k: v.repeat_interleave(3, dim=0) for k, v in dB.items()}

        def f_torch(t, y):
            return rhs_b(t, y, pB, dB)

        def stages_torch(ts_st, Y):
            return rhs_b(ts_st.reshape(-1), Y.reshape(-1, n_state), p3,
                         d3).reshape(Y.shape)

        jac_colored = lambda t, y: jac_b(t, y, pB, dB)
    else:
        fB = vmap(rhs_m, in_dims=(0, 0, axes, 0))
        p3 = _repeat(p, axes, 3)
        d3 = {k: v.repeat_interleave(3, dim=0) for k, v in dB.items()}

        def f_torch(t, y):
            return fB(t, y, p, dB)

        def stages_torch(ts_st, Y):
            # the three stages of every member as one batch of 3B rows
            # (row 3b + i is stage i of member b)
            return fB(ts_st.reshape(-1), Y.reshape(-1, n_state), p3,
                      d3).reshape(Y.shape)

        jcB = vmap(jac_m, in_dims=(0, 0, axes, 0))
        jac_colored = lambda t, y: jcB(t, y, p, dB)

    kw = dict(solver_kwargs)
    probes = None
    if mesh is not None and kw.get("out_members") is not None:
        probes = _Probes(mesh, _batch_size(sweep), kw["out_members"])
        kw["out_members"] = probes.local
    if use_fused:
        # residuals: the fused RHS over member rows (stage-stacked for
        # stages)
        rhs = cuda_rhs.build_n2_fused(
            spec, accurate_rates="df32" if df32_mode else False,
            ko_keys=e.ko_keys)
        f, kw["f_stages"] = _fused_calls(rhs, e)
    else:
        f, kw["f_stages"] = f_torch, stages_torch
    if cheap_sweeps:
        if full:
            kw["f_cheap"], kw["f_cheap_stages"] = f_torch, stages_torch
        elif fused_rhs is False:
            fcB = vmap(homo.make_n2_rhs(spec), in_dims=(0, 0, axes, 0))
            kw["f_cheap"] = lambda t, y: fcB(t, y, p, dB)
            kw["f_cheap_stages"] = lambda ts_st, Y: fcB(
                ts_st.reshape(-1), Y.reshape(-1, n_state), p3,
                d3).reshape(Y.shape)
        else:
            kw["f_cheap"], kw["f_cheap_stages"] = _fused_calls(
                cuda_rhs.build_n2_fused(spec, ko_keys=e.ko_keys), e)
        kw["cheap_sweeps"] = int(cheap_sweeps)

    # Jacobian: colored JVPs of the PyTorch RHS with the pressure march
    # frozen (the blocks alone for the exact solve), or the dense
    # Jacobian of the whole RHS by one JVP a state entry
    if exact_solve:
        jblB = vmap(jbl, in_dims=(0, 0, axes, 0))
        kw.setdefault("block", (spec.var_no_n2, spec.z_no))
        kw["jac_blocks"] = lambda t, y: jblB(t, y, p, dB)
    elif colored_jacobian:
        kw["jac"] = jac_colored
    else:
        kw["jac"] = lambda t, y: stiff_ensemble.batched_jacobian(f_torch, t,
                                                                 y)
    out = stiff_ensemble.odeint_ensemble(
        f, y0B, e.ts, rtol=rtol, atol=atol, batched=True, mesh=mesh, **kw)
    if mesh is None:
        return out
    if probes is None:
        ys, stats = out
        return gather_members(mesh, ys, dim=1), gather_tree(mesh, stats)
    ys_sel, y_fin, stats = out
    return (probes.gather(ys_sel), gather_members(mesh, y_fin),
            gather_tree(mesh, stats))


class _Probes:
    """out_members over a dp mesh: the caller's global member indices,
    this rank's share of them as local indices (``local``, in the
    caller's order), and the gather that puts every rank's recorded
    probes back in the caller's order. Every rank knows every rank's
    share (the blocks are contiguous), so the gather pads each share to
    the largest and picks the columns out."""

    def __init__(self, mesh, b_total, out_members):
        idx = np.asarray(out_members, np.int64)
        k = b_total // mesh.size
        owner = idx // k
        counts = np.bincount(owner, minlength=mesh.size)
        self.mesh, self.width = mesh, int(counts.max())
        self.local = idx[owner == mesh.rank] - mesh.rank * k
        # column of each probe in the gathered (n_out, size * width, n)
        rank_pos = np.zeros(len(idx), np.int64)
        for r in range(mesh.size):
            mine = np.nonzero(owner == r)[0]
            rank_pos[mine] = r * self.width + np.arange(len(mine))
        self.take = torch.as_tensor(rank_pos, device=mesh.device)

    def gather(self, ys_sel):
        pad = self.width - ys_sel.shape[1]
        if pad:
            ys_sel = torch.cat([ys_sel, ys_sel.new_zeros(
                (ys_sel.shape[0], pad, ys_sel.shape[2]))], dim=1)
        return gather_members(self.mesh, ys_sel, dim=1)[:, self.take]


def n2_mode_functions(spec, accurate_rates=False):
    """(rhs, jac, blocks) of a lockstep mode as PyTorch functions of one
    member, each f(t, y (n,), p, d): the RHS (homo.make_n2_rhs), its
    dense colored Jacobian and its bidiagonal blocks with the pressure
    march frozen (make_n2_colored_jacobian, make_n2_bidiag_blocks; plain
    in every mode, as in rmt_tpu). Under "full" all three evaluate in
    float64 on float64 parameters: the state is cast up on entry and the
    RHS and the dense Jacobian cast back to float32 (the integrator casts
    the blocks). rmt_tpu gets its float64 RHS by promotion from the
    float64 parameters, but under torch.func.vmap a member's parameter
    is a 0-dim tensor, which does not promote a float32 state."""
    rhs = homo.make_n2_rhs(spec, accurate_rates=(
        accurate_rates if accurate_rates != "full" else False))
    jac = homo.make_n2_colored_jacobian(spec)
    blocks = homo.make_n2_bidiag_blocks(spec)
    if accurate_rates != "full":
        return rhs, jac, blocks

    def up(fn, down):
        def f(t, y, p, d):
            out = fn(t, y.to(_f64), p, d)
            return out.to(_f32) if down else out
        return f

    return up(rhs, True), up(jac, True), up(blocks, False)


def _fused_calls(rhs_fn, e):
    """(f, f_stages) of a fused RHS function on the ensemble's leaves: f
    over the B member rows, f_stages one evaluation over the 3B
    stage-stacked rows, stage-major (member = row % B)."""
    Bsz, n_state = e.y0.shape

    def f(t, y):
        return rhs_fn(y, e.leaves1, e.leaves2)

    def f_stages(ts_st, Y):
        yf = Y.transpose(0, 1).reshape(3 * Bsz, n_state)
        out = rhs_fn(yf, e.leaves1, e.leaves2)
        return out.reshape(3, Bsz, n_state).transpose(0, 1)

    return f, f_stages


def _run_microbatches(model_input, sweep, b_total, k, kw):
    """run_n2_ensemble_lockstep over member slices of k, joined (port of
    the reference's microbatch scan, rmt_tpu/parallel/ensemble.py)."""
    if "out_members" in kw:
        raise ValueError(
            "out_members and microbatch are mutually exclusive (probe "
            "indices are global, microbatches are local)")
    if k <= 0 or b_total % k:
        raise ValueError(
            f"ensemble size {b_total} must be a multiple of microbatch {k}")

    def rows(v, lo):
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        return v[lo:lo + k]

    parts = [run_n2_ensemble_lockstep(
        model_input, {name: rows(v, lo) for name, v in sweep.items()}, **kw)
        for lo in range(0, b_total, k)]
    ys = torch.cat([p[0] for p in parts], dim=1)
    stats = stiff_ensemble.EnsembleStats(*[
        torch.cat(vals) if isinstance(vals[0], torch.Tensor) else sum(vals)
        for vals in zip(*(p[1] for p in parts))])
    return ys, stats


def run_m14_sweep(model_input: Mapping[str, Any], sweep: Mapping[str, Any],
                  mesh=None, device=None, timings=None):
    """Design-space sweep of the M14 steady heterogeneous reactor
    (rmt_tpu's run_m14_sweep: jax.vmap of models.hetero.make_m14_runner),
    in config.default_float() on ``device`` (default: the CUDA card;
    without one it raises, see config.resolve_device).

    Every member runs the single runner's solve: pseudo-transient
    continuation from the feed profile on the row-scaled residual
    (radau.odeint_batched to pseudo-time 20, rtol 1e-7, atol 1e-10), then
    a damped-Newton polish per rampList entry (newton.root_batched with
    like_root, max_iter 60, tol 1e-8), each member as it runs alone.
    Swept leaves may be operating conditions ("T0", "P0", "vf", ...) or
    kinetic-override constants. Honors solver-config mesh/zNo/rampList
    like rmtExe. timings: an optional dict to which the seconds of the
    continuation's parts (radau.odeint_batched's keys "jacobian", "lu",
    "newton", "other") and of the Newton polish ("polish") are added,
    each closed by a device synchronisation.

    Returns a dict: states (B, n_comp+1, 2, zNo) dimensionless
    [gas|solid] profiles, converged (B,) bool, res_norm (B,). With a
    mesh, this rank solves its block of members and every rank returns
    the whole batch's.
    """
    from ..models import hetero
    from ..ops import stencils
    from ..solvers import newton

    device = device_for(mesh, device)
    zmesh, z_no = stencils.solver_grid(model_input, 30)
    ramp_list = hetero.m14_ramps(model_input)
    spec = hetero.m14_build_spec(model_input, z_no=z_no)
    params, axes = batch_params(
        hetero.m14_params(model_input, device=device), sweep)
    if mesh is not None:
        params = shard_batch(mesh, params, axes)
    res_fn = hetero.make_m14_residual(spec, mesh=zmesh)

    def derive(q):
        d = hetero.m14_feed(spec, q)
        return d, hetero.m14_row_scales(spec, q, d), \
            hetero.m14_initial_state(spec, q, d)

    d, S, y0 = vmap(derive, in_dims=(axes,))(params)
    Bsz, n = y0.shape
    # the three Radau stages of every member as one batch of 3B rows (row
    # 3b + i is stage i of member b)
    p3 = _repeat(params, axes, 3)
    d3 = {k: v.repeat_interleave(3, dim=0) for k, v in d.items()}
    S3 = S.repeat_interleave(3, dim=0)
    res_b = vmap(res_fn, in_dims=(0, axes, 0, None))

    ramp0 = ramp_list[0]
    ys, _ = radau.odeint_batched(
        lambda t, y: res_b(y, params, d, ramp0) / S, y0,
        torch.tensor([0.0, 20.0], dtype=y0.dtype, device=device),
        rtol=1e-7, atol=1e-10,
        f_stages=lambda t_st, Y: (res_b(Y.reshape(-1, n), p3, d3, ramp0)
                                  / S3).reshape(Y.shape),
        timings=timings)
    t0 = time.perf_counter()
    x = ys[:, -1]
    converged = torch.ones(Bsz, dtype=torch.bool, device=device)
    res_norm = torch.zeros(Bsz, dtype=x.dtype, device=device)
    for ramp in ramp_list:
        sol = newton.root_batched(
            lambda yy, r=ramp: res_b(yy, params, d, r) / S, x, max_iter=60,
            n_backtrack=8, tol=1e-8, like_root=True)
        x = sol.x
        converged = converged & sol.converged
        res_norm = torch.maximum(res_norm, sol.residual_norm)
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings["polish"] = (timings.get("polish", 0.0)
                             + time.perf_counter() - t0)
    return _gathered(mesh, {
        "states": x.reshape(Bsz, spec.n_comp + 1, 2, spec.z_no),
        "converged": converged,
        "res_norm": res_norm,
    })


def _member_grid(spec, params, axes):
    """Every member's output times opT * linspace(0, 1, tNo + 1), (B, T)."""
    from ..models import hetero_dyn

    return hetero_dyn.per_member(lambda q: q["opT"] * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=q["opT"].dtype,
        device=q["opT"].device), params, axes)


def _coupled_dyn_sweep(model_input, sweep, model_id, rtol, atol, mesh, y0,
                       device, timings, solver_kwargs):
    """The M10, M11 and M12 sweeps: every member's coupled gas + particle
    transient (rmtExe's runner, at its grid) on radau.odeint_batched with
    the two-phase colored Jacobian of the batch (by reverse mode, one
    cotangent a row color serving every member; rmt_tpu's forward-mode
    column colors give the same matrix). y0: (n,) shared or (B, n) per
    member; default the model's seed (M10, M11) or the physical startup
    state (M12). With a mesh, this rank integrates its block of members
    (a (B, n) y0 cut the same way) and every rank returns the whole
    batch's result.
    Returns (ys (B, tNo+1, n), RadauStats of (B,) tensors)."""
    from ..models import hetero_dyn as hd
    from ..ops import jacobian as jac_ops
    from ..ops import stencils

    device = device_for(mesh, device)
    sc = model_input.get("solver-config", {})
    if model_id == "M11":
        zmesh, z_no = stencils.solver_grid(model_input, 10)
        r_no = int(sc.get("rNo", 7))
    else:
        if sc.get("mesh", "normal") != "normal":
            raise ValueError(
                f"the {model_id} sweep supports the normal mesh only; run "
                "refined-mesh cases through rmtExe")
        zmesh, z_no, r_no = None, int(sc.get(
            "zNo", 100 if model_id == "M10" else 10)), 7
    spec = hd.m13_build_spec(
        model_input, z_no=z_no, r_no=r_no,
        t_no=int(sc.get("tNo", 10 if model_id == "M10" else 5)))
    if model_id == "M10":
        base = hd.m10_params(model_input, device=device)
        rhs = hd.make_m10_rhs(spec, clamp_interface=True)
        seed = hd.m10_initial_state
    else:
        base = hd.m13_params(model_input, device=device)
        rhs = (hd.make_m11_rhs(spec, mesh=zmesh) if model_id == "M11"
               else hd.make_m12_rhs(spec, clamp_interface=True))
        seed = (hd.m11_initial_state if model_id == "M11"
                else hd.m12_physical_state)
    params, axes = batch_params(base, sweep)
    bsz = len(next(iter(sweep.values())))
    n = spec.n_layer * (spec.r_no + 1) * spec.z_no
    if y0 is None:
        y0B = hd.per_member(lambda q: seed(spec, q), params, axes)
    else:
        y0B = torch.as_tensor(np.asarray(y0, np.float64), dtype=base[
            "T0"].dtype, device=device)
        if y0B.dim() == 1:
            y0B = y0B.expand(bsz, -1)
        if tuple(y0B.shape) != (bsz, n):
            raise ValueError(f"y0 must have shape ({bsz}, {n}) or ({n},); "
                             f"got {tuple(y0B.shape)}")
    y0B = y0B.expand(bsz, n).contiguous()
    if mesh is not None:
        params = shard_batch(mesh, params, axes)
        y0B = shard_rows(mesh, y0B)
    if model_id == "M10":
        fB = hd.over_members(lambda t, y, pp: rhs(t, y, pp), params, axes)
        fS = hd.over_members(lambda t, y, pp: vmap(
            lambda tt, yy: rhs(tt, yy, pp))(t, y), params, axes)
        f, f_stages = fB, fS
    else:
        d = hd.per_member(lambda q: hd.m13_feed(spec, q), params, axes)
        fB = hd.over_members(lambda t, y, dd, pp: rhs(t, y, pp, dd), params,
                             axes)
        fS = hd.over_members(lambda t, y, dd, pp: vmap(
            lambda tt, yy: rhs(tt, yy, pp, dd))(t, y), params, axes)
        f = lambda t, y: fB(t, y, d)
        f_stages = lambda t, Y: fS(t, Y, d)
    coloring = jac_ops.two_phase_row_coloring(spec.n_layer, spec.r_no + 1,
                                              spec.z_no)

    def jac(t, y):
        return jac_ops.batched_row_colored_jacobian(lambda x: f(t, x),
                                                    coloring)(y)

    out = radau.odeint_batched(
        f, y0B, _member_grid(spec, params, axes).to(y0B.dtype), rtol=rtol,
        atol=atol, jac=jac, f_stages=f_stages, timings=timings,
        **solver_kwargs)
    return out if mesh is None else gather_tree(mesh, out)


def run_m11_sweep(model_input: Mapping[str, Any], sweep: Mapping[str, Any],
                  rtol: float = 1e-5, atol: float = 1e-6, mesh=None,
                  device=None, timings=None, **solver_kwargs):
    """Design sweep of the M11 dynamic heterogeneous reactor (rmt_tpu's
    run_m11_sweep: jax.vmap of rmtExe M11's Radau run): the coupled gas +
    FDM-particle transients of every member on radau.odeint_batched with
    the two-phase colored Jacobian, each member as it runs alone, in
    config.default_float() on ``device`` (default: the CUDA card).
    Honors solver-config mesh/zNo/rNo/tNo like rmtExe. timings: an
    optional dict for radau.odeint_batched's split of the wall.

    Returns (ys, stats): ys (B, tNo+1, noLayer*(rNo+1)*zNo) dimensionless
    states, stats per-member RadauStats."""
    return _coupled_dyn_sweep(model_input, sweep, "M11", rtol, atol, mesh,
                              None, device, timings, solver_kwargs)


def run_m10_sweep(model_input: Mapping[str, Any], sweep: Mapping[str, Any],
                  rtol: float = 1e-5, atol: float = 1e-6, mesh=None, y0=None,
                  device=None, timings=None, **solver_kwargs):
    """Design sweep of the M10 dynamic heterogeneous reactor (real units,
    OC particle, live velocity/pressure marches; rmt_tpu's run_m10_sweep),
    as run_m11_sweep. y0 overrides the initial state ((n,) shared or
    (B, n)); default the reference's seed. Returns (ys, stats), real
    units."""
    return _coupled_dyn_sweep(model_input, sweep, "M10", rtol, atol, mesh,
                              y0, device, timings, solver_kwargs)


def run_m12_sweep(model_input: Mapping[str, Any], sweep: Mapping[str, Any],
                  rtol: float = 1e-5, atol: float = 1e-6, mesh=None, y0=None,
                  device=None, timings=None, **solver_kwargs):
    """Design sweep of the M12 dynamic heterogeneous reactor (OC particle,
    static algebraic interface; rmt_tpu's run_m12_sweep), as
    run_m11_sweep. y0 overrides the initial state ((n,) shared or
    (B, n)); the default is the PHYSICAL startup state (feed everywhere,
    theta = 0), not the reference's singular 1e-6 seed. Returns (ys,
    stats), dimensionless."""
    return _coupled_dyn_sweep(model_input, sweep, "M12", rtol, atol, mesh,
                              y0, device, timings, solver_kwargs)


def run_m13_sweep(model_input: Mapping[str, Any], sweep: Mapping[str, Any],
                  rtol: float = 1e-5, atol: float = 1e-7, mesh=None,
                  engine: str = "vmap", device=None, timings=None,
                  **engine_kwargs):
    """Design sweep of the M13 operator-splitting heterogeneous reactor
    (rmt_tpu's run_m13_sweep) in config.default_float() on ``device``
    (default: the CUDA card); the period opT must be shared.

    engine="vmap": rmt_tpu's jax.vmap of the split driver, here
    models/hetero_dyn.make_m13_driver over the batch (each member as it
    runs alone; timings keys "gas", "ptc", "polish"). engine="lockstep":
    rmt_tpu's scan-based engine (_run_m13_sweep_lockstep; normal mesh
    only; options max_steps_gas, homotopy_stages, newton_iters_solid,
    tol_solid; timings keys "gas", "solid", "rescue").

    Returns a dict: gas (B, tNo, noLayer, zNo) dimensionless gas profiles
    per interval, solid (B, tNo, noLayer, rNo, zNo), converged (B,) bool
    (solid Newton at every interval), unreached (B,) int (gas budget
    misses), ts (tNo+1,); the lockstep engine adds rescued (the intervals
    whose homotopy rescue ran). With a mesh, this rank integrates its
    block of members and every rank returns the whole batch's result
    (the lockstep engine decides each interval's rescue for the whole
    batch, so rescued is the unsharded run's).
    """
    from ..models import hetero_dyn as hd
    from ..ops import stencils

    device = device_for(mesh, device)
    zmesh, z_no = stencils.solver_grid(model_input, 10)
    if "opT" in sweep:
        raise ValueError("the M13 sweep requires a shared period")
    if engine == "lockstep":
        if zmesh is not None:
            raise ValueError(
                "engine='lockstep' supports the normal mesh only (the "
                "refined dense-zone stencils couple z-2, which the "
                "block-tridiagonal stage solves cannot represent)")
        return _gathered(mesh, _run_m13_sweep_lockstep(
            model_input, sweep, z_no, rtol, atol, device, timings, mesh,
            **engine_kwargs))
    if engine != "vmap":
        raise ValueError(f"unknown engine {engine!r}")
    if engine_kwargs:
        raise TypeError(
            f"engine='vmap' takes no extra options: {sorted(engine_kwargs)}")
    sc = model_input.get("solver-config", {})
    spec = hd.m13_build_spec(model_input, z_no=z_no,
                             r_no=int(sc.get("rNo", 7)),
                             t_no=int(sc.get("tNo", 5)))
    params, axes = batch_params(hd.m13_params(model_input, device=device),
                                sweep)
    if mesh is not None:
        params = shard_batch(mesh, params, axes)
    gas_t, solid_t, conv_t, unr_t, ts_grid = hd.make_m13_driver(
        spec, mesh=zmesh, rtol=rtol, atol=atol)(params, axes,
                                                timings=timings)
    b = gas_t.shape[0]
    return _gathered(mesh, {
        "gas": gas_t.reshape(b, spec.t_no, spec.n_layer, spec.z_no),
        "solid": solid_t,
        "converged": conv_t.all(dim=1),
        "unreached": unr_t.sum(dim=1),
        "ts": ts_grid,
    })


def _run_m13_sweep_lockstep(model_input, sweep, z_no, rtol, atol, device,
                            timings, mesh=None, max_steps_gas: int = 768,
                            homotopy_stages: int = 8,
                            newton_iters_solid: int = 30,
                            tol_solid: float | None = None):
    """rmt_tpu's lockstep M13 engine, interval for interval the staggered
    exchange of make_m13_driver: the gas MoL phase of every member on
    stiff_ensemble.odeint_ensemble in tridiagonal block mode (its dense
    Jacobian colored over the batch, by reverse mode with the symmetric
    tridiagonal coloring, max_steps_gas attempts), then every
    node's particle BVP of every member as one root_batched over B*zNo
    rows (block=(noLayer, rNo, "tridiag"), newton_iters_solid iterations,
    tol_solid: rmt_tpu's off-TPU values, 1e-9 in float64, 3e-6 in
    float32), warm-started from the previous interval's solid state.
    Where any node fails, the bulk-homotopy rescue re-solves the failed
    nodes along the bulk path previous -> new in homotopy_stages
    warm-started solves, judged by the last stage alone; nodes that still
    fail keep the previous solid state and their member reports
    converged=False. Whether the rescue runs is one read by the host an
    interval; over a mesh that flag is OR-ed over the ranks (rmt_tpu's
    lax.cond decides it for the whole batch), and the gas phase's chunks
    are the whole batch's. The result is this rank's members'."""
    from ..models import hetero_dyn as hd
    from ..ops import jacobian as jac_ops
    from ..solvers import newton

    sc = model_input.get("solver-config", {})
    spec = hd.m13_build_spec(model_input, z_no=z_no,
                             r_no=int(sc.get("rNo", 7)),
                             t_no=int(sc.get("tNo", 5)))
    params, axes = batch_params(hd.m13_params(model_input, device=device),
                                sweep)
    if mesh is not None:
        params = shard_batch(mesh, params, axes)
    dtype = params["T0"].dtype
    if tol_solid is None:
        # the reachable residual floor of the LHHW residual: 1e-9 in
        # float64, about 1e-6 in float32 (rmt_tpu's off-TPU branch)
        tol_solid = 1e-9 if dtype == _f64 else 3e-6
    n_comp, n_layer, r_no = spec.n_comp, spec.n_layer, spec.r_no
    n_node = n_layer * r_no
    gas_rhs = hd.make_m13_gas_rhs(spec, flux_sign=-1.0)
    solid = hd.make_m13_solid_residual(spec)
    gas_coloring = jac_ops.tridiag_coloring(n_layer, z_no)
    solid_coloring = jac_ops.tridiag_coloring(n_layer, r_no)

    d = hd.per_member(lambda q: hd.m13_feed(spec, q), params, axes)
    y_gas = hd.per_member(lambda q: hd.m13_gas_initial_state(spec, q),
                          params, axes)
    y_solid = hd.per_member(lambda q: hd.m13_solid_initial_state(spec, q),
                            params, axes)
    Bsz, dev = y_gas.shape[0], y_gas.device
    gas_b = hd.over_members(lambda t, y, dd, cs, ts, pp: gas_rhs(
        t, y, pp, dd, cs, ts), params, axes)
    gas_st = hd.over_members(lambda t, y, dd, cs, ts, pp: vmap(
        lambda tt, yy: gas_rhs(tt, yy, pp, dd, cs, ts))(t, y), params, axes)
    solid_b = hd.over_members(lambda y, cb, tb, dd, pp: solid(
        y, cb, tb, pp, dd), params, axes)

    def lap(t0, key):
        if timings is None:
            return t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[key] = timings.get(key, 0.0) + now - t0
        return now

    def solid_residual(x, cb, tb):
        """x (B*zNo, n_node) node rows; cb (B, n_comp, zNo), tb (B, zNo):
        the gas bulk of the Robin interface, clamped with max(EPS) as the
        normal-mesh driver clamps it."""
        y = x.reshape(Bsz, z_no, n_layer, r_no).permute(0, 2, 3, 1)
        r = solid_b(y, torch.clamp(cb, min=hd.EPS_CONST), tb, d)
        return r.permute(0, 3, 1, 2).reshape(Bsz * z_no, n_node)

    def solve_solid(x0, cb, tb):
        res = lambda x: solid_residual(x, cb, tb)
        return newton.root_batched(
            res, x0, max_iter=newton_iters_solid,
            jac=jac_ops.batched_row_colored_jacobian(res, solid_coloring),
            tol=tol_solid, block=(n_layer, r_no, "tridiag"))

    cs_surf, ts_surf = y_solid[:, :n_comp, 0], y_solid[:, n_comp, 0]
    g0 = y_gas.reshape(Bsz, n_layer, z_no)
    c_bulk, t_bulk = g0[:, :n_comp], g0[:, n_comp]
    # interval 0 has no previous solve: its homotopy degenerates to the
    # direct Newton
    c_prev, t_prev = c_bulk, t_bulk
    ts_grid = (params["opT"] * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=dtype, device=dev)).to(dtype)
    ws = np.linspace(1.0 / homotopy_stages, 1.0, homotopy_stages)
    out, rescued = [], 0
    for k in range(spec.t_no):
        clock = time.perf_counter()

        def fB(t, y):
            return gas_b(t, y, d, cs_surf, ts_surf)

        def jac_gas(t, y):
            return jac_ops.batched_row_colored_jacobian(
                lambda yy: fB(t, yy), gas_coloring)(y)

        ys, stats = stiff_ensemble.odeint_ensemble(
            fB, y_gas, ts_grid[k:k + 2], rtol=rtol, atol=atol, jac=jac_gas,
            block=(n_layer, z_no, "tridiag"), max_steps=max_steps_gas,
            f_stages=lambda t_st, Y: gas_st(t_st, Y, d, cs_surf, ts_surf),
            batched=True, mesh=mesh)
        y_gas = ys[-1]
        unreached = (stats.seg < 1).to(torch.int32)
        clock = lap(clock, "gas")

        # the solid against the PREVIOUS interval's bulk (staggered),
        # warm-started from the previous interval's solid state
        x0 = y_solid.permute(0, 3, 1, 2).reshape(Bsz * z_no, n_node)
        sol = solve_solid(x0, c_bulk, t_bulk)
        x_sol, conv_n = sol.x, sol.converged
        need = ~conv_n
        clock = lap(clock, "solid")
        if (bool(need.any()) if mesh is None
                else any_across(mesh, need.any()[None])[0]):
            rescued += 1
            xk, conv_h = x0, conv_n
            for w in ws:
                sk = solve_solid(xk, (1.0 - w) * c_prev + w * c_bulk,
                                 (1.0 - w) * t_prev + w * t_bulk)
                xk = torch.where(sk.converged[:, None], sk.x, xk)
                conv_h = sk.converged
            x_sol = torch.where(need[:, None], xk, x_sol)
            conv_n = torch.where(need, conv_h, conv_n)
            lap(clock, "rescue")
        # nodes that still failed keep the previous solid state
        x_sol = torch.where(conv_n[:, None], x_sol, x0)
        y_solid = x_sol.reshape(Bsz, z_no, n_layer, r_no).permute(0, 2, 3, 1)
        conv = conv_n.reshape(Bsz, z_no).all(dim=1)
        cs_surf, ts_surf = y_solid[:, :n_comp, 0], y_solid[:, n_comp, 0]
        c_prev, t_prev = c_bulk, t_bulk
        Yg = y_gas.reshape(Bsz, n_layer, z_no)
        c_bulk, t_bulk = Yg[:, :n_comp], Yg[:, n_comp]
        out.append((y_gas, y_solid, conv, unreached))
    gas_t, solid_t, conv_t, unr_t = (torch.stack(v, dim=1) for v in zip(*out))
    return {
        "gas": gas_t.reshape(Bsz, spec.t_no, n_layer, z_no),
        "solid": solid_t,
        "converged": conv_t.all(dim=1),
        "unreached": unr_t.sum(dim=1),
        "ts": ts_grid,
        "rescued": rescued,
    }
