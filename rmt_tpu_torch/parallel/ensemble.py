# Ensemble execution of the N2 dynamic model on the lockstep integrator
# (port of run_n2_ensemble_lockstep and batch_params from
# rmt_tpu/parallel/ensemble.py).
#
# A batch of reactors -- any leaf of the parameter dict may be swept:
# inlet T/P/composition, geometry, heat exchange, and the kinetic
# constants through kinetic overrides -- integrates as one ensemble on one
# device. Stage residuals go through the fused N2 RHS (ops/cuda_rhs.py:
# the generated CUDA kernel for tensors on the card, its plain twin on
# the CPU). The stage systems are solved either by Newton-Schulz
# preconditioners kept warm by the fused kernel of ops/cuda_ns.py, from
# the dense colored Jacobian, or (exact_solve=True) exactly by the block
# kernels of ops/cuda_block.py, from Jacobian blocks gathered by colored
# JVPs. microbatch=K bounds the live state: a host loop integrates the
# sweep K members at a time and joins the slices.
#
# Left for later ports: accurate_rates=True/"full", batched_rhs and mesh
# sharding.

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from .. import config
from ..models import homo
from ..ops import cuda_rhs
from ..solvers import stiff_ensemble

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


class N2Ensemble(NamedTuple):
    spec: homo.HomoSpec
    params: dict          # float32 parameters, swept leaves batched
    axes: dict            # vmap in_dims of params
    d: dict               # (B, ...) float32 feed state
    y0: torch.Tensor      # (B, n) float32 initial states
    ts: torch.Tensor      # (tNo+1,) float32 output grid
    leaves1: torch.Tensor  # the fused RHS's packed leaves
    leaves2: torch.Tensor
    ko_keys: tuple


def prepare_n2_ensemble(model_input: Mapping[str, Any],
                        sweep: Mapping[str, Any], device=None) -> N2Ensemble:
    """The float32 inputs of an N2 lockstep ensemble on ``device``
    (default: the CUDA card; without one, a call that names no device
    raises instead of running on the CPU, see config.resolve_device).

    Parameters and feed state follow the reference's hybrid cast for a
    df32 run (rmt_tpu/parallel/ensemble.py, hybrid_cast): parameters are
    rounded to float32 and the feed state is derived from them (here in
    float64, then rounded), so the integrated problem is the one the JAX
    package integrates.
    """
    if "opT" in sweep:
        raise ValueError("the lockstep integrator requires a shared period")
    if not sweep:
        raise ValueError("the sweep must name at least one batched leaf")
    device = config.resolve_device(device)
    spec = homo.build_spec(model_input)
    base = homo.build_params(model_input, dtype=_f64, device=device)
    params, axes = batch_params(base, sweep)
    p32 = _cast(params, _f32)

    def derive(q):
        d = homo.feed_state(spec, q)
        return d, homo.n2_initial_state(spec, q, d)

    dB, y0B = vmap(derive, in_dims=(axes,))(_cast(p32, _f64))
    dB, y0B = _cast(dB, _f32), y0B.to(_f32)
    ts = (p32["opT"].to(_f64) * torch.linspace(
        0.0, 1.0, spec.t_no + 1, dtype=_f64, device=device)).to(_f32)
    ko_keys = tuple(sorted(p32["kinetic_overrides"]))
    leaves1, leaves2 = cuda_rhs.pack_leaves(
        _broadcast(p32, axes, y0B.shape[0]), dB, ko_keys)
    return N2Ensemble(spec, p32, axes, dB, y0B, ts, leaves1, leaves2, ko_keys)


def run_n2_ensemble_lockstep(
    model_input: Mapping[str, Any],
    sweep: Mapping[str, Any],
    rtol: float = 1e-7,
    atol: float = 1e-10,
    exact_solve: bool = False,
    accurate_rates: bool | str = False,
    cheap_sweeps: int = 0,
    microbatch: int | None = None,
    device=None,
    **solver_kwargs,
):
    """N2 dynamic ensemble on the lockstep Radau integrator, in float32.

    exact_solve=False (the default) solves the Radau stage systems with
    float32 Newton-Schulz preconditioners built from the dense colored
    Jacobian (ns_refresh / ns_step pass through to the integrator);
    exact_solve=True solves them exactly through the block-bidiagonal
    structure of the MoL Jacobian.

    accurate_rates="df32" evaluates the kinetics chain, nu@R and the
    heat-of-reaction sum in compensated double-float32 pairs
    (ops/df32.py); False evaluates the whole RHS in plain float32.

    cheap_sweeps=k (df32 only): the first k Newton sweeps of every
    attempt use the plain float32 RHS, the rest the df32 one.

    The inputs are made by prepare_n2_ensemble (the hybrid cast) on
    ``device``: the CUDA card unless the caller names another (pass
    device="cpu" for the CPU; with no card and no device= it raises).

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
    if accurate_rates not in (False, "df32"):
        raise NotImplementedError(
            "the port supports accurate_rates False or 'df32'")
    if cheap_sweeps and not accurate_rates:
        raise ValueError(
            "cheap_sweeps only makes sense with an accurate_rates mode "
            "(the plain RHS IS the cheap one otherwise)")
    if microbatch is not None:
        b_total = len(next(iter(sweep.values()))) if sweep else 0
        if b_total > microbatch:
            return _run_microbatches(
                model_input, sweep, b_total, int(microbatch),
                dict(rtol=rtol, atol=atol, exact_solve=exact_solve,
                     accurate_rates=accurate_rates,
                     cheap_sweeps=cheap_sweeps, device=device,
                     **solver_kwargs))
    df32_mode = accurate_rates == "df32"
    e = prepare_n2_ensemble(model_input, sweep, device)
    spec, p32, axes, dB, y0B = e.spec, e.params, e.axes, e.d, e.y0
    leaves1, leaves2, ko_keys = e.leaves1, e.leaves2, e.ko_keys
    Bsz, n_state = y0B.shape

    # Jacobian: colored JVPs of the plain float32 RHS with the pressure
    # march frozen, mapped over members; the blocks alone for the exact
    # solve, the dense matrix for the Newton-Schulz preconditioners
    make_jac = (homo.make_n2_bidiag_blocks if exact_solve
                else homo.make_n2_colored_jacobian)
    jacB = vmap(make_jac(spec), in_dims=(0, 0, axes, 0))

    def jac(t, y):
        return jacB(t, y, p32, dB)

    # residuals: the fused RHS over member rows (stage-stacked for stages)
    rhs = cuda_rhs.build_n2_fused(
        spec, accurate_rates="df32" if df32_mode else False, ko_keys=ko_keys)

    def batched(rhs_fn):
        return lambda t, y: rhs_fn(y, leaves1, leaves2)

    def stages(rhs_fn):
        # one evaluation over the 3B stage-stacked batch, stage-major
        # (member = row % B)
        def f_stages(ts_st, Y):
            yf = Y.transpose(0, 1).reshape(3 * Bsz, n_state)
            out = rhs_fn(yf, leaves1, leaves2)
            return out.reshape(3, Bsz, n_state).transpose(0, 1)

        return f_stages

    kw = dict(solver_kwargs)
    kw["f_stages"] = stages(rhs)
    if df32_mode and cheap_sweeps:
        rhs_cheap = cuda_rhs.build_n2_fused(spec, ko_keys=ko_keys)
        kw["f_cheap"] = batched(rhs_cheap)
        kw["f_cheap_stages"] = stages(rhs_cheap)
        kw["cheap_sweeps"] = int(cheap_sweeps)
    if exact_solve:
        kw.setdefault("block", (spec.var_no_n2, spec.z_no))
        kw["jac_blocks"] = jac
    else:
        kw["jac"] = jac
    return stiff_ensemble.odeint_ensemble(
        batched(rhs), y0B, e.ts, rtol=rtol, atol=atol, **kw)


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
