# Adjoint-gradient parameter estimation of kinetic constants (port of
# rmt_tpu/parallel/estimation.py).
#
# BASELINE.json config #5: estimate kinetic/adsorption constants (K1-K3,
# KH2/KCO2/KCO) against measured axial profiles. The reference has no such
# capability (its kinetics are opaque python lambdas); here the kinetics
# DSL takes any DSL variable as an override tensor (kinetics/dsl.py), and
# the fixed-step integrators are reverse-mode differentiable, so a whole
# ensemble loss gets exact adjoint gradients in one backward pass.
#
# The reference maps one member's simulation over the ensemble with
# jax.vmap. Here the members of a sweep (parallel.batch_params) integrate
# as one batch: the Radau path through solvers/implicit_diff.py's
# radau_fixed_batched, the RK4 path through a member-batched RK4, each
# member with its own parameters and period; the constants being
# estimated are shared by every member. Over a dp mesh (parallel/mesh.py)
# each rank integrates its block of the members, and the loss, a mean
# over the whole batch, and its gradient are summed over the ranks
# before the update, as XLA's psum does for rmt_tpu's sharded batch.

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch.func import vmap

from .. import config
from ..models import homo
from . import mesh as dp
from ..solvers import fixed
from ..solvers.implicit_diff import radau_fixed, radau_fixed_batched
from ..solvers.radau import _Clock


def _with_theta(params, theta: Mapping[str, Any], axes=None):
    """params (and axes, if given) with the kinetic overrides theta
    merged in; theta's constants are shared by every member."""
    p = dict(params)
    p["kinetic_overrides"] = {**params.get("kinetic_overrides", {}), **theta}
    if axes is None:
        return p
    ax = dict(axes)
    ax["kinetic_overrides"] = {**axes["kinetic_overrides"],
                               **{k: None for k in theta}}
    return p, ax


def _one_member(spec, params, theta):
    p = _with_theta(params, theta)
    d = homo.feed_state(spec, p)
    return p, d, homo.n2_initial_state(spec, p, d)


def _members(spec, params, axes, theta):
    """(p, in_dims of p, d (B, ...), y0 (B, n), period (B,)) of a sweep
    with theta merged in."""
    p, ax = _with_theta(params, theta, axes)

    def derive(q):
        d = homo.feed_state(spec, q)
        return d, homo.n2_initial_state(spec, q, d)

    d, y0 = vmap(derive, in_dims=(ax,))(p)
    return p, ax, d, y0, p["opT"].expand(y0.shape[0])


def _rk4_batched(f, t1, n_steps: int, y0):
    """fixed.rk4's arithmetic over [0, t1] for members whose t1 (B,)
    differ: y(t1) (B, n) of the batched f(t (B,), y (B, n))."""
    h = torch.abs(t1) / n_steps
    hc = h[:, None]
    y = y0
    for k in range(n_steps):
        t = k * h
        k1 = f(t, y)
        k2 = f(t + h / 2, y + k1 * (hc / 2))
        k3 = f(t + h / 2, y + k2 * (hc / 2))
        k4 = f(t + h, y + k3 * hc)
        y = y + hc * (k1 + 2 * k2 + 2 * k3 + k4) / 6
    return y


def simulate_n2_fixed(spec: homo.HomoSpec, params, theta: Mapping[str, Any],
                      n_steps: int = 200, axes=None):
    """Differentiable N2 trajectory with kinetic overrides theta.

    Fixed-step RK4 (reverse-mode safe). Returns the final dimensionless
    state (varNo*zNo,); with axes (the in_dims of a batch_params sweep)
    the final states of every member, (B, varNo*zNo).
    """
    rhs = homo.make_n2_rhs(spec)
    if axes is None:
        p, d, y0 = _one_member(spec, params, theta)
        ys = fixed.rk4(lambda t, y: rhs(t, y, p, d), 0.0, p["opT"], n_steps,
                       y0)
        return ys[-1]
    p, ax, d, y0, period = _members(spec, params, axes, theta)
    fB = vmap(rhs, in_dims=(0, 0, ax, 0))
    return _rk4_batched(lambda t, y: fB(t, y, p, d), period, n_steps, y0)


def simulate_n2_implicit(spec: homo.HomoSpec, params,
                         theta: Mapping[str, Any], n_steps: int = 64,
                         rhs=None, axes=None, timings=None):
    """Differentiable N2 trajectory over the FULL operating period with
    kinetic overrides theta, on the L-stable fixed-step Radau with IFT
    stage solves (solvers/implicit_diff.py). Unlike simulate_n2_fixed,
    this handles the real stiffness: the 0.5 s DME period integrates at
    n_steps ~ 64 where explicit RK4 requires h ~ 1e-6 s for stability.
    Returns the final dimensionless state (varNo*zNo,); with axes (the
    in_dims of a batch_params sweep) every member's, (B, varNo*zNo), in
    one member-batched integration (timings: radau_fixed_batched's).

    rhs: optionally a prebuilt make_n2_rhs(spec) closure. The parameters
    and the feed state reach the stage solves as explicit arguments,
    never through the closure, so their gradients flow."""
    if rhs is None:
        rhs = homo.make_n2_rhs(spec)
    if axes is None:
        p, d, y0 = _one_member(spec, params, theta)
        return radau_fixed(lambda t, y, a: rhs(t, y, a[0], a[1]), y0,
                           (0.0, p["opT"]), n_steps, args=(p, d))
    p, ax, d, y0, period = _members(spec, params, axes, theta)
    # member b's k rows: the inner map over rows, the outer over members
    fB = vmap(vmap(rhs, in_dims=(0, 0, None, None)), in_dims=(0, 0, ax, 0))
    return radau_fixed_batched(lambda t, Y, a: fB(t, Y, a[0], a[1]), y0,
                               (0.0, period), n_steps, args=(p, d),
                               timings=timings)


def outlet_mole_fractions(spec: homo.HomoSpec, y_final):
    """Outlet (z = L) mole fractions from the final dimensionless state
    (..., varNo*zNo) -> (..., n_comp)."""
    Y = y_final.reshape(*y_final.shape[:-1], spec.var_no_n2, spec.z_no)
    conc = Y[..., : spec.n_comp, -1]
    return conc / torch.sum(conc, dim=-1, keepdim=True)


class EstimationStep:
    """One SGD step over log-kinetic-constants (make_estimation_step)."""

    def __init__(self, spec, axes, target, param_names, n_steps, lr,
                 integrator, device, mesh=None):
        if integrator not in ("rk4", "radau"):
            raise ValueError(f"unknown integrator {integrator!r}; "
                             "supported: 'rk4', 'radau'")
        self.spec, self.axes, self.n_steps, self.lr = spec, axes, n_steps, lr
        self.param_names = tuple(param_names)
        self.integrator = integrator
        self.mesh = mesh
        self.device = dp.device_for(mesh, device)
        target = torch.as_tensor(np.asarray(target, dtype=np.float64),
                                 dtype=config.default_float())
        # the loss is a mean over the whole batch, on every rank
        self.b_total = target.shape[0]
        self.target = (target.to(self.device) if mesh is None
                       else dp.shard_rows(mesh, target))
        # build the RHS closure once, for every step
        self.rhs = homo.make_n2_rhs(spec)

    def value_and_grad(self, theta_log, params, timings=None):
        """(loss, grads {name: 0-d}, outlet mole fractions (B, n_comp)) at
        theta_log {name: 0-d log-constant} over the sweep params. timings:
        an optional dict that gets the forward's split (Radau) and the
        seconds of the backward pass ("backward"). With a mesh, params
        is this rank's share of the sweep (shard_batch); the loss and the
        gradients are the whole batch's and the outlet mole fractions
        every member's, on every rank."""
        dtype = self.target.dtype
        th = {k: torch.as_tensor(v, dtype=dtype, device=self.device)
              .detach().requires_grad_(k in self.param_names)
              for k, v in theta_log.items()}
        theta = {k: torch.exp(th[k]) for k in self.param_names}
        if self.integrator == "radau":
            yf = simulate_n2_implicit(self.spec, params, theta, self.n_steps,
                                      rhs=self.rhs, axes=self.axes,
                                      timings=timings)
        else:
            yf = simulate_n2_fixed(self.spec, params, theta, self.n_steps,
                                   axes=self.axes)
        mf = outlet_mole_fractions(self.spec, yf)
        err = torch.sum((mf - self.target) ** 2, dim=-1)
        # this rank's share of the whole batch's mean
        loss = (torch.mean(err) if self.mesh is None
                else torch.sum(err) / self.b_total)
        clock = _Clock(timings, self.device)
        wrt = [th[k] for k in self.param_names]
        g = torch.autograd.grad(loss, wrt)
        clock.lap("backward")
        loss, mf = loss.detach(), mf.detach()
        if self.mesh is not None:
            # the loss and its gradient summed over the ranks in one
            # exchange
            total = dp.sum_across(self.mesh, torch.stack([loss, *g]))
            loss, g = total[0], tuple(total[1:])
            mf = dp.gather_members(self.mesh, mf)
        grads = {k: torch.zeros_like(v) for k, v in th.items()}
        grads.update(zip(self.param_names, g))
        return loss, grads, mf

    def update(self, theta_log, grads):
        """theta_new: theta_log one step of lr down grads (value_and_grad's
        gradients)."""
        return {k: torch.as_tensor(theta_log[k], dtype=grads[k].dtype,
                                   device=self.device)
                - self.lr * grads[k] for k in theta_log}

    def __call__(self, theta_log, params):
        """(theta_new, loss): one step of lr down the gradient."""
        loss, grads, _ = self.value_and_grad(theta_log, params)
        return self.update(theta_log, grads), loss


def make_estimation_step(
    spec: homo.HomoSpec,
    axes,
    target,                     # (B, n_comp) target outlet mole fractions
    param_names: Sequence[str] = ("K1", "K2", "K3"),
    n_steps: int = 200,
    lr: float = 1e-2,
    integrator: str = "rk4",    # "rk4" (short horizons) | "radau" (stiff)
    device=None,
    mesh=None,
):
    """Build an SGD step over log-kinetic-constants.

    theta holds log-space parameters (kinetic constants are positive and
    span decades); the loss is the ensemble MSE of outlet mole fractions.
    integrator="radau" routes through the IFT-differentiable implicit
    solver and handles the full stiff operating period. The sweep's
    parameters (params, in_dims ``axes``, from parallel.batch_params) live
    on ``device`` (default: the CUDA card; without one it raises, see
    config.resolve_device), in config.default_float().
    Returns step(theta, params_batch) -> (theta_new, loss); the step's
    value_and_grad(theta, params) also gives the gradients and the
    outlet mole fractions.

    mesh (parallel.mesh.Mesh): the step takes this rank's share of the
    sweep (shard_batch(mesh, params, axes)) and cuts the whole target
    (B, n_comp) to the rank's rows itself; each rank's loss is its
    members' sum over the whole batch's B, and the loss and gradients
    are summed over the ranks before the update, so every rank returns
    the same (theta_new, loss). rmt_tpu's function has no mesh keyword:
    there the sharding rides on the arrays, and XLA inserts the sums.
    """
    return EstimationStep(spec, axes, target, param_names, n_steps, lr,
                          integrator, device, mesh)
