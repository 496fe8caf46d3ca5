# The port's adjoint-gradient estimation (rmt_tpu_torch.parallel.
# estimation: make_estimation_step on the member-batched Radau with IFT
# adjoints, or the member-batched RK4) against rmt_tpu's jitted step, in
# float64 on the CPU at B = 3 members, and against estimation_ref.npz (the
# oracle scripts/gen_estimation_ref.py computes with rmt_tpu at B = 8,
# scripts/bench_torch_estimation.py's configuration). Both packages get
# the same parameters (convert.params_from_jax), sweep, targets and
# log-constants.

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dme_case import make_model_input
from rmt_tpu.models import homo as j_homo
from rmt_tpu.parallel import batch_params as j_batch_params
from rmt_tpu.parallel import estimation as j_est
from rmt_tpu_torch import convert
from rmt_tpu_torch.models import homo as t_homo
from rmt_tpu_torch.parallel import batch_params as t_batch_params
from rmt_tpu_torch.parallel import estimation as t_est

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RT = 8.314472 * 523.0
THETA_TRUE = {
    "K1": math.log(35.45 * math.exp(-1.7069e4 / RT)),
    "K2": math.log(7.3976 * math.exp(-2.0436e4 / RT)),
    "K3": math.log(8.2894e4 * math.exp(-5.2940e4 / RT)),
}
f64 = torch.float64


def _theta_t(theta):
    return {k: torch.tensor(v, dtype=f64) for k, v in theta.items()}


def _pair(period, z_no, sweep):
    """Both packages' (spec, batched params, axes) of the DME N2 case."""
    mi = make_model_input(model="N2", op_period=period)
    jspec = j_homo.build_spec(mi, z_no=z_no, t_no=1)
    jp = j_homo.build_params(mi)
    jb, jaxes = j_batch_params(jp, {k: jnp.asarray(v)
                                    for k, v in sweep.items()})
    tb, taxes = t_batch_params(convert.params_from_jax(jp, device="cpu"),
                               sweep)
    return (jspec, jb, jaxes), (t_homo.build_spec(mi, z_no=z_no, t_no=1),
                                tb, taxes)


@pytest.mark.parametrize("integrator, period, n_steps", [
    ("radau", 0.5, 12), ("rk4", 2e-5, 8)])
def test_estimation_step_matches_jax(integrator, period, n_steps):
    """One step of each integrator at B = 3 (seeded targets, constants
    0.1 off the 523 K values): loss and theta_new against rmt_tpu's step
    within 1e-8 relative, and theta moved."""
    sweep = {"T0": 523.0 + np.linspace(-2.0, 2.0, 3)}
    (jspec, jb, jaxes), (tspec, tb, taxes) = _pair(period, 5, sweep)
    target = np.random.default_rng(0).dirichlet(np.ones(jspec.n_comp), 3)
    theta0 = {k: v + 0.1 for k, v in THETA_TRUE.items()}
    jstep = j_est.make_estimation_step(jspec, jaxes, jnp.asarray(target),
                                       n_steps=n_steps, lr=1e-2,
                                       integrator=integrator)
    j_new, j_loss = jstep({k: jnp.asarray(v) for k, v in theta0.items()},
                          jb)
    tstep = t_est.make_estimation_step(tspec, taxes, target, n_steps=n_steps,
                                       lr=1e-2, integrator=integrator,
                                       device="cpu")
    t_new, t_loss = tstep(_theta_t(theta0), tb)
    assert t_loss.dtype == f64 and t_loss.shape == ()
    assert abs(float(t_loss) - float(j_loss)) <= 1e-8 * float(j_loss)
    for k in THETA_TRUE:
        want = float(j_new[k])
        assert abs(float(t_new[k]) - want) <= 1e-8 * abs(want), k
        assert float(t_new[k]) != theta0[k]


def test_estimation_descends_at_real_period():
    """tests/test_implicit_diff.py's descent and recovery at zNo 5 and 16
    steps (at 12 the start's stiffer kinetics give NaN in two of the
    three members): targets from the true constants, a start 0.15 off;
    over 4 steps of lr 0.5 the loss falls and the constants move toward
    the truth."""
    sweep = {"T0": 523.0 + np.linspace(-2.0, 2.0, 3)}
    _, (spec, params, axes) = _pair(0.5, 5, sweep)
    truth = {k: torch.exp(v) for k, v in _theta_t(THETA_TRUE).items()}
    with torch.no_grad():
        target = t_est.outlet_mole_fractions(spec, t_est.simulate_n2_implicit(
            spec, params, truth, 16, axes=axes))
    step = t_est.make_estimation_step(spec, axes, target, n_steps=16,
                                      lr=0.5, integrator="radau",
                                      device="cpu")
    theta = _theta_t({k: v + 0.15 for k, v in THETA_TRUE.items()})
    dist0 = sum(abs(float(theta[k]) - THETA_TRUE[k]) for k in theta)
    losses = []
    for _ in range(4):
        theta, loss = step(theta, params)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(bool(torch.isfinite(v)) for v in theta.values())
    dist = sum(abs(float(theta[k]) - THETA_TRUE[k]) for k in theta)
    assert dist < dist0


def test_estimation_matches_the_committed_oracle():
    """scripts/bench_torch_estimation.py's configuration at B = 8 against
    estimation_ref.npz (rmt_tpu on the CPU, float64): the loss, the three
    gradients, theta_new and every member's outlet mole fractions within
    1e-8 relative; the file holds the configuration the bench runs."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bench_torch_estimation as bench

    with np.load(os.path.join(ROOT, "estimation_ref.npz")) as z:
        ref = {k: z[k] for k in z.files}
    assert list(ref["names"]) == list(bench.THETA0)
    np.testing.assert_array_equal(ref["theta0"], list(bench.THETA0.values()))
    np.testing.assert_array_equal(ref["t0"], bench.inlet_temperatures(8))
    assert (float(ref["period"]), int(ref["z_no"]), int(ref["n_steps"]),
            float(ref["lr"])) == (bench.PERIOD, bench.Z_NO, bench.N_STEPS,
                                  bench.LR)
    step, theta0, params, spec = bench.build(8, "cpu")
    np.testing.assert_array_equal(step.target.numpy(), ref["target"])
    loss, grads, mf = step.value_and_grad(theta0, params)
    rel = lambda got, want: np.max(np.abs(got - want) / np.abs(want))
    assert rel(float(loss), ref["loss"]) <= 1e-8
    assert rel(np.array([float(grads[k]) for k in bench.THETA0]),
               ref["grads"]) <= 1e-8
    assert mf.shape == ref["outlet"].shape == (8, spec.n_comp)
    assert rel(mf.numpy(), ref["outlet"]) <= 1e-8
    theta_new, _ = step(theta0, params)
    assert rel(np.array([float(theta_new[k]) for k in bench.THETA0]),
               ref["theta_new"]) <= 1e-8


def test_estimation_wants_the_card_by_default():
    """Without device= the step lives on the CUDA card: on a host without
    one it raises instead of running on the CPU; an unknown integrator
    raises."""
    _, (spec, _, axes) = _pair(0.5, 5, {"T0": np.array([523.0])})
    target = np.full((1, spec.n_comp), 1.0 / spec.n_comp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_est.make_estimation_step(spec, axes, target)
    with pytest.raises(ValueError, match="integrator"):
        t_est.make_estimation_step(spec, axes, target, integrator="euler",
                                   device="cpu")
