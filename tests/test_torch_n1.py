# The N1 steady-state slice of the port (rmt_tpu_torch.models.homo's
# n1_initial_state and make_n1_rhs, props.thermo.density_ig_eos) against
# rmt_tpu's, the integrator's default dense Jacobian, and the lockstep N1
# ensemble with dense output that scripts/bench_torch_n1.py runs on the
# card: against rmt_tpu's odeint_ensemble in float64, and in float32
# against scipy's Radau at rtol 1e-10. The integration tests cover the
# first tenth of the reactor length (z in [0, 0.1], its stiff entrance):
# the whole length takes about 700 float32 attempts, which on the CPU,
# where the kernels run as their plain twins, costs minutes; the card runs
# the whole length (scripts/bench_torch_n1.py, chip_smoke.py).

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from scipy.integrate import solve_ivp

from dme_case import make_model_input
from rmt_tpu.models import homo as jhomo
from rmt_tpu.parallel import batch_params as j_batch_params
from rmt_tpu.props import thermo as jthermo
from rmt_tpu.solvers import stiff_ensemble as j_se
from rmt_tpu_torch.cases.dme_case import make_model_input as t_input
from rmt_tpu_torch.models import homo as thomo
from rmt_tpu_torch.props import thermo as tthermo
from rmt_tpu_torch.solvers import stiff_ensemble as t_se

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import bench_torch_n1  # noqa: E402

PROCESSES = ("non-iso-thermal", "iso-thermal")
# the N1 keys of the feed state (rmt_tpu/models/homo.py::make_n1_rhs)
N1_KEYS = ("Cmax", "InGaVe0", "SpCo0", "SuGaVe0", "GaDe0", "GaMiVi", "zf",
           "GaCpMeanMix0", "aEff", "GaMaCoTe0", "GaHeCoTe0", "mw")
TS = np.linspace(0.0, 0.1, 11)
SOLVER = dict(rtol=bench_torch_n1.RTOL, atol=bench_torch_n1.ATOL,
              dense_output=True, **bench_torch_n1.OPTS)


def _single(process):
    """Both packages' spec, float64 parameters and feed state, and 4
    initial states perturbed by up to 5% (numpy seed 0)."""
    mi = make_model_input(model="N1", process_type=process)
    jspec = jhomo.build_spec(mi)
    p = jhomo.build_params(mi)
    d = jhomo.feed_state(jspec, p)
    tmi = t_input(model="N1", process_type=process)
    tspec = thomo.build_spec(tmi)
    tp = thomo.build_params(tmi, dtype=torch.float64, device="cpu")
    td = thomo.feed_state(tspec, tp)
    y0 = np.asarray(jhomo.n1_initial_state(jspec, p, d))
    rng = np.random.default_rng(0)
    ys = y0 * (1 + 0.05 * rng.uniform(size=(4, y0.shape[0])))
    return jspec, p, d, tspec, tp, td, ys


def _jax_batch(offsets):
    """rmt_tpu's batched N1 problem of a T0 sweep (scripts/bench_n1.py's
    build, float64): (fB, y0 (B, n))."""
    mi = make_model_input(model="N1")
    spec = jhomo.build_spec(mi)
    params, axes = j_batch_params(jhomo.build_params(mi),
                                  {"T0": jnp.asarray(523.0 + offsets)})

    def derive(q):
        d = jhomo.feed_state(spec, q)
        return d, jhomo.n1_initial_state(spec, q, d)

    dB, y0 = jax.vmap(derive, in_axes=(axes,))(params)
    fB = jax.vmap(jhomo.make_n1_rhs(spec), in_axes=(0, 0, axes, 0))
    return jax.jit(lambda t, y: fB(t, y, params, dB)), y0


@pytest.mark.parametrize("process", PROCESSES)
def test_n1_feed_and_initial_state_match_jax(process):
    jspec, p, d, tspec, tp, td, _ = _single(process)
    assert tspec.var_no_n1 == jspec.var_no_n1 == (8 if process ==
                                                  PROCESSES[0] else 7)
    assert (tspec.z_out, tspec.times_no) == (jspec.z_out, jspec.times_no)
    for k in N1_KEYS:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(d[k]),
                                   rtol=1e-13, atol=0, err_msg=k)
    np.testing.assert_array_equal(
        thomo.n1_initial_state(tspec, tp, td).numpy(),
        np.asarray(jhomo.n1_initial_state(jspec, p, d)))


@pytest.mark.parametrize("process", PROCESSES)
def test_n1_rhs_matches_jax(process):
    """make_n1_rhs in float64 at perturbed states, against rmt_tpu's:
    1e-12 relative to the RHS scale."""
    jspec, p, d, tspec, tp, td, ys = _single(process)
    f_j, f_t = jhomo.make_n1_rhs(jspec), thomo.make_n1_rhs(tspec)
    for z, y in zip((0.0, 0.3, 0.6, 0.9), ys):
        want = np.asarray(f_j(z, jnp.asarray(y), p, d))
        got = f_t(torch.tensor(z, dtype=torch.float64), torch.as_tensor(y),
                  tp, td).numpy()
        assert got.shape == want.shape == (jspec.var_no_n1,)
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_density_ig_eos_matches_jax():
    rng = np.random.default_rng(0)
    P = rng.uniform(1e5, 1e7, 16)
    T = rng.uniform(400.0, 1200.0, 16)
    mw = rng.uniform(2e-3, 5e-2, 16)
    got = tthermo.density_ig_eos(torch.as_tensor(P), torch.as_tensor(T),
                                 torch.as_tensor(mw)).numpy()
    np.testing.assert_allclose(got, np.asarray(jthermo.density_ig_eos(
        P, T, mw)), rtol=1e-15)


def test_default_jacobian_matches_jacrev_and_jax():
    """The integrator's default Newton-Schulz Jacobian
    (stiff_ensemble.batched_jacobian: forward-mode JVPs of the batched f)
    on the batched N1 RHS at B = 3 perturbed states, float64: against
    torch.func.jacrev member by member, and against rmt_tpu's batched
    jacfwd (its odeint_ensemble's jac=None, batched=True branch), 1e-12
    relative to the Jacobian's scale."""
    offs = np.array([-5.0, 0.0, 5.0])
    f, _, y0, _ = bench_torch_n1.build(t_input(model="N1"), offs, "cpu",
                                       torch.float64)
    rng = np.random.default_rng(0)
    y = y0 * torch.as_tensor(1 + 0.05 * rng.uniform(size=tuple(y0.shape)))
    t = torch.full((3,), 0.2, dtype=torch.float64)
    J = t_se.batched_jacobian(f, t, y)
    assert tuple(J.shape) == (3, 8, 8)
    scale = float(J.abs().max())
    for b in range(3):
        def fb(yb, b=b):
            return f(t, torch.cat([y[:b], yb[None], y[b + 1:]]))[b]

        Jb = torch.func.jacrev(fb)(y[b])
        np.testing.assert_allclose(J[b].numpy(), Jb.numpy(), rtol=0,
                                   atol=1e-12 * scale)

    fB_j, _ = _jax_batch(offs)
    yj, tj = jnp.asarray(y.numpy()), jnp.full((3,), 0.2)
    cols = jax.vmap(lambda e: jax.jvp(lambda yy: fB_j(tj, yy), (yj,),
                                      (jnp.tile(e[None], (3, 1)),))[1])(
        jnp.eye(8))
    np.testing.assert_allclose(J.numpy(), np.moveaxis(np.asarray(cols), 0,
                                                      -1),
                               rtol=0, atol=1e-12 * scale)


def test_n1_lockstep_float64_matches_jax():
    """The lockstep N1 run of scripts/bench_torch_n1.py (Newton-Schulz
    mode, the default Jacobian, dense output, bench tolerances) in
    float64 at B = 3, against rmt_tpu's odeint_ensemble(batched=True,
    dense_output=True) in this x64 process: trajectories at 1e-6 (the bar
    of tests/test_torch_ns_lockstep.py), every member finished, attempts
    within 1.25x. Over the whole length a borderline acceptance can go
    the other way in one of the two runs (their float32 preconditioners
    round differently), and from there the trajectories differ by the
    step controller's error, under the rtol of 1e-5 but over 1e-6."""
    offs = np.array([-5.0, 0.0, 5.0])
    fB_j, y0_j = _jax_batch(offs)
    ys_j, st_j = j_se.odeint_ensemble(fB_j, y0_j, jnp.asarray(TS),
                                      batched=True, **SOLVER)
    f, f_stages, y0, _ = bench_torch_n1.build(t_input(model="N1"), offs,
                                              "cpu", torch.float64)
    np.testing.assert_array_equal(y0.numpy(), np.asarray(y0_j))
    ys_t, st_t = t_se.odeint_ensemble(f, y0, TS, f_stages=f_stages,
                                      **SOLVER, batched=True)
    assert ys_t.dtype == torch.float64
    assert int(torch.sum(st_t.seg < len(TS) - 1)) == 0
    assert int(jnp.sum(st_j.seg < len(TS) - 1)) == 0
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-6,
                               atol=1e-9)
    att_t = (st_t.n_accepted + st_t.n_rejected).numpy()
    att_j = np.asarray(st_j.n_accepted + st_j.n_rejected)
    assert att_t.max() <= 1.25 * att_j.max(), (att_t, att_j)


def test_n1_float32_run_matches_scipy_reference():
    """The bench's float32 run at two probe temperatures against scipy's
    Radau (rtol 1e-10, atol 1e-13, t_eval the output grid) on rmt_tpu's
    float64 N1 RHS: within the 5e-5 bar of scripts/bench_torch_n1.py,
    relative error with the denominator max(|ref|, 1e-7)."""
    offs = np.array([-5.0, 5.0])
    f, f_stages, y0, _ = bench_torch_n1.build(t_input(model="N1"), offs,
                                              "cpu", torch.float32)
    ys, st = t_se.odeint_ensemble(f, y0, TS, f_stages=f_stages, batched=True,
                                  **SOLVER)
    assert ys.dtype == torch.float32
    assert int(torch.sum(st.seg < len(TS) - 1)) == 0

    fB_j, y0_j = _jax_batch(offs)
    jac_j = jax.jit(lambda t, y: jax.vmap(jax.jacfwd(
        lambda yy, i: fB_j(jnp.full((2,), t), y.at[i].set(yy))[i]),
        in_axes=(0, 0))(y, jnp.arange(2)))

    def fun(z, x):
        return np.asarray(fB_j(jnp.full((2,), z), x.reshape(2, 8))).ravel()

    def jac(z, x):
        return scipy.linalg.block_diag(*np.asarray(jac_j(z, x.reshape(2,
                                                                      8))))

    sol = solve_ivp(fun, (0.0, TS[-1]), np.asarray(y0_j).ravel(),
                    method="Radau", t_eval=TS, rtol=1e-10, atol=1e-13,
                    jac=jac)
    assert sol.success
    ref = sol.y.T.reshape(len(TS), 2, 8)
    rel = bench_torch_n1.rel_err(ys.numpy(), ref)
    assert float(rel.max()) <= bench_torch_n1.BAR, float(rel.max())


def test_scipy_reference_matches_jax_rhs():
    """scripts/bench_torch_n1.scipy_reference (scipy's Radau on the
    port's float64 N1 RHS, the card's reference) against the same scipy
    solve on rmt_tpu's RHS, at a looser tolerance to keep it cheap: the
    two RHS agree to rounding, so the solves take the same steps."""
    offs = np.array([-5.0, 5.0])
    mi = t_input(model="N1")
    got = bench_torch_n1.scipy_reference(mi, offs, rtol=1e-6, atol=1e-9)
    ts = np.linspace(0.0, 1.0, thomo.build_spec(mi).z_out + 1)
    assert got.shape == (len(ts), 2, 8)
    fB_j, y0_j = _jax_batch(offs)
    sol = solve_ivp(
        lambda z, x: np.asarray(fB_j(jnp.full((2,), z),
                                     x.reshape(2, 8))).ravel(),
        (0.0, 1.0), np.asarray(y0_j).ravel(), method="Radau", t_eval=ts,
        rtol=1e-6, atol=1e-9)
    assert sol.success
    np.testing.assert_allclose(got, sol.y.T.reshape(len(ts), 2, 8),
                               rtol=1e-6, atol=1e-9)


def test_new_entry_points_default_to_the_card():
    """Without device=, the N1 sweep's builder and a microbatched N2 run
    use the CUDA card; on a host without one they raise instead of
    running on the CPU (rmt_tpu_torch.config.resolve_device)."""
    from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep

    mi = t_input(model="N1")
    calls = (lambda: bench_torch_n1.build(mi, bench_torch_n1.PROBES),
             lambda: run_n2_ensemble_lockstep(
                 t_input(model="N2", op_period=0.002),
                 {"T0": np.array([523.0, 524.0])}, max_steps=8,
                 microbatch=1))
    if torch.cuda.is_available():
        assert calls[0]()[2].device.type == "cuda"
        assert calls[1]()[0].device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()
    f, _, y0, ts = bench_torch_n1.build(mi, bench_torch_n1.PROBES, "cpu")
    assert y0.device.type == ts.device.type == "cpu"
    assert y0.dtype == torch.float32
