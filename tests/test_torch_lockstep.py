# The port's lockstep ensemble (rmt_tpu_torch.parallel.
# run_n2_ensemble_lockstep on rmt_tpu_torch.solvers.stiff_ensemble)
# against rmt_tpu's, end to end at B = 2 with the f32x options of bench.py
# (df32 kinetics, exact block solves, 2 cheap sweeps, j_every 8,
# 5 Newton sweeps) at rtol 1e-5 / atol 1e-7 to keep the CPU time small,
# and the CH4 second chemistry on the same path against bench_ref.npz.
# On the CPU every kernel of the path runs as its plain PyTorch twin.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dme_case import make_model_input
from rmt_tpu.parallel import run_n2_ensemble_lockstep as j_run
from rmt_tpu.solvers import stiff_ensemble as j_se
from rmt_tpu_torch.cases.dme_case import make_model_input as t_input
from rmt_tpu_torch.parallel import Mesh
from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep as t_run
from rmt_tpu_torch.solvers import stiff_ensemble as t_se

T0 = 523.0 + np.array([0.0, 5.0])
KW = dict(max_steps=768, rtol=1e-5, atol=1e-7, newton_iters=5, j_every=8,
          accurate_rates="df32", exact_solve=True, cheap_sweeps=2)


def _attempts(st):
    return np.asarray(st.n_accepted) + np.asarray(st.n_rejected)


@pytest.fixture(scope="module")
def runs():
    ys_j, st_j = j_run(make_model_input(model="N2"), {"T0": jnp.asarray(T0)},
                       **KW)
    ys_t, st_t = t_run(t_input(model="N2"), {"T0": T0}, device="cpu", **KW)
    return np.asarray(ys_j, np.float64), st_j, ys_t, st_t


def test_lockstep_every_member_finishes(runs):
    _, st_j, ys_t, st_t = runs
    assert ys_t.dtype == torch.float32
    n_seg = ys_t.shape[0] - 1
    assert int(torch.sum(st_t.seg < n_seg)) == 0
    assert int(np.sum(np.asarray(st_j.seg) < n_seg)) == 0
    assert bool(torch.isfinite(ys_t).all())


def test_lockstep_trajectories_match_jax(runs):
    """tests/test_ensemble.py bar: 5e-4 relative, denominator
    max(|ref|, 1e-7) (two step-controlled f32 integrations of the same
    problem)."""
    ys_j, _, ys_t, _ = runs
    assert tuple(ys_t.shape) == ys_j.shape
    rel = np.abs(ys_t.numpy().astype(np.float64) - ys_j) / np.maximum(
        np.abs(ys_j), 1e-7)
    assert float(rel.max()) < 5e-4, float(rel.max())


def test_lockstep_attempts_match_jax(runs):
    """The port's step control is the reference's: at most 1.25x the
    attempts of the JAX run; the stats add up."""
    _, st_j, _, st_t = runs
    att_t, att_j = _attempts(st_t), _attempts(st_j)
    assert att_t.max() <= 1.25 * att_j.max(), (att_t, att_j)
    rej = st_t.n_rej_conv + st_t.n_rej_err + st_t.n_rej_rho
    assert torch.equal(rej, st_t.n_rejected)
    assert st_t.n_jev >= 2
    assert torch.all(st_t.n_fev >= 1 + 16 * st_t.n_accepted)


def test_out_members_rows_equal_full_run():
    """out_members records only the probe rows; those rows, every
    member's final state and the stats equal the full run's."""
    mi = t_input(model="N2", op_period=0.05)
    sweep = {"T0": 523.0 + np.array([-4.0, 0.0, 4.0])}
    kw = dict(KW, rtol=1e-4, atol=1e-6)
    ys_full, st_full = t_run(mi, sweep, device="cpu", **kw)
    idx = np.array([0, 2])
    ys_sel, y_fin, st_sel = t_run(mi, sweep, device="cpu", out_members=idx,
                                  **kw)
    assert tuple(ys_sel.shape) == (ys_full.shape[0], 2, ys_full.shape[2])
    assert torch.equal(ys_sel, ys_full[:, idx])
    assert torch.equal(y_fin, ys_full[-1])
    assert torch.equal(st_sel.n_accepted, st_full.n_accepted)
    assert torch.equal(st_sel.seg, st_full.seg)


def _linear_problem():
    """A stiff block lower-bidiagonal linear operator in the v*z + z_idx
    layout (tests/test_pallas_block.py)."""
    m, z = 4, 8
    n = m * z
    rng = np.random.default_rng(6)
    J = np.zeros((n, n))
    Jd = np.zeros((z, m, m))
    Jl = np.zeros((z, m, m))
    for zi in range(z):
        Jd[zi] = -np.diag(rng.uniform(5.0, 200.0, m)) + 0.3 * \
            rng.standard_normal((m, m))
        if zi > 0:
            Jl[zi] = 0.5 * rng.standard_normal((m, m))
        rows = np.arange(m) * z + zi
        J[np.ix_(rows, rows)] = Jd[zi]
        if zi > 0:
            J[np.ix_(rows, rows - 1)] = Jl[zi]
    y0 = rng.uniform(0.5, 1.5, (2, n))
    return m, z, J, Jd, Jl, y0


def test_odeint_ensemble_matches_jax_block_mode():
    """The integrator alone, float64 states, on a linear block-bidiagonal
    problem: the port against rmt_tpu's block mode (the tolerance of
    tests/test_pallas_block.py's lockstep check)."""
    m, z, J, Jd, Jl, y0 = _linear_problem()
    ts = np.array([0.0, 0.05, 0.1])
    A = jnp.asarray(J)
    ys_j, st_j = j_se.odeint_ensemble(
        lambda t, y: y @ A.T, jnp.asarray(y0), jnp.asarray(ts), rtol=1e-6,
        atol=1e-9, batched=True, max_steps=512, block=(m, z),
        use_pallas=False)
    Jt = torch.as_tensor(J)
    Jdt = torch.as_tensor(Jd).expand(2, z, m, m)
    Jlt = torch.as_tensor(Jl).expand(2, z, m, m)
    ys_t, st_t = t_se.odeint_ensemble(
        lambda t, y: y @ Jt.T, torch.as_tensor(y0), ts,
        jac_blocks=lambda t, y: (Jdt, Jlt), block=(m, z), rtol=1e-6,
        atol=1e-9, max_steps=512, batched=True)
    assert int(torch.sum(st_t.seg < 2)) == 0
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=2e-5,
                               atol=1e-8)
    assert _attempts(st_t).max() <= 1.25 * _attempts(st_j).max()


def test_unported_options_raise():
    """Newton-Schulz mode (no exact_solve), microbatch, dense_output,
    accurate_rates True and "full" and batched_rhs are ported and no
    longer raise (tests/test_torch_n2_options.py holds them to rmt_tpu);
    neither does mesh (tests/test_torch_mesh.py), but mesh with microbatch
    raises ValueError, as in rmt_tpu."""
    mi = t_input(model="N2", op_period=0.002)
    sweep = {"T0": T0}
    ys, st = t_run(mi, sweep, device="cpu", max_steps=8, j_every=8)
    assert tuple(ys.shape) == (6, 2, 140) and st.n_jev >= 2
    with pytest.raises(ValueError, match="cheap_sweeps"):
        t_run(mi, sweep, device="cpu", cheap_sweeps=2)
    with pytest.raises(ValueError, match="cheap_sweeps"):
        t_run(mi, sweep, device="cpu", exact_solve=True, cheap_sweeps=2)
    with pytest.raises(ValueError, match="shared period"):
        t_run(mi, {"opT": np.array([0.5, 0.6])}, device="cpu",
              exact_solve=True)
    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="microbatch and mesh"):
        t_run(mi, sweep, exact_solve=True, mesh=mesh, microbatch=1)
    ys, st = t_run(mi, sweep, device="cpu", max_steps=8, j_every=8,
                   microbatch=1, dense_output=True)
    assert tuple(ys.shape) == (6, 2, 140) and st.n_jev >= 4


def test_ch4_f32x_sweep_matches_reference_probes():
    """The second chemistry (m = 4, n = 80) through the f32x path at
    B = 2: bench.py's f32x options on the CH4 case at two probe
    temperatures of bench_ref.npz, within its 1e-6 bar of the converged
    float64 states."""
    import os

    from rmt_tpu_torch.cases.ch4_case import make_model_input as ch4_input

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "bench_ref.npz")) as z:
        pick = [0, 15]
        t0 = float(z["ch4_t_base"]) + z["ch4_offsets"][pick]
        want = z["ch4_ys"][:, pick]
    ys, st = t_run(ch4_input(model="N2"), {"T0": t0}, device="cpu",
                   **dict(KW, rtol=6e-7, atol=1e-9))
    assert tuple(ys.shape) == want.shape == (6, 2, 80)
    assert int(torch.sum(st.seg < 5)) == 0
    rel = np.abs(ys.numpy().astype(np.float64) - want) / np.maximum(
        np.abs(want), 1e-7)
    assert float(rel.max()) <= 1e-6, float(rel.max())
