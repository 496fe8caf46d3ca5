# The Newton-Schulz mode of the port's lockstep integrator
# (rmt_tpu_torch.solvers.stiff_ensemble.odeint_ensemble with block=None)
# and the f32 leg built on it (rmt_tpu_torch.parallel.
# run_n2_ensemble_lockstep without exact_solve) against rmt_tpu's.
#
# rmt_tpu's f32 leg is a whole-program float32 run, and x64 is a process
# level JAX switch that tests/conftest.py turns on: the reference side of
# the leg runs in a child process with RMT_TPU_X64=0 (as
# tests/test_ensemble.py::test_lockstep_f32_mode_subprocess does) and
# hands its trajectories and stats back through an .npz file.
# On the CPU the Newton-Schulz kernel runs as its plain PyTorch twin.

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clock import CHILD_LIMIT_S
from rmt_tpu.solvers import stiff_ensemble as j_se
from rmt_tpu_torch.cases.dme_case import make_model_input as t_input
from rmt_tpu_torch.ops import cuda_ns
from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep as t_run
from rmt_tpu_torch.solvers import stiff_ensemble as t_se

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# members at 518, 523 and 528 K: the outer two are reference probes of
# bench_ref.npz (offsets -5 and +5 from its base of 523 K)
T0 = 523.0 + np.array([-5.0, 0.0, 5.0])
# bench.py's f32 leg (LEGS["f32"])
F32 = dict(rtol=1e-5, atol=1e-7, max_steps=768, newton_iters=5, j_every=8)

_CHILD = """
import os, sys
os.environ["RMT_TPU_X64"] = "0"
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
import rmt_tpu
from rmt_tpu.parallel import run_n2_ensemble_lockstep
from dme_case import make_model_input
ys, st = run_n2_ensemble_lockstep(
    make_model_input(model="N2"), {{"T0": jnp.asarray({t0!r})}}, **{kw!r})
assert ys.dtype == jnp.float32, ys.dtype
np.savez({out!r}, ys=np.asarray(ys), seg=np.asarray(st.seg),
         att=np.asarray(st.n_accepted + st.n_rejected),
         n_rej_rho=np.asarray(st.n_rej_rho))
"""


def _attempts(st):
    return (st.n_accepted + st.n_rejected).numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("f32leg") / "jax_f32.npz")
    code = _CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                         t0=[float(v) for v in T0], kw=F32, out=out)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=CHILD_LIMIT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    ys_t, st_t = t_run(t_input(model="N2"), {"T0": T0}, device="cpu", **F32)
    return ref, ys_t, st_t


def test_f32_leg_every_member_finishes(runs):
    ref, ys_t, st_t = runs
    assert ys_t.dtype == torch.float32
    n_seg = ys_t.shape[0] - 1
    assert int(torch.sum(st_t.seg < n_seg)) == 0
    assert int(np.sum(ref["seg"] < n_seg)) == 0
    assert bool(torch.isfinite(ys_t).all())


def test_f32_leg_trajectories_match_jax(runs):
    """The bar of tests/test_torch_lockstep.py: 5e-4 relative, denominator
    max(|ref|, 1e-7) (two step-controlled float32 integrations of the same
    problem at rtol 1e-5)."""
    ref, ys_t, _ = runs
    ys_j = ref["ys"].astype(np.float64)
    assert tuple(ys_t.shape) == ys_j.shape
    rel = np.abs(ys_t.numpy().astype(np.float64) - ys_j) / np.maximum(
        np.abs(ys_j), 1e-7)
    assert float(rel.max()) < 5e-4, float(rel.max())


def test_f32_leg_attempts_match_jax(runs):
    """The port's step control is the reference's: at most 1.25x the
    attempts of the JAX run. The certificate is live in this mode: the
    uncertified rejections are counted and the reject classes add up."""
    ref, _, st_t = runs
    att_t = _attempts(st_t)
    assert att_t.max() <= 1.25 * ref["att"].max(), (att_t, ref["att"])
    rej = st_t.n_rej_conv + st_t.n_rej_err + st_t.n_rej_rho
    assert torch.equal(rej, st_t.n_rejected)
    assert tuple(st_t.n_rej_rho.shape) == (len(T0),)
    assert st_t.n_jev >= 2 and 0 <= st_t.n_rescue < st_t.n_jev
    print("n_rej_rho port", st_t.n_rej_rho.tolist(), "jax",
          ref["n_rej_rho"].tolist(), "attempts port", att_t.tolist(), "jax",
          ref["att"].tolist(), "rescues", st_t.n_rescue)


def test_f32_leg_probe_error_no_worse_than_jax(runs):
    """Both packages' f32 leg against the converged float64 states of
    bench_ref.npz at the two probe members: the port must not sit further
    from them than twice the JAX package does, or than 2.5e-5 (two
    step-controlled float32 runs scatter by a few 1e-6 around each other
    with the summation order of the host's matmuls). bench.py sets no
    accuracy bar for this leg; the measured values are printed."""
    ref, ys_t, _ = runs
    with np.load(os.path.join(REPO, "bench_ref.npz")) as z:
        assert float(z["dme_t_base"]) == 523.0
        assert z["dme_offsets"][0] == -5.0 and z["dme_offsets"][-1] == 5.0
        want = z["dme_ys"][:, [0, -1]]

    def err(ys):
        got = np.asarray(ys, np.float64)[:, [0, 2]]
        return float((np.abs(got - want) / np.maximum(np.abs(want),
                                                      1e-7)).max())

    e_t, e_j = err(ys_t.numpy()), err(ref["ys"])
    print(f"f32 leg max_rel_err vs float64 reference: port {e_t:.4e}, "
          f"jax {e_j:.4e}")
    assert e_t <= max(2.0 * e_j, 2.5e-5), (e_t, e_j)


def _stiff_linear():
    """The stiff linear problem of tests/test_pallas_ns.py."""
    n = 12
    rng = np.random.default_rng(1)
    A = (-np.diag(rng.uniform(1.0, 300.0, n))
         + 0.5 * rng.standard_normal((n, n)))
    y0 = rng.uniform(0.5, 1.5, (2, n))
    return A, y0, np.array([0.0, 0.05, 0.1])


def test_odeint_ensemble_ns_mode_matches_jax():
    """The integrator alone in Newton-Schulz mode, float64 states with
    float32 preconditioners, against rmt_tpu's on its Pallas path (the
    kernel in interpret mode)."""
    A, y0, ts = _stiff_linear()
    Aj = jnp.asarray(A)
    ys_j, st_j = j_se.odeint_ensemble(
        lambda t, y: y @ Aj.T, jnp.asarray(y0), jnp.asarray(ts), rtol=1e-6,
        atol=1e-9, batched=True, max_steps=512, use_pallas=True)
    At = torch.as_tensor(A)
    before = dict(cuda_ns.LAUNCHES)
    ys_t, st_t = t_se.odeint_ensemble(
        lambda t, y: y @ At.T, torch.as_tensor(y0), ts,
        jac=lambda t, y: At.expand(2, 12, 12), rtol=1e-6, atol=1e-9,
        max_steps=512, batched=True)
    assert cuda_ns.LAUNCHES == before        # CPU tensors run the twin
    assert ys_t.dtype == torch.float64
    assert int(torch.sum(st_t.seg < 2)) == 0
    assert int(jnp.sum(st_j.seg < 2)) == 0
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-6,
                               atol=1e-9)
    att_j = np.asarray(st_j.n_accepted + st_j.n_rejected)
    assert _attempts(st_t).max() <= 1.25 * att_j.max()


def test_ns_mode_out_members_rows_equal_full_run():
    A, y0, ts = _stiff_linear()
    At = torch.as_tensor(A)
    y0 = torch.as_tensor(np.concatenate([y0, y0[:1] * 1.1]))
    kw = dict(jac=lambda t, y: At.expand(3, 12, 12), rtol=1e-6, atol=1e-9,
              max_steps=512)
    f = lambda t, y: y @ At.T
    ys_full, st_full = t_se.odeint_ensemble(f, y0, ts, **kw, batched=True)
    ys_sel, y_fin, st_sel = t_se.odeint_ensemble(
        f, y0, ts, out_members=np.array([0, 2]), **kw, batched=True)
    assert torch.equal(ys_sel, ys_full[:, [0, 2]])
    assert torch.equal(y_fin, ys_full[-1])
    assert torch.equal(st_sel.n_accepted, st_full.n_accepted)


def test_ns_mode_rescues_a_diverged_preconditioner():
    """A refresh outside the warm start's basin fails its certificate
    (forced here by a Jacobian 1e4 times too large at the first refresh,
    so that h0 * |J| >> 1 meets P = I); the cold rescue re-seeds those
    members, later refreshes see the true Jacobian, and the run still
    finishes on the exact solution."""
    A, y0, ts = _stiff_linear()
    At = torch.as_tensor(A)
    calls = {"n": 0}

    def jac(t, y):
        calls["n"] += 1
        return (At * (1e4 if calls["n"] == 2 else 1.0)).expand(2, 12, 12)

    ys_t, st_t = t_se.odeint_ensemble(
        lambda t, y: y @ At.T, torch.as_tensor(y0), ts, jac=jac, rtol=1e-6,
        atol=1e-9, max_steps=512, batched=True)
    assert st_t.n_rescue >= 1
    assert int(torch.sum(st_t.seg < 2)) == 0
    assert bool(torch.isfinite(ys_t).all())
    want = np.stack([y0 @ torch.linalg.matrix_exp(At * float(t)).numpy().T
                     for t in ts])
    np.testing.assert_allclose(ys_t.numpy(), want, rtol=1e-4, atol=1e-7)


def test_mode_arguments_are_checked():
    """Block mode needs blocks that tile the state; without jac_blocks it
    extracts them from the dense jac, and without either from the default
    dense Jacobian of f (here dy/dt = y: y0 exp(t)), as in Newton-Schulz
    mode (tests/test_torch_dense_output.py holds that default)."""
    A, y0, ts = _stiff_linear()
    f = lambda t, y: y
    ys, st = t_se.odeint_ensemble(f, torch.as_tensor(y0), ts, block=(3, 4),
                                  rtol=1e-8, atol=1e-12, batched=True)
    assert bool((st.seg == 2).all())
    np.testing.assert_allclose(
        ys.numpy(), y0[None] * np.exp(np.asarray(ts))[:, None, None],
        rtol=1e-6)
    with pytest.raises(ValueError, match="does not tile"):
        t_se.odeint_ensemble(f, torch.as_tensor(y0), ts, block=(5, 3),
                             jac_blocks=lambda t, y: None, batched=True)
