# Dense output of the port's lockstep integrator
# (rmt_tpu_torch.solvers.stiff_ensemble.odeint_ensemble(dense_output=True))
# against the exact solution, the clamped mode and rmt_tpu's, mirroring
# tests/test_solvers.py's dense-output cases. On the CPU the Newton-Schulz
# kernel runs as its plain PyTorch twin.

import jax.numpy as jnp
import numpy as np
import torch

from rmt_tpu.solvers import stiff_ensemble as j_se
from rmt_tpu_torch.cases.dme_case import make_model_input as t_input
from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep as t_run
from rmt_tpu_torch.solvers import stiff_ensemble as t_se

LAM = np.array([[-1.0, -10.0], [-0.5, -40.0]])     # (B = 2, n = 2)
TS = np.linspace(0.0, 2.0, 65)                       # 64 boundaries
KW = dict(rtol=1e-7, atol=1e-10, max_steps=512)


def _attempts(st):
    return np.asarray(st.n_accepted) + np.asarray(st.n_rejected)


def _scaled_to_exact(ys):
    """Error scaled like the step controller (atol + rtol |y|): the fast
    components decay to ~1e-35, where any absolute floor dwarfs them."""
    exact = np.exp(LAM[None] * TS[:, None, None])
    return float(np.max(np.abs(np.asarray(ys) - exact)
                        / (1e-8 + 1e-5 * np.abs(exact))))


def _port(dense, y0=None, lam=LAM, **kw):
    lam_t = torch.as_tensor(lam)
    y0 = torch.ones(lam.shape, dtype=torch.float64) if y0 is None else y0
    return t_se.odeint_ensemble(lambda t, y: lam_t * y, y0, TS,
                                dense_output=dense, **KW, **kw, batched=True)


def test_dense_output_interpolant_matches_exact_and_jax():
    """tests/test_solvers.py::test_lockstep_dense_output_interpolant on
    the port (the default dense Jacobian, float64 states): the dense
    states match the exact solution at the controller's tolerance, every
    member crosses all 64 boundaries, dense costs no more attempts than
    the clamped mode, and the trajectories and attempts are rmt_tpu's."""
    ys_d, st_d = _port(True)
    ys_c, st_c = _port(False)
    assert int(torch.min(st_d.seg)) == len(TS) - 1
    assert _scaled_to_exact(ys_d) < 1.0
    assert _scaled_to_exact(ys_c) < 1.0
    assert _attempts(st_d).max() <= _attempts(st_c).max()

    lam = jnp.asarray(LAM)
    ys_j, st_j = j_se.odeint_ensemble(
        lambda t, y: lam * y, jnp.ones((2, 2)), jnp.asarray(TS),
        batched=True, dense_output=True, **KW)
    np.testing.assert_allclose(ys_d.numpy(), np.asarray(ys_j), rtol=1e-6,
                               atol=1e-9)
    assert _attempts(st_d).max() <= 1.25 * _attempts(st_j).max()


def test_dense_output_out_members_rows_equal_full_run():
    """out_members records the probe rows of the dense run: those rows
    and the stats equal the full run's, bit for bit. Every member's final
    state is the accepted one, which the interpolant at the last boundary
    (L(1) = b) reproduces to rounding."""
    lam = np.concatenate([LAM, LAM[:1] * 3.0])
    y0 = torch.ones(lam.shape, dtype=torch.float64)
    ys_full, st_full = _port(True, y0, lam)
    idx = np.array([0, 2])
    ys_sel, y_fin, st_sel = _port(True, y0, lam, out_members=idx)
    assert torch.equal(ys_sel, ys_full[:, idx])
    np.testing.assert_allclose(y_fin.numpy(), ys_full[-1].numpy(),
                               rtol=1e-13, atol=1e-30)
    assert torch.equal(st_sel.n_accepted, st_full.n_accepted)
    assert torch.equal(st_sel.seg, st_full.seg)


def test_dense_output_n2_matches_clamped():
    """tests/test_solvers.py::test_lockstep_dense_output_n2_matches_clamped
    on the port's f32 leg (Newton-Schulz preconditioners, float32): the
    dense trajectories agree with the clamped ones within 5e-5 and cost no
    more attempts on average."""
    mi = t_input(model="N2")
    sweep = {"T0": np.array([523.0, 527.0])}
    kw = dict(max_steps=768, rtol=1e-5, atol=1e-7, newton_iters=5,
              j_every=8, device="cpu")
    ys_c, st_c = t_run(mi, sweep, **kw)
    ys_d, st_d = t_run(mi, sweep, dense_output=True, **kw)
    assert int(torch.min(st_d.seg)) == ys_d.shape[0] - 1
    assert bool(torch.isfinite(ys_d).all())
    yc = ys_c.double()
    rel = torch.max((ys_d.double() - yc).abs() / yc.abs().clamp(min=1e-7))
    assert float(rel) < 5e-5, float(rel)
    assert _attempts(st_d).mean() <= _attempts(st_c).mean() + 1
