# The Newton-Schulz step of the port (rmt_tpu_torch/ops/cuda_ns.py): on
# the CPU the wrapper runs its plain PyTorch twin, held here to rmt_tpu's
# fused Pallas kernel (ops/pallas_ns.py, interpret mode) with the bars of
# tests/test_pallas_ns.py, and the dense colored Jacobian that feeds it to
# rmt_tpu's. The CUDA kernel is held to the same twin on the card by
# chip_smoke.py.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ch4_case
import dme_case
from rmt_tpu.models import homo as jhomo
from rmt_tpu.ops.pallas_ns import ns_fused_step as j_step
from rmt_tpu_torch.convert import params_from_jax
from rmt_tpu_torch.models import homo as thomo
from rmt_tpu_torch.ops import cuda_ns
from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

_, _, _, _, _W, _, _ = _transformed_tableau()
EIG = dict(gamma=float(_W[0].real), mu_r=float(_W[1].real),
           mu_i=float(_W[1].imag))
CASES = {"dme": dme_case, "ch4": ch4_case}


def _near_inverse(J, h32, rng):
    """Iterates near the true inverses, so that one step contracts (the
    inputs of tests/test_pallas_ns.py::_setup)."""
    B, n, _ = J.shape
    eye = np.eye(n)
    Pr = np.stack([np.linalg.inv(eye - EIG["gamma"] * h32[b] * J[b])
                   for b in range(B)])
    mu = EIG["mu_r"] + 1j * EIG["mu_i"]
    Pc = np.stack([np.linalg.inv(eye - mu * h32[b] * J[b]) for b in range(B)])
    jitter = 0.01 * rng.standard_normal((B, n, n))
    f32 = np.float32
    return ((Pr + jitter).astype(f32),
            Pc.real.astype(f32) + jitter.astype(f32), Pc.imag.astype(f32))


def _random_setup(B=3, n=24, seed=0):
    rng = np.random.default_rng(seed)
    # moderately stiff random Jacobians with negative real parts
    J = (-np.eye(n) * rng.uniform(1.0, 50.0, (B, 1, 1))
         + 0.3 * rng.standard_normal((B, n, n))).astype(np.float32)
    h32 = rng.uniform(0.005, 0.02, B).astype(np.float32)
    return (J, *_near_inverse(J, h32, rng), h32)


def _model_state(case, dtype, seed=0):
    mi = CASES[case].make_model_input(model="N2")
    jspec, tspec = jhomo.build_spec(mi), thomo.build_spec(mi)
    p = jhomo.build_params(mi)
    d = jhomo.feed_state(jspec, p)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    tp = params_from_jax(p, device="cpu", dtype=tdt)
    td = params_from_jax(d, device="cpu", dtype=tdt)
    y0 = np.asarray(jhomo.n2_initial_state(jspec, p, d), np.float64)
    rng = np.random.default_rng(seed)
    y = (y0 * (1 + 0.05 * rng.uniform(size=y0.shape))).astype(dtype)
    return jspec, tspec, p, d, tp, td, y


def _dme_setup():
    """B = 2, n = 140: the DME dense Jacobian at two perturbed states."""
    rng = np.random.default_rng(5)
    Js = []
    for seed in (1, 2):
        _, tspec, _, _, tp, td, y = _model_state("dme", np.float32, seed)
        Js.append(thomo.make_n2_colored_jacobian(tspec)(
            0.0, torch.as_tensor(y), tp, td).numpy())
    J = np.stack(Js).astype(np.float32)
    # step sizes with h*gamma*|J| of order one
    norm = np.abs(J).sum(-1).max(-1)
    h32 = (np.array([0.5, 2.0]) / (EIG["gamma"] * norm)).astype(np.float32)
    return (J, *_near_inverse(J, h32, rng), h32)


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("setup", [_random_setup, _dme_setup],
                         ids=["random_n24", "dme_n140"])
def test_twin_matches_pallas_kernel(setup):
    """tests/test_pallas_ns.py bar: rtol = atol = 2e-5 on all four
    outputs (float32 products summed in another order)."""
    J, Pr, Pcr, Pci, h32 = setup()
    want = j_step(*(jnp.asarray(a) for a in (J, Pr, Pcr, Pci, h32)), **EIG,
                  interpret=True)
    before = dict(cuda_ns.LAUNCHES)
    got = cuda_ns.ns_fused_step(*_t(J, Pr, Pcr, Pci, h32), **EIG)
    assert cuda_ns.LAUNCHES == before        # CPU tensors run the twin
    for g, w, name in zip(got, want, ("Pr", "Pcr", "Pci", "rho")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_twin_rho_is_the_input_iterates_residual():
    """rho is ||I - M P||_F / sqrt(n) of the INPUT iterate (the larger of
    the real and the complex system), against float64 numpy."""
    J, Pr, Pcr, Pci, h32 = _random_setup(seed=2)
    rho = cuda_ns.ns_fused_step(*_t(J, Pr, Pcr, Pci, h32), **EIG)[3].numpy()
    n = J.shape[-1]
    for b in range(J.shape[0]):
        Jb, eye = J[b].astype(np.float64), np.eye(n)
        Mr = eye - EIG["gamma"] * float(h32[b]) * Jb
        Mc = eye - (EIG["mu_r"] + 1j * EIG["mu_i"]) * float(h32[b]) * Jb
        res_r = np.linalg.norm(eye - Mr @ Pr[b]) / np.sqrt(n)
        res_c = np.linalg.norm(eye - Mc @ (Pcr[b] + 1j * Pci[b])) / np.sqrt(n)
        np.testing.assert_allclose(rho[b], max(res_r, res_c), rtol=2e-5)


def test_twin_iterations_converge_to_inverse():
    """tests/test_pallas_ns.py::test_kernel_iterations_converge_to_inverse
    on the twin: four chained steps never raise max rho, and M Pr - I
    falls under 1e-4."""
    J, Pr, Pcr, Pci, h32 = _random_setup(seed=3)
    Jt, ht = _t(J, h32)
    P = _t(Pr, Pcr, Pci)
    rho_prev = None
    for _ in range(4):
        *P, rho = cuda_ns.ns_fused_step(Jt, *P, ht, **EIG)
        if rho_prev is not None:
            assert float(rho.max()) <= float(rho_prev.max()) + 1e-6
        rho_prev = rho
    eye = np.eye(J.shape[-1], dtype=np.float32)
    for b in range(J.shape[0]):
        M = eye - EIG["gamma"] * float(h32[b]) * J[b]
        assert np.abs(M @ P[0][b].numpy() - eye).max() < 1e-4


def test_cold_start_chain_matches_pallas_kernel():
    """From the cold seed P0 = M^H / (|M|_1 |M|_inf) (held to numpy), the
    residual after each of 8 iterations follows rmt_tpu's kernel on the
    same input: rtol 1e-3 while rho > 1e-4 (below that both sit on their
    own float32 rounding), and it contracts from below 1."""
    J, _, _, _, h32 = _random_setup(seed=4)
    Jt, ht = _t(J, h32)
    P = cuda_ns.ns_cold_start(Jt, ht, **EIG)
    n = J.shape[-1]
    for b in range(J.shape[0]):
        Jb = J[b].astype(np.float64)
        Mr = np.eye(n) - EIG["gamma"] * float(h32[b]) * Jb
        Mc = np.eye(n) - (EIG["mu_r"] + 1j * EIG["mu_i"]) * float(h32[b]) * Jb
        want_r = Mr.T / (np.abs(Mr).sum(0).max() * np.abs(Mr).sum(1).max())
        want_c = Mc.conj().T / (np.abs(Mc).sum(0).max()
                                * np.abs(Mc).sum(1).max())
        np.testing.assert_allclose(P[0][b].numpy(), want_r, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(P[1][b].numpy(), want_c.real, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(P[2][b].numpy(), want_c.imag, rtol=1e-5,
                                   atol=1e-7)
    assert all(p.is_contiguous() for p in P)
    Pj = tuple(jnp.asarray(p.numpy()) for p in P)
    Jj, hj = jnp.asarray(J), jnp.asarray(h32)
    rhos = []
    for _ in range(8):
        *P, rho_t = cuda_ns.ns_fused_step(Jt, *P, ht, **EIG)
        *Pj, rho_j = j_step(Jj, *Pj, hj, **EIG, interpret=True)
        rho_t, rho_j = rho_t.numpy(), np.asarray(rho_j)
        live = rho_j > 1e-4
        np.testing.assert_allclose(rho_t[live], rho_j[live], rtol=1e-3)
        rhos.append(rho_t.max())
    assert rhos[0] < 1.0 and rhos[-1] < rhos[0]


def test_workspace_alternates_between_its_sets():
    """A Workspace hands out the set of output buffers the input iterate
    does not live in, so a chain of steps never writes what it reads. For
    the one-block kernel (n <= 160) it holds nothing else: both routes
    keep their M P intermediates in shared memory, so there is no
    (B, 3, n, n) scratch; the wide route (n > 160) gets only its panels'
    Frobenius sums, three floats a panel and member."""
    ws = cuda_ns.Workspace(2, 5, "cpu")
    assert vars(ws).keys() == {"sets", "scratch"} and ws.scratch is None
    wide = cuda_ns.Workspace(2, 161, "cpu")
    assert (wide.scratch.numel()
            == 2 * cuda_ns.wide_geometry(161).scratch_floats
            == 2 * 3 * cuda_ns.wide_geometry(161).panels)
    assert all(tuple(t.shape) == (2, 5, 5) for s in ws.sets for t in s)
    foreign = torch.zeros((2, 5, 5))
    assert ws.out_for(foreign) is ws.sets[0]
    assert ws.out_for(ws.sets[0][0]) is ws.sets[1]
    assert ws.out_for(ws.sets[1][0]) is ws.sets[0]
    ptrs = {t.data_ptr() for s in ws.sets for t in s}
    assert len(ptrs) == 6


@pytest.mark.parametrize("case", ["dme", "ch4"])
def test_colored_jacobian_matches_jax(case):
    """The dense colored Jacobian at float64 against rmt_tpu's, rtol
    1e-10 of the matrix scale; it is zero off the bidiagonal pattern and
    its blocks are make_n2_bidiag_blocks'."""
    jspec, tspec, p, d, tp, td, y = _model_state(case, np.float64, seed=3)
    want = np.asarray(jhomo.make_n2_colored_jacobian(jspec)(
        0.0, jnp.asarray(y), p, d))
    yt = torch.as_tensor(y)
    got = thomo.make_n2_colored_jacobian(tspec)(0.0, yt, tp, td)
    m, z = tspec.var_no_n2, tspec.z_no
    assert tuple(got.shape) == (m * z, m * z) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    Jd, Jl = thomo.make_n2_bidiag_blocks(tspec)(0.0, yt, tp, td)
    rebuilt = torch.zeros_like(got)
    for zi in range(z):
        rows = torch.arange(m) * z + zi
        rebuilt[rows[:, None], rows[None, :]] = Jd[zi]
        if zi > 0:
            rebuilt[rows[:, None], rows[None, :] - 1] = Jl[zi]
    assert torch.equal(rebuilt, got)


def test_colored_jacobian_vmap_over_members():
    """run_n2_ensemble_lockstep maps the dense Jacobian over members
    with torch.func.vmap; it must equal the per-member calls."""
    _, tspec, _, _, tp, td, y = _model_state("dme", np.float64, seed=4)
    ys = torch.as_tensor(np.stack([y, y * 0.98]))
    f = thomo.make_n2_colored_jacobian(tspec)
    in_dims = ({k: (None if k != "kinetic_overrides" else {})
                for k in tp}, None)
    J = torch.func.vmap(f, in_dims=(None, 0) + in_dims)(0.0, ys, tp, td)
    for b in range(2):
        torch.testing.assert_close(J[b], f(0.0, ys[b], tp, td), rtol=1e-13,
                                   atol=0)
