# The block-solve kernels of the port (rmt_tpu_torch/ops/cuda_block.py):
# on the CPU each wrapper runs its plain PyTorch twin, held here to
# rmt_tpu's Pallas kernels (interpret mode) with the bars of
# tests/test_pallas_block.py, and to the dense Kronecker operator. The
# CUDA kernels themselves are held to the same twins on the card by
# chip_smoke.py.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmt_tpu.ops import pallas_block as pb
from rmt_tpu.solvers.stiff_ensemble import _transformed_tableau as j_tab
from rmt_tpu_torch.ops import _build
from rmt_tpu_torch.ops import cuda_block as cb
from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

_, _A, _, _, _W, _T, _TINV = _transformed_tableau()
GAMMA = float(_W[0].real)
MU_R, MU_I = float(_W[1].real), float(_W[1].imag)
T4 = lambda M: tuple(map(tuple, M))
COEF = cb.apply_coefficients(GAMMA, MU_R, MU_I, _T, _TINV)


def _setup(B=7, z=20, m=7, seed=0, scale=5.0):
    """Random stiff block-bidiagonal systems (tests/test_pallas_block.py
    inputs), member-last, as numpy."""
    rng = np.random.default_rng(seed)
    Jd = (scale * rng.standard_normal((B, z, m, m))).astype(np.float32)
    Jl = (2.0 * rng.standard_normal((B, z, m, m))).astype(np.float32)
    Jl[:, 0] = 0
    h = (10 ** rng.uniform(-3, -1.5, B)).astype(np.float32)
    R = rng.standard_normal((B, 3, m * z)).astype(np.float32)
    e = rng.standard_normal((B, m * z)).astype(np.float32)
    return dict(
        Jd=Jd, Jl=Jl, h=h, R=R, e=e,
        Jd_t=np.ascontiguousarray(Jd.transpose(1, 2, 3, 0)),
        Jl_t=np.ascontiguousarray(Jl.transpose(1, 2, 3, 0)),
        R_t=np.ascontiguousarray(R.reshape(B, 3, m, z).transpose(1, 2, 3, 0)),
        e_t=np.ascontiguousarray(e.reshape(B, m, z).transpose(1, 2, 0)))


def _jax(s):
    kw = dict(gamma=GAMMA, mu_r=MU_R, mu_i=MU_I, interpret=True)
    f = pb.block_factor(jnp.asarray(s["Jd_t"]), jnp.asarray(s["h"]), **kw)
    dk = pb.block_apply(
        jnp.asarray(s["R_t"]), *f, jnp.asarray(s["Jl_t"]),
        jnp.asarray(s["h"]), tir=T4(_TINV.real), tii=T4(_TINV.imag),
        tr=T4(_T.real), ti=T4(_T.imag), **kw)
    x = pb.block_apply_real(jnp.asarray(s["e_t"]), f[0],
                            jnp.asarray(s["Jl_t"]), jnp.asarray(s["h"]),
                            gamma=GAMMA, interpret=True)
    return [np.asarray(a) for a in f], np.asarray(dk), np.asarray(x)


def _port(s):
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    f = cb.block_factor(t["Jd_t"], t["h"], gamma=GAMMA, mu_r=MU_R, mu_i=MU_I)
    dk = cb.block_apply(t["R_t"], *f, t["Jl_t"], t["h"], coef=COEF)
    x = cb.block_apply_real(t["e_t"], f[0], t["Jl_t"], t["h"], gamma=GAMMA)
    return [a.numpy() for a in f], dk.numpy(), x.numpy()


@pytest.fixture(scope="module")
def solved():
    s = _setup()
    before = dict(cb.LAUNCHES)
    port = _port(s)
    # a CPU tensor runs the twin; the kernel counters stay untouched
    assert cb.LAUNCHES == before
    return s, _jax(s), port


def _rel(got, want):
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-3)))


def test_tableau_equals_jax():
    for a, b in zip(_transformed_tableau(), j_tab()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_factor_twin_matches_pallas(solved):
    """Same Gauss-Jordan steps with the same first-maximum pivoting: the
    inverses agree to f32 rounding (5e-5 with the 1e-3 floor)."""
    _, (jf, _, _), (tf, _, _) = solved
    for got, want in zip(tf, jf):
        assert got.shape == want.shape
        assert _rel(got, want) < 5e-5


def test_apply_twin_matches_pallas(solved):
    """tests/test_pallas_block.py bar: 5e-4 relative (the complex
    recurrence compounds f32 rounding over 20 nodes)."""
    _, (_, jdk, _), (_, tdk, _) = solved
    assert tdk.shape == jdk.shape
    assert _rel(tdk, jdk) < 5e-4


def test_apply_real_twin_matches_pallas(solved):
    """tests/test_pallas_block.py bar: 5e-5 relative."""
    _, (_, _, jx), (_, _, tx) = solved
    assert _rel(tx, jx) < 5e-5


def test_apply_solves_the_kronecker_system():
    """The stage solve is exact: M dK = R with M = I - h A (x) J, checked
    against the dense operator in float64 (tests/test_pallas_block.py)."""
    s = _setup(B=3, seed=2, scale=2.0)
    B, z, m = 3, 20, 7
    n = m * z
    _, tdk, _ = _port(s)
    dK = tdk.transpose(3, 0, 1, 2).reshape(B, 3, n).astype(np.float64)
    for b in range(B):
        J = np.zeros((n, n))
        for zi in range(z):
            rows = np.arange(m) * z + zi
            J[np.ix_(rows, rows)] = s["Jd"][b, zi]
            if zi > 0:
                J[np.ix_(rows, rows - 1)] = s["Jl"][b, zi]
        M = np.eye(3 * n) - float(s["h"][b]) * np.kron(_A, J)
        res = M @ dK[b].reshape(-1) - s["R"][b].astype(np.float64).reshape(-1)
        assert np.abs(res).max() / (np.abs(s["R"][b]).max() + 1.0) < 5e-4


def test_first_maximum_wins_pivot_ties():
    """Two rows with equal pivot magnitude: the lower index pivots, as in
    the TPU kernel; a permuted identity inverts exactly either way."""
    M = torch.tensor([[0.0, 2.0, 0.0], [2.0, 0.0, 0.0], [-2.0, 0.0, 1.0]])
    inv = cb._gj_inverse(M[None, :, :, None])[0, :, :, 0]
    torch.testing.assert_close(inv @ M, torch.eye(3), rtol=0, atol=1e-7)


def test_wrappers_reject_bad_operands_on_cuda_only():
    """The shape/dtype checks guard the CUDA launch; a CPU call goes to
    the twin, which follows the tensors it is given."""
    with pytest.raises(ValueError, match="shape"):
        _build.check_operands("x", (torch.zeros(2, 3),), ((3, 2),))
    with pytest.raises(ValueError, match="float32"):
        _build.check_operands(
            "x", (torch.zeros(2, 3, dtype=torch.float64),), ((2, 3),))


@pytest.mark.parametrize("m", range(2, 9))
def test_apply_geometry(m):
    """block_apply's tile for every block size csrc/block.cu instantiates:
    32 members a block (kTileMembers there, a warp's lanes), one thread
    per (member, row), and the six m x 32 recurrence vectors in static
    shared memory, inside the 48 KB and the 1024 threads a block may
    use."""
    geo = cb.tile_geometry(m, 6)
    assert geo == (32, 32 * m, 6 * m * 32 * 4)
    src = (_build.CSRC / "block.cu").read_text()
    assert f"constexpr int kTileMembers = {geo.members};" in src
    assert geo.threads <= 1024 and geo.smem_bytes <= 48 * 1024
    with pytest.raises(ValueError):
        cb.tile_geometry(m + 7, 6)


@pytest.mark.parametrize("m", range(2, 9))
def test_real_geometry(m):
    """block_apply_real's tile: block_apply's layout (the same
    kTileMembers) with its two m x 32 recurrence vectors."""
    geo = cb.tile_geometry(m, 2)
    assert geo == (32, 32 * m, 2 * m * 32 * 4)
    assert geo.threads <= 1024 and geo.smem_bytes <= 48 * 1024
    with pytest.raises(ValueError):
        cb.tile_geometry(m + 7, 2)


@pytest.mark.parametrize("m", range(2, 9))
def test_factor_geometry(m):
    """block_factor's launch, from csrc/block.cu's constants: a block's
    threads and static shared memory (XB, m x m floats a thread) fit a
    block's limits (1024, 48 KB) and blocks_per_sm of them an H100 SM's
    (2048 threads, 228 KB with 1 KB reserved a block); and at the main
    path's B = 4096 members x 20 nodes, one thread each, the blocks fit
    the 132 SMs in one wave."""
    geo = cb.factor_geometry(m)
    assert geo == (128, 5, m * m * 128 * 4)
    src = (_build.CSRC / "block.cu").read_text()
    assert f"constexpr int kFactorThreads = {geo.threads};" in src
    assert f"constexpr int kFactorBlocksPerSM = {geo.blocks_per_sm};" in src
    assert geo.threads <= 1024 and geo.smem_bytes <= 48 * 1024
    assert geo.blocks_per_sm * geo.threads <= 2048
    assert geo.blocks_per_sm * (geo.smem_bytes + 1024) <= 228 * 1024
    blocks = -(-4096 * 20 // geo.threads)
    assert blocks <= 132 * geo.blocks_per_sm
    with pytest.raises(ValueError):
        cb.factor_geometry(m + 7)


@pytest.fixture(scope="module")
def solved_ragged():
    """B = 37 members: a multiple of neither block_apply tile (16, 32)."""
    s = _setup(B=37, seed=3)
    return _jax(s), _port(s)


@pytest.mark.parametrize("kernel, bar", [("factor", 5e-5), ("apply", 5e-4),
                                         ("apply_real", 5e-5)])
def test_twins_match_pallas_at_a_ragged_count(solved_ragged, kernel, bar):
    """The bars of the B = 7 tests above, at B = 37."""
    (jf, jdk, jx), (tf, tdk, tx) = solved_ragged
    pairs = {"factor": list(zip(tf, jf)), "apply": [(tdk, jdk)],
             "apply_real": [(tx, jx)]}[kernel]
    for got, want in pairs:
        assert got.shape == want.shape and got.shape[-1] == 37
        assert _rel(got, want) < bar
