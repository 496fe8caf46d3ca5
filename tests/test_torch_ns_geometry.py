# The launch geometry of the Newton-Schulz kernels (rmt_tpu_torch/csrc/ns.cu,
# chosen by ops/cuda_ns.geometry, and csrc/ns_wide.cu for n > 160, chosen
# by ops/cuda_ns.wide_geometry) and the panel decomposition they follow:
# the update splits into independent column panels, and rho is the sum of
# per-panel Frobenius partial sums added in panel order. Plain float32
# versions in each kernel's order are held here to the port's twin and to
# rmt_tpu's Pallas kernel (interpret mode); the CUDA kernels are held to
# the twin on the card by chip_smoke.py and scripts/kernel_time.py.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmt_tpu.ops.pallas_ns import ns_fused_step as j_step
from rmt_tpu_torch.ops import cuda_ns
from rmt_tpu_torch.solvers.stiff_ensemble import _transformed_tableau

_W = _transformed_tableau()[4]
EIG = dict(gamma=float(_W[0].real), mu_r=float(_W[1].real),
           mu_i=float(_W[1].imag))

# n -> (panel width, panels, padded rows, threads)
GEOMETRY = {24: (24, 1, 32, 32), 80: (40, 2, 80, 128),
            100: (36, 3, 112, 128), 140: (48, 3, 144, 224),
            160: (40, 4, 160, 224)}


@pytest.mark.parametrize("n", sorted(GEOMETRY))
def test_geometry(n):
    """Panel width and count, padded rows, threads and shared memory for
    the DME (140), CH4 (80) and test (24) widths, a partial last panel
    (100) and the widest supported class (160)."""
    geo = cuda_ns.geometry(n)
    assert (geo.width, geo.panels, geo.rows, geo.threads) == GEOMETRY[n]
    assert geo.width == 4 * geo.tx and geo.rows == 8 * geo.ty
    assert geo.panels * geo.width >= n > (geo.panels - 1) * geo.width
    assert geo.width <= 48
    assert geo.rows >= n and geo.rows % 16 == 0
    assert geo.tx * geo.ty <= geo.threads <= 256 and geo.threads % 32 == 0
    # two buffers of the three P/MP panels, two k-slab buffers of the
    # three A operands (17 floats a row) and the reduction array, within
    # a Hopper block's shared memory
    want = 4 * (2 * 3 * geo.rows * geo.width + 2 * 3 * 17 * geo.rows
                + 3 * geo.threads)
    assert geo.smem_bytes == want <= 232_448


# n -> (panel width, panels, slab rows, slab depth, threads, copy bytes) of
# the wide route: the two test widths, zNo 30's n = 210 (even, not a
# multiple of 4), an odd n in the 16-column class, zNo 60's n = 420 and
# n = 1000 (zNo 142)
WIDE = {161: (44, 4, 168, 20, 256, 4), 200: (40, 5, 200, 20, 256, 16),
        210: (36, 6, 216, 20, 256, 8), 301: (24, 13, 304, 12, 256, 4),
        420: (16, 27, 424, 12, 224, 16), 1000: (8, 125, 1000, 4, 256, 16)}


def _check_wide(geo, n):
    """A wide geometry covers n and fits a Hopper block: panels of whole
    micro-tile columns covering n with no empty panel, all rows in one
    slab of 8-row micro-tiles, at most 256 threads in whole warps, the
    shared memory of csrc/ns_wide.cu's layout within 232,448 bytes, and
    copies as wide as n's rows allow."""
    assert geo.n == n
    assert geo.width == 4 * geo.tx and geo.slab_rows == 8 * geo.ty
    assert geo.panels * geo.width >= n > (geo.panels - 1) * geo.width
    assert n <= geo.slab_rows < n + 8
    assert geo.depth in (20, 12, 4)
    assert geo.tx * geo.ty <= geo.threads <= 256 and geo.threads % 32 == 0
    assert geo.threads - geo.tx * geo.ty < 32
    # 128 bytes of barriers, three P / M P panels, two buffers of three A
    # slabs (depth floats a row; as many rows as the tensor maps' boxes of
    # at most 256 rows, multiples of 8, hold), three sums a warp
    boxes = -(-geo.slab_rows // 256)
    box_rows = 8 * -(-geo.slab_rows // (8 * boxes))
    assert box_rows <= 256 and n <= boxes * box_rows < n + 8 * boxes + 8
    want = 128 + 4 * (3 * geo.slab_rows * geo.width
                      + 6 * boxes * box_rows * geo.depth
                      + 3 * (geo.threads // 32))
    assert geo.smem_bytes == want <= 232_448
    assert geo.copy_bytes == (16 if n % 4 == 0 else 8 if n % 2 == 0 else 4)
    assert geo.scratch_floats == 3 * geo.panels


@pytest.mark.parametrize("n", [0, 161, 200])
def test_geometry_refuses_what_does_not_fit(n):
    """n = 0 is refused by both routes. A member wider than 160 does not
    fit one block of csrc/ns.cu; the wrapper routes it, from n alone, to
    csrc/ns_wide.cu, whose geometry holds every n up to its limit."""
    with pytest.raises(ValueError, match="ns_fused_step"):
        cuda_ns.geometry(n)
    if n == 0:
        for fn in (cuda_ns.route, cuda_ns.wide_geometry):
            with pytest.raises(ValueError, match="ns_fused_step"):
                fn(n)
        return
    assert cuda_ns.route(n) == "wide"
    geo = cuda_ns.wide_geometry(n)
    assert (geo.width, geo.panels, geo.slab_rows, geo.depth, geo.threads,
            geo.copy_bytes) == WIDE[n]
    _check_wide(geo, n)


@pytest.mark.parametrize("n", sorted(set(WIDE) - {161, 200}))
def test_wide_geometry(n):
    """The wide geometry at zNo 30 (n = 210: 6 panels of 36 columns, 256
    threads, slabs of 20), an odd n (4-byte copies, slabs of 12), zNo 60
    (n = 420: 16 columns, slabs of 12) and n = 1000 (8 columns, slabs of
    4)."""
    geo = cuda_ns.wide_geometry(n)
    assert (geo.width, geo.panels, geo.slab_rows, geo.depth, geo.threads,
            geo.copy_bytes) == WIDE[n]
    _check_wide(geo, n)


@pytest.mark.parametrize("lo", range(161, 1001, 40))
def test_wide_geometry_covers(lo):
    """Every n from 161 to 1,000 (zNo 142), 40 widths a case, has a wide
    geometry that covers it and fits a block."""
    for n in range(lo, min(lo + 40, 1001)):
        _check_wide(cuda_ns.wide_geometry(n), n)


def test_wide_geometry_limit():
    """The widest member the wide route takes is WIDE_MAX_N (a panel of 4
    columns whose rows fill the shared memory); one wider raises a
    ValueError that names the limit, while route still sends it wide."""
    top = cuda_ns.WIDE_MAX_N
    assert top >= 1000
    geo = cuda_ns.wide_geometry(top)
    _check_wide(geo, top)
    assert geo.width == 4
    with pytest.raises(ValueError, match=f"limit WIDE_MAX_N = {top}"):
        cuda_ns.wide_geometry(top + 1)
    assert cuda_ns.route(top + 1) == "wide"


def test_route_boundary():
    """Every width up to 160 keeps the one-block kernel; 161 and above
    take the wide route."""
    assert all(cuda_ns.route(n) == "one_block" for n in range(1, 161))
    cuda_ns.geometry(160)
    assert all(cuda_ns.route(n) == "wide" for n in (161, 210, 420, 2000))


def _panel_step(J, Pr, Pcr, Pci, h32, gamma, mu_r, mu_i, geo=None):
    """One Newton-Schulz step in the order of csrc/ns.cu (geo of
    cuda_ns.geometry) or csrc/ns_wide.cu (geo of cuda_ns.wide_geometry):
    for each column panel, the three MP panels from J and the P panels,
    the panel's Frobenius partial sums (added to the running sums in panel
    order), then the P' panels from all rows of P and the MP panels. Plain
    float32 torch.matmul on panels."""
    n = J.shape[-1]
    geo = geo or cuda_ns.geometry(n)
    h = h32[:, None, None]
    g, mr, mi = gamma * h, mu_r * h, mu_i * h
    eye = torch.eye(n, dtype=J.dtype)
    outs = [torch.empty_like(Pr) for _ in range(3)]
    s_r = s_c = s_i = torch.zeros(J.shape[0], dtype=J.dtype)
    for p in range(geo.panels):
        jp = slice(p * geo.width, min((p + 1) * geo.width, n))
        pr, pcr, pci = Pr[..., jp], Pcr[..., jp], Pci[..., jp]
        jpr, jpcr, jpci = J @ pr, J @ pcr, J @ pci
        mpr = pr - g * jpr
        mpcr = pcr - (mr * jpcr - mi * jpci)
        mpci = pci - (mr * jpci + mi * jpcr)
        dr, dc = eye[:, jp] - mpr, eye[:, jp] - mpcr
        s_r = s_r + torch.sum(dr * dr, dim=(-1, -2))
        s_c = s_c + torch.sum(dc * dc, dim=(-1, -2))
        s_i = s_i + torch.sum(mpci * mpci, dim=(-1, -2))
        outs[0][..., jp] = 2.0 * pr - Pr @ mpr
        outs[1][..., jp] = 2.0 * pcr - (Pcr @ mpcr - Pci @ mpci)
        outs[2][..., jp] = 2.0 * pci - (Pci @ mpcr + Pcr @ mpci)
    res_r = torch.sqrt(s_r / n)
    res_c = torch.sqrt((s_c + s_i) / n)
    return (*outs, torch.maximum(res_r, res_c))


def _setup(n, B=2, seed=0):
    """Random stiff Jacobians and iterates three twin steps past the cold
    seed (so the step contracts), float32."""
    rng = np.random.default_rng(seed)
    J = torch.as_tensor((-np.eye(n) * rng.uniform(1.0, 50.0, (B, 1, 1))
                         + 0.3 * rng.standard_normal((B, n, n))
                         ).astype(np.float32))
    h32 = torch.as_tensor(rng.uniform(0.005, 0.02, B).astype(np.float32))
    P = cuda_ns.ns_cold_start(J, h32, **EIG)
    for _ in range(3):
        *P, _ = cuda_ns.ns_fused_step_twin(J, *P, h32, *EIG.values())
    return J, *(p.contiguous() for p in P), h32


@pytest.mark.parametrize("n", [24, 100, 140])
def test_panel_order_matches_twin_and_pallas(n):
    """The panel decomposition computes the same step: within 1e-6 of the
    twin (|d| / (1 + |twin|) on the iterates, relative on rho; only the
    float32 summation order differs) and within the 2e-5 bar of
    tests/test_pallas_ns.py of rmt_tpu's kernel."""
    J, Pr, Pcr, Pci, h32 = _setup(n)
    got = _panel_step(J, Pr, Pcr, Pci, h32, *EIG.values())
    twin = cuda_ns.ns_fused_step_twin(J, Pr, Pcr, Pci, h32, *EIG.values())
    for g, w, name in zip(got[:3], twin[:3], ("Pr", "Pcr", "Pci")):
        err = float(((g.double() - w.double()).abs()
                     / (1.0 + w.double().abs())).max())
        assert err <= 1e-6, (name, err)
    rho_rel = float(((got[3] - twin[3]).abs() / twin[3]).max())
    assert rho_rel <= 1e-6
    want = j_step(*(jnp.asarray(t.numpy()) for t in (J, Pr, Pcr, Pci, h32)),
                  **EIG, interpret=True)
    for g, w, name in zip(got, want, ("Pr", "Pcr", "Pci", "rho")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def _wide_step(J, Pr, Pcr, Pci, h32, gamma, mu_r, mu_i):
    """One Newton-Schulz step in the order of csrc/ns_wide.cu: a block per
    (member, panel of cuda_ns.wide_geometry) takes all rows at once, so
    the order is the panel order of _panel_step at the wide route's panel
    width; the panels' sums are added in panel order."""
    return _panel_step(J, Pr, Pcr, Pci, h32, gamma, mu_r, mu_i,
                       geo=cuda_ns.wide_geometry(J.shape[-1]))


@pytest.mark.parametrize("n", [161, 200, 210, 301])
def test_wide_order_matches_twin_and_pallas(n):
    """The wide route's panel order computes the same step (161 and 301
    odd, 210 even and not a multiple of 4): within 1e-6 of the twin and
    within the 2e-5 bar of rmt_tpu's kernel (interpret mode), which takes
    the whole (1, n, n) member at any n."""
    J, Pr, Pcr, Pci, h32 = _setup(n)
    got = _wide_step(J, Pr, Pcr, Pci, h32, *EIG.values())
    twin = cuda_ns.ns_fused_step_twin(J, Pr, Pcr, Pci, h32, *EIG.values())
    for g, w, name in zip(got[:3], twin[:3], ("Pr", "Pcr", "Pci")):
        err = float(((g.double() - w.double()).abs()
                     / (1.0 + w.double().abs())).max())
        assert err <= 1e-6, (name, err)
    rho_rel = float(((got[3] - twin[3]).abs() / twin[3]).max())
    assert rho_rel <= 1e-6
    want = j_step(*(jnp.asarray(t.numpy()) for t in (J, Pr, Pcr, Pci, h32)),
                  **EIG, interpret=True)
    for g, w, name in zip(got, want, ("Pr", "Pcr", "Pci", "rho")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
