# Exact block-bidiagonal Radau stage solves (port of
# rmt_tpu/ops/pallas_block.py): wrappers of the CUDA kernels in
# csrc/block.cu, each beside its plain-PyTorch twin.
#
#   * block_factor (replaces pallas_block.block_factor) -- once per
#     attempt: per member and node, the Gauss-Jordan inverse of
#     I - h*gamma*Jd_z (partial pivoting, first maximum wins ties) and the
#     complex-shift inverse from two real inverses, Y = (A + B A^-1 B)^-1,
#     (A + iB)^-1 = Y - i A^-1 B Y, with A = I - h*mu_r*Jd and
#     B = -h*mu_i*Jd. Bound by bytes on the H100 (Jd in, three inverses
#     out, 64 MB at the main path's B = 4096, z = 20, m = 7), in practice
#     by instruction issue. The kernel runs one thread per (member, node)
#     and inverts in place, in the twin's operations and order, with
#     XB = A^-1 B in shared memory: 96 registers (a 40-byte spill) and
#     25,088 bytes of shared memory at m = 7; factor_geometry(m) gives
#     the launch (128 threads, five blocks an SM), which holds the main
#     path's 640 blocks in one wave.
#   * block_apply (replaces pallas_block.block_apply) -- once per Newton
#     sweep: W = T^-1 R, the real and complex recurrences
#     x_z = Minv_z (w_z + h*mu*Jl_z x_{z-1}) over the nodes, and
#     dK = Re(T Z), in one kernel. Bound by bytes.
#   * block_apply_real (replaces pallas_block.block_apply_real) -- the
#     real-shift solve (I - h*gamma*J) x = e that smooths the embedded
#     error estimate. Bound by bytes (Minv_r and Jl once, 37 MB). The
#     kernel runs block_apply's layout on its one recurrence: 67
#     registers, no spills, 1,792 bytes of shared memory at m = 7.
#
# Both recurrences run a tile of members a block (tile_geometry), one
# thread per (member, row of the m x m blocks) with two nodes of loads in
# flight. Registers, spills and shared memory of every instance: the
# compiler report that chip_smoke.py prints.
#
# Layouts are member-last, as on the TPU: (z, m, m, B) blocks, (3, m, z, B)
# stage vectors, (m, z, B) vectors, all float32. A CUDA tensor launches
# the kernel (or raises); a CPU tensor runs the twin, which computes the
# same function in the same order of operations.

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch

from . import _build

LAUNCHES = {"block_factor": 0, "block_apply": 0, "block_apply_real": 0}

_f32 = torch.float32
_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float


@functools.cache
def _lib():
    """The block kernels' library, built at first use (once a process)."""
    lib = _build.load("block", (_build.CSRC / "block.cu").read_text())
    lib.block_factor_launch.argtypes = [_vp] * 5 + [_i] * 3 + [_f] * 3 + [_vp]
    lib.block_apply_launch.argtypes = [_vp] * 7 + [_i] * 3 + [_vp, _vp]
    lib.block_apply_real_launch.argtypes = [_vp] * 5 + [_i] * 3 + [_f, _vp]
    for fn in (lib.block_factor_launch, lib.block_apply_launch,
               lib.block_apply_real_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _packed(vals):
    """block_apply's 21 constants as the host array its launch copies."""
    return (ctypes.c_float * len(vals))(*vals)


# -- plain-PyTorch twins ------------------------------------------------------

def _gj_inverse(M):
    """Batch Gauss-Jordan inverse of (..., m, m, B) member-last matrices,
    partial pivoting with the first maximum, exact row swaps."""
    m = M.shape[-2]
    eye = torch.eye(m, dtype=M.dtype, device=M.device)[..., None]
    A = torch.cat([M, eye.expand(M.shape)], dim=-2)       # (..., m, 2m, B)
    rows = torch.arange(m, device=M.device)[:, None]      # (m, 1)
    for col in range(m):
        mag = A[..., :, col, :].abs()                     # (..., m, B)
        best = mag[..., col, :]
        piv = torch.full_like(best, col, dtype=torch.long)
        for r in range(col + 1, m):
            upd = mag[..., r, :] > best
            best = torch.where(upd, mag[..., r, :], best)
            piv = torch.where(upd, torch.full_like(piv, r), piv)
        onehot = (piv[..., None, :] == rows)[..., :, None, :]  # (..., m,1,B)
        prow = torch.where(onehot, A, torch.zeros_like(A)).sum(dim=-3)
        old = A[..., col, :, :]
        A = torch.where(onehot, old[..., None, :, :], A)
        prow = prow / prow[..., col:col + 1, :]
        fac = A[..., :, col, :] * (rows != col).to(A.dtype)  # (..., m, B)
        A = A - fac[..., :, None, :] * prow[..., None, :, :]
        A = torch.where((rows == col)[..., None], prow[..., None, :, :], A)
    return A[..., :, m:, :]


def _matmat(M1, M2):
    """(z, m, m, B) @ (z, m, m, B), summed over j in order."""
    m = M1.shape[-2]
    acc = M1[..., :, 0, None, :] * M2[..., None, 0, :, :]
    for j in range(1, m):
        acc = acc + M1[..., :, j, None, :] * M2[..., None, j, :, :]
    return acc


def _matvec(Mz, x):
    """(m, k, B) block times (k, B) vector -> (m, B), summed in order."""
    acc = Mz[:, 0, :] * x[0][None, :]
    for j in range(1, Mz.shape[-2]):
        acc = acc + Mz[:, j, :] * x[j][None, :]
    return acc


def block_factor_twin(Jd_t, h32, gamma, mu_r, mu_i):
    m = Jd_t.shape[1]
    g = gamma * h32
    mr = mu_r * h32
    mi = mu_i * h32
    eye = torch.eye(m, dtype=_f32, device=Jd_t.device)[None, :, :, None]
    minv_r = _gj_inverse(eye - g * Jd_t)
    Am = eye - mr * Jd_t
    Bm = (0.0 - mi) * Jd_t
    X = _gj_inverse(Am)
    XB = _matmat(X, Bm)
    Y = _gj_inverse(Am + _matmat(Bm, XB))
    return minv_r, Y, -_matmat(XB, Y)


def block_apply_twin(R_t, Minv_r_t, Minv_cr_t, Minv_ci_t, Jl_t, h32, c):
    z_no = R_t.shape[2]
    g = (c["gamma"] * h32)[None, :]
    mr = (c["mu_r"] * h32)[None, :]
    mi = (c["mu_i"] * h32)[None, :]
    R = [R_t[s] for s in range(3)]
    w0 = (c["w0"][0] * R[0] + c["w0"][1] * R[1]) + c["w0"][2] * R[2]
    w1r = (c["w1r"][0] * R[0] + c["w1r"][1] * R[1]) + c["w1r"][2] * R[2]
    w1i = (c["w1i"][0] * R[0] + c["w1i"][1] * R[1]) + c["w1i"][2] * R[2]
    x0_p = torch.zeros_like(w0[:, 0, :])
    x1r_p = torch.zeros_like(x0_p)
    x1i_p = torch.zeros_like(x0_p)
    out = torch.empty_like(R_t)
    for z in range(z_no):
        Jl_z = Jl_t[z]
        t_r = _matvec(Jl_z, x0_p)
        x0 = _matvec(Minv_r_t[z], w0[:, z, :] + g * t_r)
        u_r = _matvec(Jl_z, x1r_p)
        u_i = _matvec(Jl_z, x1i_p)
        rhs_r = (w1r[:, z, :] + mr * u_r) - mi * u_i
        rhs_i = (w1i[:, z, :] + mr * u_i) + mi * u_r
        x1r = _matvec(Minv_cr_t[z], rhs_r) - _matvec(Minv_ci_t[z], rhs_i)
        x1i = _matvec(Minv_cr_t[z], rhs_i) + _matvec(Minv_ci_t[z], rhs_r)
        for i in range(3):
            out[i, :, z, :] = (c["c0"][i] * x0 + c["c1"][i] * x1r) \
                - c["c2"][i] * x1i
        x0_p, x1r_p, x1i_p = x0, x1r, x1i
    return out


def block_apply_real_twin(e_t, Minv_r_t, Jl_t, h32, gamma):
    g = (gamma * h32)[None, :]
    x_p = torch.zeros_like(e_t[:, 0, :])
    out = torch.empty_like(e_t)
    for z in range(e_t.shape[1]):
        t_r = _matvec(Jl_t[z], x_p)
        x_p = _matvec(Minv_r_t[z], e_t[:, z, :] + g * t_r)
        out[:, z, :] = x_p
    return out


# -- wrappers -----------------------------------------------------------------

@functools.cache
def _constants():
    """The launch constants of csrc/block.cu (`constexpr int kName =
    value;`), read from the source the library is built from, so the
    geometry below is the launch's and has no second copy."""
    src = (_build.CSRC / "block.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _check_m(name, m):
    if not 2 <= m <= 8:
        raise ValueError(f"{name} takes 2 <= m <= 8, not {m}")


class TileGeometry(NamedTuple):
    """Thread-block geometry of a recurrence kernel: `members` a block
    (kTileMembers, the lanes of a warp, so every load of a matrix entry is
    one 128-byte line for a warp), `threads` = m x members (thread (lane,
    i) owns row i of every m x m block) and the static shared memory of
    its recurrence vectors (m x members floats each)."""
    members: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def tile_geometry(m, vectors):
    """The tile of a recurrence kernel for m variables a node (2 <= m <=
    8, the sizes csrc/block.cu instantiates) with `vectors` recurrence
    vectors in shared memory: six for block_apply (x0, x1r, x1i and their
    right-hand sides), two for block_apply_real (x and its right-hand
    side)."""
    _check_m("a recurrence kernel", m)
    tb = _constants()["kTileMembers"]
    return TileGeometry(tb, m * tb, vectors * m * tb * 4)


class FactorGeometry(NamedTuple):
    """block_factor's launch: `threads` a block, one per (member, node);
    `blocks_per_sm`, the blocks an SM must hold (its __launch_bounds__,
    which caps the registers a thread at 65536 / (threads x
    blocks_per_sm)); the static shared memory a block, XB's m x m floats a
    thread."""
    threads: int
    blocks_per_sm: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def factor_geometry(m):
    """block_factor's launch for m variables a node, from kFactorThreads
    and kFactorBlocksPerSM in csrc/block.cu."""
    _check_m("block_factor", m)
    c = _constants()
    return FactorGeometry(c["kFactorThreads"], c["kFactorBlocksPerSM"],
                          m * m * c["kFactorThreads"] * 4)


def apply_coefficients(gamma, mu_r, mu_i, T, Tinv):
    """Constants of block_apply from the Radau eigen-transform (numpy
    complex T, T^-1), combined in double precision as the reference
    does: rows of T^-1 for the real and complex stage, and dK_i =
    c0_i z0 + c1_i Re z1 - c2_i Im z1."""
    return {
        "w0": [float(v) for v in Tinv.real[0]],
        "w1r": [float(v) for v in Tinv.real[1]],
        "w1i": [float(v) for v in Tinv.imag[1]],
        "c0": [float(T.real[i, 0]) for i in range(3)],
        "c1": [float(T.real[i, 1] + T.real[i, 2]) for i in range(3)],
        "c2": [float(T.imag[i, 1] - T.imag[i, 2]) for i in range(3)],
        "gamma": float(gamma), "mu_r": float(mu_r), "mu_i": float(mu_i),
    }


def block_factor(Jd_t, h32, *, gamma, mu_r, mu_i):
    """Factor the shifted block-diagonal systems for one attempt.

    Jd_t: (z, m, m, B) float32; h32: (B,) float32. Returns
    (Minv_r_t, Minv_cr_t, Minv_ci_t), each (z, m, m, B)."""
    if not Jd_t.is_cuda:
        return block_factor_twin(Jd_t, h32, gamma, mu_r, mu_i)
    z_no, m, _, B = Jd_t.shape
    _build.check_operands("block_factor", (Jd_t, h32), (Jd_t.shape, (B,)))
    outs = [torch.empty_like(Jd_t) for _ in range(3)]
    err = _lib().block_factor_launch(
        Jd_t.data_ptr(), h32.data_ptr(), *(o.data_ptr() for o in outs),
        B, z_no, m, gamma, mu_r, mu_i, _build.stream(Jd_t))
    _build.check(err, "block_factor")
    LAUNCHES["block_factor"] += 1
    return tuple(outs)


def block_apply(R_t, Minv_r_t, Minv_cr_t, Minv_ci_t, Jl_t, h32, *, coef):
    """Fused triple-stage solve M dK = R for the whole ensemble.
    R_t: (3, m, z, B) float32; coef from apply_coefficients. Returns
    dK_t of the same shape."""
    if not R_t.is_cuda:
        return block_apply_twin(R_t, Minv_r_t, Minv_cr_t, Minv_ci_t, Jl_t,
                                h32, coef)
    _, m, z_no, B = R_t.shape
    mat = (z_no, m, m, B)
    _build.check_operands("block_apply",
                (R_t, Minv_r_t, Minv_cr_t, Minv_ci_t, Jl_t, h32),
                (R_t.shape, mat, mat, mat, mat, (B,)))
    out = torch.empty_like(R_t)
    host = _packed(tuple(
        coef["w0"] + coef["w1r"] + coef["w1i"] + coef["c0"] + coef["c1"]
        + coef["c2"] + [coef["gamma"], coef["mu_r"], coef["mu_i"]]))
    err = _lib().block_apply_launch(
        R_t.data_ptr(), Minv_r_t.data_ptr(), Minv_cr_t.data_ptr(),
        Minv_ci_t.data_ptr(), Jl_t.data_ptr(), h32.data_ptr(),
        out.data_ptr(), B, z_no, m, ctypes.cast(host, _vp),
        _build.stream(R_t))
    _build.check(err, "block_apply")
    LAUNCHES["block_apply"] += 1
    return out


def block_apply_real(e_t, Minv_r_t, Jl_t, h32, *, gamma):
    """Real-shift solve (I - h*gamma*J) x = e. e_t: (m, z, B) float32."""
    if not e_t.is_cuda:
        return block_apply_real_twin(e_t, Minv_r_t, Jl_t, h32, gamma)
    m, z_no, B = e_t.shape
    mat = (z_no, m, m, B)
    _build.check_operands("block_apply_real", (e_t, Minv_r_t, Jl_t, h32),
                (e_t.shape, mat, mat, (B,)))
    out = torch.empty_like(e_t)
    err = _lib().block_apply_real_launch(
        e_t.data_ptr(), Minv_r_t.data_ptr(), Jl_t.data_ptr(), h32.data_ptr(),
        out.data_ptr(), B, z_no, m, gamma, _build.stream(e_t))
    _build.check(err, "block_apply_real")
    LAUNCHES["block_apply_real"] += 1
    return out
