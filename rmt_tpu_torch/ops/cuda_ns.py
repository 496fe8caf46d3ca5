# Fused Newton-Schulz preconditioner update (port of
# rmt_tpu/ops/pallas_ns.py): the wrapper of the CUDA kernels in csrc/ns.cu
# and csrc/ns_wide.cu beside their plain-PyTorch twin.
#
# The lockstep integrator keeps approximate inverses Pr ~ (I - h*gamma*J)^-1
# and Pcr + i Pci ~ (I - h*mu*J)^-1 per member and refreshes them once per
# attempt. One step is P' = 2P - P(MP) for both systems: three J-products,
# the M P assembly, the Frobenius residual of the INPUT iterate (the
# certificate's input), and five P(MP) products.
#
# Two routes, chosen up front from n alone (route): members of n <= 160
# fit one block of csrc/ns.cu (geometry); wider ones run csrc/ns_wide.cu
# (wide_geometry), whose resident blocks walk (member, column panel)
# pairs, each keeping its panel's M P in shared memory, then a pass that
# adds the panels' Frobenius sums in order. Neither needs device scratch
# beyond those per-panel sums.
#
# A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
# twin. The two agree up to float32 summation order (the twin's products
# are torch.matmul), so they are held to a tolerance, not bit for bit.

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

# one count a kernel: the one-block route and the wide route
LAUNCHES = {"ns_fused_step": 0, "ns_fused_step_wide": 0}

_f32 = torch.float32
_vp = ctypes.c_void_p

# csrc/ns.cu's constants: a thread's micro-tile (rows x columns), the k
# depth of a staged slab, the widest panel, the block's thread limit and
# the shared memory a Hopper block may use
MICRO_ROWS, MICRO_COLS, SLAB = 8, 4, 16
MAX_PANEL_WIDTH = 48
MAX_THREADS = 256
MAX_SMEM_BYTES = 232_448
# the widest member csrc/ns.cu takes in one block; wider ones take the
# wide route
ONE_BLOCK_MAX_N = 160
# csrc/ns_wide.cu's slab depths, deepest first (each 4 more than a
# multiple of 8 floats, so that 8 consecutive slab rows start in different
# banks); the widest member it takes
WIDE_DEPTHS = (20, 12, 4)
# shared bytes before the panels (kHead: the slab buffers' barriers)
WIDE_HEAD_BYTES = 128
WIDE_MAX_N = 1584


class Geometry(NamedTuple):
    """The launch geometry of csrc/ns.cu for matrices of edge n."""
    n: int
    width: int        # columns of a panel, 4 * tx
    panels: int       # panels * width >= n
    rows: int         # n padded to a multiple of SLAB, 8 * ty
    tx: int           # threads across a panel
    ty: int           # threads down the rows
    threads: int      # tx * ty rounded up to whole warps
    smem_bytes: int   # dynamic shared memory of a block


def geometry(n: int) -> Geometry:
    """Panel width and count, padded rows, threads and shared-memory bytes
    of the kernel for n x n matrices: the fewest panels of at most 48
    columns, each as narrow as covers n; rows padded to whole slabs; a
    thread per 8 x 4 micro-tile. Raises ValueError when a member does not
    fit one block (more than 256 threads or 227 KB of shared memory: any
    n > 160, which the wrapper routes to the wide kernel)."""
    if n <= 0:
        raise ValueError(f"ns_fused_step: n = {n}")
    panels = -(-n // MAX_PANEL_WIDTH)
    tx = -(-n // (MICRO_COLS * panels))
    rows = SLAB * -(-n // SLAB)
    ty = rows // MICRO_ROWS
    width = MICRO_COLS * tx
    threads = 32 * -(-(tx * ty) // 32)
    # two buffers of three panels (a panel's P and its MP, which then
    # takes the next panel's P), two buffers of the three A slabs (SLAB
    # floats a row and 8 more every 8 rows), the reduction array
    smem = 4 * (2 * 3 * rows * width + 2 * 3 * rows * (SLAB + 1)
                + 3 * threads)
    if tx * ty > MAX_THREADS or smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"ns_fused_step: n = {n} does not fit one block ({tx * ty} "
            f"threads of at most {MAX_THREADS}, {smem} bytes of shared "
            f"memory of at most {MAX_SMEM_BYTES})")
    return Geometry(n, width, panels, rows, tx, ty, threads, smem)


class WideGeometry(NamedTuple):
    """The launch geometry of csrc/ns_wide.cu for matrices of edge n."""
    n: int
    width: int        # columns of a panel, 4 * tx
    panels: int       # pairs a member: panels * width >= n
    slab_rows: int    # rows of every slab: n rounded up to 8, 8 * ty
    depth: int        # k depth of a staged slab
    tx: int           # threads across a panel
    ty: int           # threads down the rows
    threads: int      # tx * ty rounded up to whole warps
    smem_bytes: int   # dynamic shared memory of a block
    copy_bytes: int   # widest copy n's rows allow: 16, 8 or 4
    scratch_floats: int   # device scratch a member: the panels' Frobenius
                          # sums (3 a panel)


def route(n: int) -> str:
    """The kernel that takes members of edge n: "one_block" (csrc/ns.cu)
    up to ONE_BLOCK_MAX_N, "wide" (csrc/ns_wide.cu) above it."""
    if n <= 0:
        raise ValueError(f"ns_fused_step: n = {n}")
    return "one_block" if n <= ONE_BLOCK_MAX_N else "wide"


def _wide_smem(rows, width, depth, threads):
    """Shared bytes of csrc/ns_wide.cu: the barriers, the three P / M P
    panels, two buffers of three A slabs (depth floats a row) and the
    per-warp sums."""
    # a slab buffer holds the tensor maps' boxes: at most 256 rows each,
    # a multiple of 8
    boxes = -(-rows // 256)
    slab_rows = boxes * MICRO_ROWS * -(-rows // (MICRO_ROWS * boxes))
    return WIDE_HEAD_BYTES + 4 * (3 * rows * width + 6 * slab_rows * depth
                                  + 3 * (threads // 32))


def wide_geometry(n: int) -> WideGeometry:
    """Panel width and count, rows, slab depth, threads, shared-memory
    bytes, copy width and scratch of the wide route for n x n matrices
    (the wrapper takes it for n > ONE_BLOCK_MAX_N). All n rows go in one
    slab, a thread per 8 x 4 micro-tile; the panels are the fewest whose
    threads fit a block (at most MAX_THREADS), each as narrow as covers n;
    the slab depth is the deepest of WIDE_DEPTHS whose shared memory then
    fits, else the panels narrow. Raises ValueError above WIDE_MAX_N."""
    if n <= 0:
        raise ValueError(f"ns_fused_step: n = {n}")
    ty = -(-n // MICRO_ROWS)
    rows = MICRO_ROWS * ty
    for most in range(MAX_THREADS // ty, 0, -1):
        panels = -(-n // (MICRO_COLS * most))
        tx = -(-n // (MICRO_COLS * panels))
        threads = 32 * -(-(tx * ty) // 32)
        width = MICRO_COLS * tx
        for depth in WIDE_DEPTHS:
            smem = _wide_smem(rows, width, depth, threads)
            if smem <= MAX_SMEM_BYTES:
                copy = 16 if n % 4 == 0 else 8 if n % 2 == 0 else 4
                return WideGeometry(n, width, panels, rows, depth, tx, ty,
                                    threads, smem, copy, 3 * panels)
    raise ValueError(
        f"ns_fused_step: n = {n} is wider than the wide route's limit "
        f"WIDE_MAX_N = {WIDE_MAX_N} (a panel of 4 columns over all rows "
        f"must fit {MAX_THREADS} threads and {MAX_SMEM_BYTES} bytes of "
        f"shared memory)")


@functools.cache
def _lib():
    """The kernel's library, built at first use (once a process)."""
    return bind(_build.load(*build_job()))


@functools.cache
def _wide_lib():
    """The wide route's library, built at first use (once a process)."""
    lib = _build.load(*wide_build_job())
    lib.ns_wide_step_launch.argtypes = (
        [_vp] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3 + [_vp])
    lib.ns_wide_step_launch.restype = ctypes.c_int
    lib.ns_wide_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.ns_wide_blocks_per_sm.restype = ctypes.c_int
    return lib


def wide_blocks_per_sm(geo: WideGeometry) -> int:
    """Resident blocks of csrc/ns_wide.cu per SM at geo, from CUDA's
    occupancy calculator (builds the library at first use)."""
    return _wide_lib().ns_wide_blocks_per_sm(geo.threads, geo.smem_bytes)


def bind(lib):
    """Set the argument types of ns_fused_step_launch on a loaded library
    (also used to time another source with the same C interface)."""
    lib.ns_fused_step_launch.argtypes = (
        [_vp] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [_vp])
    lib.ns_fused_step_launch.restype = ctypes.c_int
    return lib


def build_job():
    """(name, source, flags) of the kernel's library for
    _build.compile_sources. Built with FFMA contraction on: the kernel is
    dense float32 products, held to its twin by a tolerance."""
    return ("ns", (_build.CSRC / "ns.cu").read_text(), _build.NVCC_FLAGS_FMA)


def wide_build_job():
    """(name, source, flags) of the wide route's library, as build_job."""
    return ("ns_wide", (_build.CSRC / "ns_wide.cu").read_text(),
            _build.NVCC_FLAGS_FMA)


def ns_fused_step_twin(J, Pr, Pcr, Pci, h32, gamma, mu_r, mu_i):
    """One Newton-Schulz iteration in plain PyTorch (full-float32
    torch.matmul). Returns (Pr', Pcr', Pci', rho_pre)."""
    n = J.shape[-1]
    h = h32[:, None, None]
    g, mr, mi = gamma * h, mu_r * h, mu_i * h
    JP = torch.matmul(J, Pr)
    JPr = torch.matmul(J, Pcr)
    JPi = torch.matmul(J, Pci)
    MPr = Pr - g * JP
    MPc_r = Pcr - (mr * JPr - mi * JPi)
    MPc_i = Pci - (mr * JPi + mi * JPr)
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    # residual of the CURRENT iterate: ||.||_F / sqrt(n)
    dr = eye - MPr
    dc = eye - MPc_r
    inv_n = 1.0 / n
    res_r = torch.sqrt(torch.sum(dr * dr, dim=(-1, -2)) * inv_n)
    res_c = torch.sqrt((torch.sum(dc * dc, dim=(-1, -2))
                        + torch.sum(MPc_i * MPc_i, dim=(-1, -2))) * inv_n)
    rho = torch.maximum(res_r, res_c)
    Ar = torch.matmul(Pcr, MPc_r) - torch.matmul(Pci, MPc_i)
    Ai = torch.matmul(Pci, MPc_r) + torch.matmul(Pcr, MPc_i)
    return (2.0 * Pr - torch.matmul(Pr, MPr), 2.0 * Pcr - Ar,
            2.0 * Pci - Ai, rho)


def ns_cold_start(J, h32, *, gamma, mu_r, mu_i):
    """Guaranteed-convergent Newton-Schulz seeds P0 = M^H / (|M|_1 |M|_inf)
    for Mr = I - h*gamma*J and Mc = I - h*(mu_r + i mu_i)*J, in plain
    PyTorch. J (B, n, n), h32 (B,) float32; returns the three seeds (real
    system, complex system's real and imaginary part), contiguous. A
    diverged iterate never recovers (its residual squares), so failed
    members are re-seeded from these."""
    n = J.shape[-1]
    h = h32[:, None, None]
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    Mr = eye - (gamma * h) * J
    Mcr = eye - h * mu_r * J
    Mci = -h * mu_i * J

    def scale(mag):
        norm1 = torch.amax(torch.sum(mag, dim=-2), dim=-1)
        norminf = torch.amax(torch.sum(mag, dim=-1), dim=-1)
        return (norm1 * norminf)[:, None, None]

    def conj_t(A, s, sign=1.0):
        return (sign * A.transpose(-1, -2) / s).contiguous()

    s_c = scale(torch.sqrt(Mcr ** 2 + Mci ** 2))
    return (conj_t(Mr, scale(Mr.abs())), conj_t(Mcr, s_c),
            conj_t(Mci, s_c, -1.0))


class Workspace:
    """Device buffers of a run of kernel steps, allocated once: two sets
    of output iterates to alternate between, so that a chain of steps
    allocates nothing. The set a step writes is the one its input does
    not live in. Both routes keep a panel's M P intermediates in shared
    memory; the wide route's per-panel Frobenius sums (wide_geometry's
    scratch_floats a member) are allocated here too."""

    def __init__(self, B, n, device):
        self.sets = [tuple(torch.empty((B, n, n), dtype=_f32, device=device)
                           for _ in range(3)) for _ in range(2)]
        self.scratch = (torch.empty(B * wide_geometry(n).scratch_floats,
                                    dtype=_f32, device=device)
                        if route(n) == "wide" else None)

    def out_for(self, Pr):
        mine = self.sets[0][0].data_ptr()
        return self.sets[1] if Pr.data_ptr() == mine else self.sets[0]


def ns_fused_step(J, Pr, Pcr, Pci, h32, *, gamma, mu_r, mu_i, workspace=None,
                  lib=None):
    """One fused Newton-Schulz iteration for the whole ensemble.

    J, Pr, Pcr, Pci: (B, n, n) float32; h32: (B,) float32. Returns
    (Pr', Pcr', Pci', rho_pre), rho_pre (B,) the residual of the INPUT
    iterate. With a Workspace the outputs are its buffers (valid until
    the second next step through it); without, they are new tensors.
    The route follows from n alone (route): csrc/ns.cu up to
    ONE_BLOCK_MAX_N, csrc/ns_wide.cu above it.
    lib: another build of the one-block kernel with the same C interface
    (bind), for timing it beside this one; the default is csrc/ns.cu.
    """
    if J.device.type != "cuda":
        return ns_fused_step_twin(J, Pr, Pcr, Pci, h32, gamma, mu_r, mu_i)
    if J.dim() != 3 or J.shape[1] != J.shape[2]:
        raise ValueError(f"ns_fused_step: J shape {tuple(J.shape)} is not "
                         "(B, n, n)")
    B, n, _ = J.shape
    wide = route(n) == "wide"
    geo = wide_geometry(n) if wide else geometry(n)
    for t, shape in ((J, (B, n, n)), (Pr, (B, n, n)), (Pcr, (B, n, n)),
                     (Pci, (B, n, n)), (h32, (B,))):
        if t.device != J.device or t.dtype != _f32 or not t.is_contiguous():
            raise ValueError("ns_fused_step: every operand must be a "
                             f"contiguous float32 tensor on {J.device}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"ns_fused_step: shape {tuple(t.shape)} != {shape}")
    if workspace is None:
        outs = tuple(torch.empty_like(J) for _ in range(3))
    else:
        outs = workspace.out_for(Pr)
        if any(tuple(o.shape) != (B, n, n) or o.device != J.device
               for o in outs):
            raise ValueError("ns_fused_step: the workspace was made for "
                             "another shape or device")
    # phase 2 of the kernel reads the inputs while the outputs are written
    ins = {t.data_ptr() for t in (J, Pr, Pcr, Pci)}
    if any(o.data_ptr() in ins for o in outs):
        raise ValueError("ns_fused_step: an output buffer aliases an input")
    rho = torch.empty((B,), dtype=_f32, device=J.device)
    mats = (J, Pr, Pcr, Pci, *outs)
    if wide:
        # the panels' Frobenius sums (B, panels, 3)
        scratch = workspace.scratch if workspace is not None else None
        if scratch is None or scratch.numel() != B * geo.scratch_floats:
            scratch = torch.empty(B * geo.scratch_floats, dtype=_f32,
                                  device=J.device)
        # the widest copy n's rows and every matrix's address allow
        copy = geo.copy_bytes
        while any(t.data_ptr() % copy for t in mats):
            copy //= 2
        err = _wide_lib().ns_wide_step_launch(
            J.data_ptr(), Pr.data_ptr(), Pcr.data_ptr(), Pci.data_ptr(),
            h32.data_ptr(), *(o.data_ptr() for o in outs), rho.data_ptr(),
            scratch.data_ptr(), B, n, geo.tx, geo.ty, geo.depth, geo.panels,
            geo.threads, geo.smem_bytes, copy, gamma, mu_r, mu_i,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "ns_fused_step (wide)")
        LAUNCHES["ns_fused_step_wide"] += 1
        return (*outs, rho)
    vec_ok = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in mats)
    err = (lib or _lib()).ns_fused_step_launch(
        J.data_ptr(), Pr.data_ptr(), Pcr.data_ptr(), Pci.data_ptr(),
        h32.data_ptr(), *(o.data_ptr() for o in outs), rho.data_ptr(), B, n,
        geo.tx, geo.ty, geo.panels, geo.threads, geo.smem_bytes,
        int(vec_ok), gamma, mu_r, mu_i,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ns_fused_step")
    LAUNCHES["ns_fused_step"] += 1
    return (*outs, rho)
