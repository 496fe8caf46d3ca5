# Block extraction for block-bidiagonal method-of-lines Jacobians (port of
# rmt_tpu/ops/block_solve.py::extract_bidiag_blocks).
#
# The backward-difference MoL Jacobian couples node z only to {z, z-1}, so
# a dense (n, n) Jacobian in the flat state layout v*z_no + z is fully
# described by its (var_no x var_no) diagonal and subdiagonal node blocks.
# The lockstep integrator's block mode takes them from a dense Jacobian
# with this function and solves its stage systems with the block kernels
# of ops/cuda_block.py. The rest of rmt_tpu's module (its XLA solvers and
# the tridiagonal half) is not ported.

from __future__ import annotations

import torch


def extract_bidiag_blocks(J, var_no: int, z_no: int):
    """Diagonal and subdiagonal (var_no x var_no) blocks of a dense
    Jacobian.

    J: (B, n, n) with n = var_no*z_no, flat index v*z_no + z.
    Returns (Jd, Jl): (B, z_no, var_no, var_no); Jd[b, z] couples node z
    to itself, Jl[b, z] couples node z to node z-1 (Jl[b, 0] = 0).
    """
    B = J.shape[0]
    J5 = J.reshape(B, var_no, z_no, var_no, z_no)
    Jd = torch.diagonal(J5, dim1=2, dim2=4).movedim(-1, 1)   # (B, z, v, v')
    Jl_sub = torch.diagonal(J5, offset=-1, dim1=2, dim2=4).movedim(-1, 1)
    Jl = torch.cat([torch.zeros_like(Jl_sub[:, :1]), Jl_sub], dim=1)
    return Jd, Jl
