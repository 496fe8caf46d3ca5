# Colored (sparse) Jacobians for method-of-lines RHS functions (port of
# rmt_tpu/ops/jacobian.py, the banded block-bidiagonal part: the dense
# matrix on its sparsity pattern, of one member or of a batch, and the
# blocks gathered directly).
#
# Backward-difference MoL couplings are block-bidiagonal in the axial node
# index: output (v, z) depends on inputs (v', z) and (v', z-1). A
# Curtis-Powell-Reid coloring over (variable, node-parity) gives 2*var_no
# JVP directions instead of var_no*z_no dense tangents.

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap


def banded_coloring(var_no: int, z_no: int):
    """Colors + sparsity mask for a (var_no, z_no) row-major MoL state."""
    n = var_no * z_no
    idx = np.arange(n)
    v_of = idx // z_no
    z_of = idx % z_no
    colors = v_of * 2 + (z_of % 2)
    n_colors = 2 * var_no
    V = np.zeros((n_colors, n))
    V[colors, idx] = 1.0
    mask = (z_of[:, None] == z_of[None, :]) | (z_of[:, None] == z_of[None, :] + 1)
    return colors, V, mask.astype(np.float64)


def colored_jacobian_from(rhs_flat, coloring):
    """jac(t, y, *args) -> (n, n) from an explicit (colors, V, mask)
    coloring (see banded_coloring): one JVP per color, reconstructed
    exactly on the sparsity pattern."""
    colors, V, mask = coloring
    colors_t = torch.as_tensor(colors)

    def jac(t, y, *args):
        fun = lambda yy: rhs_flat(t, yy, *args)
        V_y = torch.as_tensor(V, dtype=y.dtype, device=y.device)
        jv = vmap(lambda tangent: jvp(fun, (y,), (tangent,))[1])(V_y)
        mask_y = torch.as_tensor(mask, dtype=y.dtype, device=y.device)
        return jv[colors_t.to(y.device), :].T * mask_y

    return jac


def batched_colored_jacobian(fB, coloring):
    """jac(x (B, n)) -> (B, n, n) for a BATCHED function of independent
    members fB(x (B, n)) -> (B, n), from n_colors JVPs with tangents
    broadcast across the batch (members never mix, so one tangent per
    color serves every member)."""
    colors, V, mask = coloring
    colors_t = torch.as_tensor(colors)

    def jac(x):
        V_x = torch.as_tensor(V, dtype=x.dtype, device=x.device)
        jv = vmap(lambda tangent: jvp(fB, (x,), (tangent.expand_as(x),))[1])(
            V_x)                                        # (n_colors, B, n_out)
        # J[b, out, in] = jv[colors[in], b, out] on the sparsity mask
        mask_x = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
        return jv[colors_t.to(x.device)].permute(1, 2, 0) * mask_x

    return jac


def colored_jacobian(rhs_flat, var_no: int, z_no: int):
    """jac(t, y, *args) -> (n, n) from 2*var_no JVPs of rhs_flat, which
    must have the block-bidiagonal MoL sparsity (detach weak global
    couplings such as an axial pressure march)."""
    return colored_jacobian_from(rhs_flat, banded_coloring(var_no, z_no))


def colored_bidiag_blocks(rhs_flat, var_no: int, z_no: int):
    """jac_blocks(t, y, *args) -> (Jd, Jl), each (z_no, var_no, var_no),
    gathered directly from the 2*var_no colored JVP products (the dense
    (n, n) matrix is never formed). Jd[z] couples node z to itself, Jl[z]
    couples node z to z-1 (Jl[0] = 0)."""
    colors, V, _ = banded_coloring(var_no, z_no)
    z = np.arange(z_no)
    v = np.arange(var_no)
    # jv[c, r] = J[r, the column of color c that hits row r]
    row_d = (v[None, :, None] * z_no + z[:, None, None])     # (z, m, 1)
    col_d = (v[None, None, :] * 2 + (z[:, None, None] % 2))  # (z, 1, m)
    col_l = (v[None, None, :] * 2 + ((z[:, None, None] - 1) % 2))
    row_d, col_d, col_l = (
        torch.as_tensor(np.broadcast_to(a, (z_no, var_no, var_no)).copy())
        for a in (row_d, col_d, col_l)
    )
    zero_first = np.ones((z_no, 1, 1))
    zero_first[0] = 0.0

    def jac_blocks(t, y, *args):
        fun = lambda yy: rhs_flat(t, yy, *args)
        V_y = torch.as_tensor(V, dtype=y.dtype, device=y.device)
        jv = vmap(lambda tangent: jvp(fun, (y,), (tangent,))[1])(V_y)
        rd, cd, cl = (a.to(y.device) for a in (row_d, col_d, col_l))
        Jd = jv[cd, rd]                                 # (z, m, m)
        Jl = jv[cl, rd] * torch.as_tensor(zero_first, dtype=y.dtype,
                                          device=y.device)
        return Jd, Jl

    return jac_blocks
