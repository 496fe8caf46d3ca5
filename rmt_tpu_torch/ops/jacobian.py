# Colored (sparse) Jacobians for method-of-lines RHS functions (port of
# rmt_tpu/ops/jacobian.py: the colorings, the dense matrix on its sparsity
# pattern, of one member or of a batch, and the bidiagonal blocks gathered
# directly).
#
# Backward-difference MoL couplings are block-bidiagonal in the axial node
# index: output (v, z) depends on inputs (v', z) and (v', z-1). A
# Curtis-Powell-Reid coloring over (variable, node-parity) gives 2*var_no
# JVP directions instead of var_no*z_no dense tangents. Central-difference
# dispersion reaches z+1 too (tridiag_coloring, 3*var_no directions), and
# the coupled gas/particle states of the dynamic heterogeneous models add
# particle rows that couple only within their node (two_phase_coloring).
#
# The same compression works on rows by reverse mode (one VJP a row color,
# rows of a color sharing no column): the dynamic heterogeneous models
# take their Jacobians that way (batched_row_colored_jacobian), since in
# eager PyTorch every forward-mode operation that meets a tangent-free
# operand costs host time that the reverse pass does not (measured on the
# CPU at M11's zNo 10, rNo 7: 75 ms a forward colored Jacobian, 23 ms a
# reverse one; the same matrix to 2.3e-16).

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vjp, vmap


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


def tridiag_coloring(var_no: int, z_no: int):
    """Colors + sparsity mask for a (var_no, z_no) row-major MoL state
    whose axial coupling is TRIdiagonal (central-difference dispersion:
    output (v, z) depends on inputs (v', z-1..z+1); the M13 gas phase,
    pbHeterReactor.py:1857-2160). 3*var_no JVP directions (columns 3
    nodes apart never hit a common output row)."""
    n = var_no * z_no
    idx = np.arange(n)
    v_of = idx // z_no
    z_of = idx % z_no
    colors = v_of * 3 + (z_of % 3)
    n_colors = 3 * var_no
    V = np.zeros((n_colors, n))
    V[colors, idx] = 1.0
    mask = np.abs(z_of[:, None] - z_of[None, :]) <= 1
    return colors, V, mask.astype(np.float64)


def two_phase_coloring(n_layer: int, r_rows: int, z_no: int):
    """Colors + sparsity mask for a (n_layer, r_rows, z_no) row-major state
    of the coupled dynamic heterogeneous models (M10-M12): radial row 0 is
    the gas phase (tridiagonal z-coupling: BD convection + CD dispersion +
    Danckwerts ghost), rows >= 1 are the particle interior (no z-coupling;
    full local coupling within a node through kinetics/energetics and to
    the local gas bulk).

    Each gas (layer,) variable needs 3 colors (z mod 3); each solid
    (layer, r) variable ONE (its columns touch only same-z rows, disjoint
    across z). Total 3*n_layer + n_layer*(r_rows-1) colors instead of
    n_layer*r_rows*z_no dense tangents."""
    n = n_layer * r_rows * z_no
    idx = np.arange(n)
    l_of = idx // (r_rows * z_no)
    r_of = (idx // z_no) % r_rows
    z_of = idx % z_no

    gas = r_of == 0
    n_gas_colors = 3 * n_layer
    colors = np.where(
        gas,
        l_of * 3 + (z_of % 3),
        n_gas_colors + l_of * (r_rows - 1) + (r_of - 1),
    )
    n_colors = n_gas_colors + n_layer * (r_rows - 1)
    V = np.zeros((n_colors, n))
    V[colors, idx] = 1.0
    dzc = z_of[:, None] - z_of[None, :]
    mask = (dzc == 0) | (gas[None, :] & (np.abs(dzc) <= 1))
    return colors, V, mask.astype(np.float64)


def two_phase_row_coloring(n_layer: int, r_rows: int, z_no: int):
    """Row (output) colors + sparsity mask of two_phase_coloring's pattern
    for the Jacobian by reverse mode: a row at node z reaches every column
    of node z and the gas columns of nodes z-1 and z+1, so rows three
    nodes apart share no column. 3 colors a (layer, radial row):
    3*n_layer*r_rows in all."""
    n = n_layer * r_rows * z_no
    idx = np.arange(n)
    colors = (idx // z_no) * 3 + (idx % z_no) % 3
    V = np.zeros((3 * n_layer * r_rows, n))
    V[colors, idx] = 1.0
    return colors, V, two_phase_coloring(n_layer, r_rows, z_no)[2]


def batched_row_colored_jacobian(fB, coloring):
    """jac(x (B, n)) -> (B, n, n) for a BATCHED function of independent
    members fB(x (B, n)) -> (B, n), from one VJP a row color with the
    cotangent broadcast across the batch: J[b, out, in] = vjp of
    color(out) at [b, in], on the sparsity mask. The rows of a color must
    share no column: tridiag_coloring's colors (its pattern is symmetric)
    or two_phase_row_coloring's."""
    colors, V, mask = coloring
    colors_t = torch.as_tensor(colors)

    def jac(x):
        out, pull = vjp(fB, x)
        V_x = torch.as_tensor(V, dtype=x.dtype, device=x.device)
        rows = vmap(lambda v: pull(v.expand_as(out))[0])(V_x)  # (c, B, n_in)
        mask_x = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
        return rows[colors_t.to(x.device)].transpose(0, 1) * mask_x

    return jac


def row_colored_jacobian_from(rhs_flat, coloring):
    """jac(t, y, *args) -> (n, n) of one member by reverse mode
    (batched_row_colored_jacobian's rule)."""
    def jac(t, y, *args):
        jb = batched_row_colored_jacobian(
            lambda x: rhs_flat(t, x[0], *args)[None], coloring)
        return jb(y[None])[0]

    return jac


def colored_jacobian_from(rhs_flat, coloring):
    """jac(t, y, *args) -> (n, n) from an explicit (colors, V, mask)
    coloring (banded_coloring, tridiag_coloring, two_phase_coloring): one
    JVP per color, reconstructed
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
