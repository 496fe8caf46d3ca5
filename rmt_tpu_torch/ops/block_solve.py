# Exact solves for block-structured method-of-lines systems (port of
# rmt_tpu/ops/block_solve.py: block extraction, small batched inverses,
# the bidiagonal recurrence and the block-tridiagonal cyclic reduction).
#
# The backward-difference MoL Jacobian couples node z only to {z, z-1}, so
# a dense (n, n) Jacobian in the flat state layout v*z_no + z is fully
# described by its (var_no x var_no) diagonal and subdiagonal node blocks;
# central-difference dispersion adds the superdiagonal block (z+1). The
# lockstep integrator's bidiagonal block mode takes its blocks from a dense
# Jacobian with extract_bidiag_blocks and solves its stage systems with the
# block kernels of ops/cuda_block.py. Its tridiagonal block mode and the
# block modes of solvers/newton.py::root_batched solve with the plain
# PyTorch routines below, as rmt_tpu solves them with plain XLA (no Pallas
# kernel exists for them): block cyclic reduction, ceil(log2 z) levels of
# batched small inverses and matmuls, for the tridiagonal systems, and a
# loop over the nodes for the bidiagonal recurrence.
#
# Complex shifts (the Radau eigenvalue mu) run in the 2m x 2m real
# embedding [[Mr, -Mi], [Mi, Mr]] so one real routine serves both.

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


def extract_tridiag_blocks(J, var_no: int, z_no: int):
    """Diagonal, subdiagonal and superdiagonal blocks of a dense Jacobian.

    J: (B, n, n) with n = var_no*z_no, flat index v*z_no + z.
    Returns (Jd, Jl, Ju): (B, z_no, var_no, var_no); Jd[b, z] couples node
    z to itself, Jl[b, z] to node z-1 (Jl[b, 0] = 0), Ju[b, z] to node z+1
    (Ju[b, -1] = 0): the sparsity of MoL RHS functions with
    central-difference axial dispersion (the M13 gas phase,
    pbHeterReactor.py:1857-2160).
    """
    Jd, Jl = extract_bidiag_blocks(J, var_no, z_no)
    B = J.shape[0]
    J5 = J.reshape(B, var_no, z_no, var_no, z_no)
    Ju_sup = torch.diagonal(J5, offset=1, dim1=2, dim2=4).movedim(-1, 1)
    Ju = torch.cat([Ju_sup, torch.zeros_like(Ju_sup[:, :1])], dim=1)
    return Jd, Jl, Ju


def batched_inv(M):
    """Inverses of a batch of small matrices M (K, m, m) by LU with partial
    pivoting (torch.linalg.inv_ex: no error check, so no read by the host;
    a singular matrix gives non-finite entries)."""
    return torch.linalg.inv_ex(M)[0]


def solve_bidiag(Minv, C, r):
    """Solve the block recurrence x_z = Minv_z r_z + C_z x_{z-1}.

    Minv, C: (B, z, m, m); r: (B, z, m). C[:, 0] must be zero.
    Returns x: (B, z, m), node by node.
    """
    b0 = torch.einsum("bzij,bzj->bzi", Minv, r)
    xs = [b0[:, 0]]
    for z in range(1, r.shape[1]):
        xs.append(b0[:, z] + torch.einsum("bij,bj->bi", C[:, z], xs[-1]))
    return torch.stack(xs, dim=1)


def _mm(a, b):
    return torch.einsum("bzij,bzjk->bzik", a, b)


def _mv(a, v):
    return torch.einsum("bzij,bzj->bzi", a, v)


def _shift_down(X):
    """[0, X_0, ..., X_{n-2}] along axis 1 (slot j holds old slot j-1)."""
    return torch.cat([torch.zeros_like(X[:, :1]), X[:, :-1]], dim=1)


def tridiag_factor(D, L, U):
    """Block cyclic-reduction factorization of the block-tridiagonal
    system L_z x_{z-1} + D_z x_z + U_z x_{z+1} = r_z.

    D, L, U: (B, z, m, m); L[:, 0] and U[:, -1] must be zero. Returns an
    opaque factorization for tridiag_solve: ceil(log2 z) elimination
    levels, each one batch of (m x m) inversions and a few batched small
    matmuls, with no sequential recursion over z.
    """
    B, N0, m, _ = D.shape
    N = 1 << max(int(N0 - 1).bit_length(), 0)   # next power of two >= N0
    if N != N0:
        pad = N - N0
        eye = torch.eye(m, dtype=D.dtype, device=D.device).expand(
            B, pad, m, m)
        zer = torch.zeros((B, pad, m, m), dtype=D.dtype, device=D.device)
        # padded rows are decoupled identity equations with zero rhs
        D = torch.cat([D, eye], dim=1)
        L = torch.cat([L, zer], dim=1)
        U = torch.cat([U, zer], dim=1)

    levels = []
    while D.shape[1] > 1:
        half = D.shape[1] // 2
        De, Le, Ue = D[:, 0::2], L[:, 0::2], U[:, 0::2]
        Do, Lo, Uo = D[:, 1::2], L[:, 1::2], U[:, 1::2]
        Dinv_o = batched_inv(Do.reshape(-1, m, m)).reshape(B, half, m, m)
        # even row 2j eliminates odd neighbours 2j-1 (odd slot j-1, absent
        # for j=0 where Le[0]=L_0=0) and 2j+1 (odd slot j)
        Gl = _mm(Le, _shift_down(Dinv_o))
        Gr = _mm(Ue, Dinv_o)
        levels.append((Gl, Gr, Dinv_o, Lo, Uo))
        D = De - _mm(Gl, _shift_down(Uo)) - _mm(Gr, Lo)
        L = -_mm(Gl, _shift_down(Lo))
        U = -_mm(Gr, Uo)
    Dinv_top = batched_inv(D[:, 0])               # (B, m, m)
    return (N0, N, Dinv_top, tuple(levels))


def tridiag_solve(fac, r):
    """Solve with a tridiag_factor factorization. r: (B, z, m) -> x."""
    N0, N, Dinv_top, levels = fac
    B, _, m = r.shape
    if N != N0:
        r = torch.cat([r, torch.zeros((B, N - N0, m), dtype=r.dtype,
                                      device=r.device)], dim=1)
    # forward: reduce the rhs level by level (even rows absorb odd rows)
    rs = []
    for Gl, Gr, _, _, _ in levels:
        re, ro = r[:, 0::2], r[:, 1::2]
        rs.append(ro)
        r = re - _mv(Gl, _shift_down(ro)) - _mv(Gr, ro)
    x = torch.einsum("bij,bj->bi", Dinv_top, r[:, 0])[:, None]   # (B, 1, m)
    # backward: recover odd rows, interleave with the even solution
    for (Gl, Gr, Dinv_o, Lo, Uo), ro in zip(reversed(levels), reversed(rs)):
        x_e = x
        x_next = torch.cat([x_e[:, 1:], torch.zeros_like(x_e[:, :1])], dim=1)
        x_o = _mv(Dinv_o, ro - _mv(Lo, x_e) - _mv(Uo, x_next))
        half = x_e.shape[1]
        x = torch.stack([x_e, x_o], dim=2).reshape(B, 2 * half, m)
    return x[:, :N0]


def _embed(Br, Bi):
    """[[Br, -Bi], [Bi, Br]] over the last two axes."""
    return torch.cat([torch.cat([Br, -Bi], dim=-1),
                      torch.cat([Bi, Br], dim=-1)], dim=-2)


def make_shifted_solvers_tridiag(Jd, Jl, Ju, h, gamma, mu_r, mu_i,
                                 dtype=torch.float32):
    """Exact solvers for (I - h*gamma*J) and (I - h*mu*J) when J is block
    TRIdiagonal (axial-dispersion MoL coupling z-1, z, z+1), factored in
    ``dtype``.

    Jd, Jl, Ju: (B, z, m, m) blocks of J; h: (B,). Returns
    (solve_real, solve_cplx):
      solve_real(r)         r (B, z, m)      -> x (B, z, m)
      solve_cplx(rr, ri)    real/imag parts  -> (xr, xi)
    the complex shift in the 2m x 2m real embedding.
    """
    B, z_no, m, _ = Jd.shape
    hw = h.to(dtype)[:, None, None, None]
    eye = torch.eye(m, dtype=dtype, device=Jd.device)

    fac_r = tridiag_factor(eye - (gamma * hw) * Jd.to(dtype),
                           -(gamma * hw) * Jl.to(dtype),
                           -(gamma * hw) * Ju.to(dtype))

    def solve_real(r):
        return tridiag_solve(fac_r, r.to(dtype))

    def shifted2(Jx):
        Jx = Jx.to(dtype)
        return _embed(-(mu_r * hw) * Jx, -(mu_i * hw) * Jx)

    D2 = torch.eye(2 * m, dtype=dtype, device=Jd.device) + shifted2(Jd)
    fac_c = tridiag_factor(D2, shifted2(Jl), shifted2(Ju))

    def solve_cplx(rr, ri):
        x2 = tridiag_solve(fac_c, torch.cat([rr.to(dtype), ri.to(dtype)],
                                            dim=-1))
        return x2[..., :m], x2[..., m:]

    return solve_real, solve_cplx
