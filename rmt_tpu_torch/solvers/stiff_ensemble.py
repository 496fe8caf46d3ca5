# Batched lockstep stiff integrator: Radau IIA(5) with eigen-transformed
# stages (port of rmt_tpu/solvers/stiff_ensemble.py::odeint_ensemble, its
# Newton-Schulz mode and its bidiagonal and tridiagonal block modes).
#
# One global adaptive loop runs the whole ensemble with per-member step
# sizes and masked accept/reject. The 3-stage Radau coefficient matrix is
# diagonalised once, A = T diag(gamma, mu, mu*) T^-1, which splits the
# stacked Newton system (I - h A(x)J) dK = R into one real and one complex
# n x n system per member. Two ways to solve them:
#
#   * Newton-Schulz mode (block=None): float32 approximate inverses
#     Pr ~ (I - h*gamma*J)^-1 and Pcr + i Pci ~ (I - h*mu*J)^-1 ride in
#     the state and are kept warm by the fused kernel of ops/cuda_ns.py,
#     ns_step iterations per attempt and ns_refresh after each Jacobian
#     refresh; a residual certificate rho < 0.5 guards every accepted
#     step. Applying them to a stage residual is five matvecs, left to
#     torch.matmul as the reference leaves them to XLA.
#   * block mode (block=(m, z)): the method-of-lines Jacobian is block
#     lower bidiagonal in the axial node, so both systems are solved
#     exactly by the block kernels of ops/cuda_block.py: block_factor once
#     per attempt, block_apply once per Newton sweep, block_apply_real
#     once per attempt for the error estimate. The blocks come from
#     jac_blocks, or are extracted from a dense jac
#     (ops/block_solve.extract_bidiag_blocks).
#   * tridiagonal block mode (block=(m, z, "tridiag")): central-difference
#     dispersion couples z-1, z and z+1 (the M13 gas phase). The three
#     float32 blocks are extracted from the dense jac at each refresh, and
#     both systems are factored by block cyclic reduction at each
#     attempt's h and solved exactly through the eigen-transform
#     (ops/block_solve.make_shifted_solvers_tridiag), in plain PyTorch on
#     any device: rmt_tpu has no Pallas kernel for this mode either.
#
# The Jacobian is refreshed once per chunk of j_every attempts. Without a
# jac (and, in block mode, without jac_blocks), it is the dense Jacobian
# of the batched f by forward-mode JVPs, one tangent column per state
# entry.
#
# Output: by default every step is clamped onto the next output boundary
# and the boundary state is the accepted one. With dense_output=True the
# steps stop only at ts[-1], a step may cross several boundaries, and each
# crossed boundary's state comes from the Radau collocation interpolant
# y(t + theta*h) = y + h * sum_i L_i(theta) K_i (scipy's dense output).
#
# jax.lax.scan becomes a Python loop with one device-to-host read per
# chunk of attempts, never one per attempt: the early-exit test (every
# member finished) and, in Newton-Schulz mode, the cold-rescue test of
# the refresh travel in the same transfer. Over a dp mesh
# (parallel/mesh.py) that read carries both flags OR-ed over the ranks,
# as rmt_tpu's one XLA program decides them for the whole batch: every
# rank runs the same chunks and the same rescues, so n_jev and n_rescue
# are the unsharded run's.
#
# The reference's tuning arguments are all here (rhs_noise, max_factor,
# predict_stages, theta_target, newton_h_barrier), with its off-TPU
# defaults, and f is either batched (batched=True) or one member's RHS
# mapped with torch.func.vmap (batched=False, the default, as in
# rmt_tpu). Left out: use_pallas. On the card the kernels are the route,
# and a switch to their plain twins there would be a fallback.

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_block, cuda_ns
from ..ops.block_solve import (extract_bidiag_blocks, extract_tridiag_blocks,
                               make_shifted_solvers_tridiag)
from .radau import extrap_weights, radau_tableau

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 1.4
_ORDER_EXP = -0.25         # embedded estimate is order 3 -> exponent 1/4
_NEWTON_TOL = 0.03
_STATE_NOISE_MULT = 2.0    # eps*|y| through J and the solve (~1/gamma)

_f32 = torch.float32


def _transformed_tableau():
    """Radau5 tableau + eigen-decomposition A = T diag(gamma, mu, mu*) T^-1
    with row/col 0 the real eigenpair and col 2 the conjugate of col 1."""
    c, A, b, bhat = radau_tableau(3)
    w, V = np.linalg.eig(A)
    i_real = int(np.argmin(np.abs(w.imag)))
    i_cplx = [i for i in range(3) if i != i_real]
    if w[i_cplx[0]].imag < 0:
        i_cplx = [i_cplx[1], i_cplx[0]]
    order = [i_real, i_cplx[0], i_cplx[1]]
    w = w[order]
    V = V[:, order]
    V[:, 0] = V[:, 0].real / np.linalg.norm(V[:, 0].real)
    V[:, 2] = V[:, 1].conj()
    Vinv = np.linalg.inv(V)
    if not np.allclose(V @ np.diag(w) @ Vinv, A, atol=1e-12):
        raise RuntimeError("Radau eigen-decomposition failed")
    return c, A, b, bhat, w, V, Vinv


def _dense_weights(c):
    """Integrated Lagrange basis at the collocation nodes c:
    L_i(theta) = int_0^theta prod_{j!=i} (tau - c_j) / (c_i - c_j) dtau,
    a cubic with zero constant term; row i holds its coefficients of
    theta^3, theta^2 and theta. L(1) == b, so the boundary a step lands on
    reproduces the accepted state."""
    dw = np.zeros((3, 3))
    for i in range(3):
        li = np.poly1d([1.0])
        for j in range(3):
            if j != i:
                li = li * np.poly1d([1.0, -c[j]]) / (c[i] - c[j])
        dw[i, :] = np.polyint(li).coeffs[:3]
    return dw


def batched_jacobian(f, t, y):
    """Dense Jacobian (B, n, n) of a batched f(t (B,), y (B, n)) at y:
    one forward-mode JVP a state entry, the n tangents mapped in one
    call (the reference's batched jacfwd)."""
    Bsz, n = y.shape
    eye = torch.eye(n, dtype=y.dtype, device=y.device)

    def column(e):
        return torch.func.jvp(lambda yy: f(t, yy), (y,),
                              (e.expand(Bsz, n),))[1]

    return torch.func.vmap(column)(eye).permute(1, 2, 0)   # (B, out, in)


class EnsembleStats(NamedTuple):
    n_fev: torch.Tensor       # (B,) RHS evals (stage evals counted singly)
    n_jev: int                # global Jacobian refreshes
    n_accepted: torch.Tensor  # (B,)
    n_rejected: torch.Tensor  # (B,)
    seg: torch.Tensor         # (B,) final output-segment pointer; a member
                              # finished iff seg == len(ts) - 1
    n_rej_conv: torch.Tensor  # (B,) rejections: Newton did not converge
    n_rej_err: torch.Tensor   # (B,) rejections: error estimate > 1
    n_rej_rho: torch.Tensor   # (B,) rejections: converged but uncertified
                              # (Newton-Schulz residual >= 0.5, or a
                              # non-finite Newton residual)
    n_rescue: int = 0         # Newton-Schulz refreshes that re-seeded some
                              # member from the cold start


def _norm_b(v, scale):
    return torch.sqrt(torch.mean((v / scale) ** 2, dim=-1))


def _finite_or(x, fill):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, fill))


def odeint_ensemble(f, y0, ts, *, jac=None, jac_blocks=None, block=None,
                    rtol=1e-7, atol=1e-10, max_steps: int = 1024,
                    newton_iters: int = 6, j_every: int = 16,
                    ns_refresh: int = 5, ns_step: int = 1, f_cheap=None,
                    cheap_sweeps: int = 0, f_stages=None,
                    f_cheap_stages=None, out_members=None,
                    dense_output: bool = False, batched: bool = False,
                    args=None, rhs_noise: float | None = None,
                    max_factor: float | None = None,
                    predict_stages: bool = True,
                    theta_target: float | None = None,
                    newton_h_barrier: bool = False, mesh=None):
    """Integrate a stiff ensemble dy/dt = f(t, y, *args) for every member.

    batched=True: f(t (B,), y (B, n)) -> (B, n) (and jac, f_cheap, if
    given) already take the whole batch. batched=False (the default, as
    in rmt_tpu): f is one member's RHS, f(t (), y (n,)) -> (n,), mapped
    over members with torch.func.vmap; its default Jacobian maps
    torch.func.jacfwd over members, and a given jac(t, y) -> (n, n) is
    mapped the same way. args (a tuple) is passed to f and f_cheap after
    y; f_stages, f_cheap_stages, jac and jac_blocks take none.

    Newton-Schulz mode (block=None): jac(t, y) -> (B, n, n) is the
    batched dense Jacobian (default: forward-mode JVPs of f,
    batched_jacobian); the float32 preconditioners get ns_refresh
    iterations after each Jacobian refresh and ns_step per attempt.

    Block mode (block = (var_no, z_no), the flat state layout
    v*z_no + z): jac_blocks(t, y) -> (Jd, Jl), each
    (B, z_no, var_no, var_no), the block-bidiagonal Jacobian; or, without
    jac_blocks, the dense jac (default: batched_jacobian), whose blocks
    are extracted at each refresh and whose row sums set the first step.
    block = (var_no, z_no, "tridiag"): a block-TRIdiagonal Jacobian,
    always from the dense jac (jac_blocks is not read).

    f_stages / f_cheap_stages: optional all-stages evaluators
    (ts (B, 3), Y (B, 3, n)) -> (B, 3, n); the fused RHS kernel provides
    one over the stage-stacked 3B batch.

    f_cheap + cheap_sweeps: the first cheap_sweeps Newton sweeps of each
    attempt use f_cheap; the rest use f, with the per-member done flags
    reset at the switch so convergence is judged on accurate increments.

    dense_output=True: steps stop only at ts[-1], and the state at each
    output boundary a step crosses comes from the collocation
    interpolant (carrying an error of about rtol) instead of a step
    clamped onto it. Worth it where the output grid is fine next to the
    natural steps (N1's 101 points).

    Tuning (rmt_tpu's arguments, its off-TPU defaults): rhs_noise, the
    relative evaluation noise of f that floors the Newton test (None:
    2e-6 for float32 states, 1e-14 for float64); max_factor, the step
    growth cap (None: 3.0 in block mode with float64 states, else 1.4);
    predict_stages=False starts Newton from f(y) on every stage instead
    of the previous step's collocation polynomial; theta_target caps the
    growth of an accepted step at theta_target / theta, theta the
    measured contraction rate of its simplified Newton iteration
    (Radau5's FACCON); newton_h_barrier=True caps regrowth below 0.8
    times the step of a member's last Newton failure, until the next
    Jacobian refresh lifts the cap.

    mesh (parallel.mesh.Mesh): y0 holds this rank's members of a batch
    sharded over a dp mesh; the chunk's early-exit and cold-rescue flags
    are OR-ed over the ranks in its one host read, so every rank runs the
    chunks and rescues of the whole batch (each member's result is the
    one the unsharded run gives it; n_jev and n_rescue are the whole
    batch's). The results stay this rank's.

    Returns (ys, stats) with ys (n_out, B, n), ys[0] == y0. With
    out_members (host int indices (P,)) only those members' trajectories
    are recorded and the return is (ys_sel (n_out, P, n), y_final (B, n),
    stats).
    """
    Bsz, n = y0.shape
    dtype, dev = y0.dtype, y0.device
    if args is not None:
        f_user, fc_user = f, f_cheap
        f = lambda t, y: f_user(t, y, *args)
        if fc_user is not None:
            f_cheap = lambda t, y: fc_user(t, y, *args)
    if not batched:
        if jac is None and jac_blocks is None:
            jac = torch.func.vmap(torch.func.jacfwd(f, argnums=1))
        elif jac is not None:
            jac = torch.func.vmap(jac)
        f = torch.func.vmap(f)
        if f_cheap is not None:
            f_cheap = torch.func.vmap(f_cheap)
    tridiag = block is not None and len(block) > 2 and block[2] == "tridiag"
    if block is not None:
        var_no, z_no = block[0], block[1]
        if var_no * z_no != n:
            raise ValueError(
                f"block {block} does not tile the state size {n}")
    if tridiag:
        jac_blocks = None
    if jac is None and jac_blocks is None:
        def jac(t, y):
            return batched_jacobian(f, t, y)
    if out_members is not None:
        out_idx = torch.as_tensor(np.asarray(out_members, np.int64),
                                  device=dev)
        n_rec = int(out_idx.shape[0])
    else:
        out_idx, n_rec = None, Bsz
    # relative evaluation noise of f: the floor of the Newton test
    if rhs_noise is None:
        rhs_noise = 2e-6 if dtype == _f32 else 1e-14
    # the Newton-Schulz warm start needs small h drift, and so does f32
    # block mode: the exact solve still carries eps32-level noise and
    # aggressive growth feeds Newton failures
    if max_factor is not None:
        max_fac = float(max_factor)
    else:
        max_fac = 3.0 if (block is not None and dtype != _f32) else \
            _MAX_FACTOR
    eps_dt = torch.finfo(dtype).eps

    c_np, A_np, b_np, bhat_np, w_np, T_np, Tinv_np = _transformed_tableau()

    def cst(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    C, A, Bv, BHAT = cst(c_np), cst(A_np), cst(b_np), cst(bhat_np)
    Ainv = cst(np.linalg.inv(A_np))
    DW = cst(_dense_weights(c_np)) if dense_output else None
    gamma = float(w_np[0].real)
    mu_r, mu_i = float(w_np[1].real), float(w_np[1].imag)
    coef = cuda_block.apply_coefficients(gamma, mu_r, mu_i, T_np, Tinv_np)
    Tr, Ti = cst(T_np.real), cst(T_np.imag)
    Tir, Tii = cst(Tinv_np.real), cst(Tinv_np.imag)
    ns_kw = dict(gamma=gamma, mu_r=mu_r, mu_i=mu_i)
    # kernel steps on the card alternate between two sets of buffers made
    # once; the CPU twin allocates its results
    ns_ws = (cuda_ns.Workspace(Bsz, n, dev)
             if block is None and dev.type == "cuda" else None)
    n_out = ts.shape[0]
    cheap_n = (min(int(cheap_sweeps), newton_iters - 1)
               if (f_cheap is not None and cheap_sweeps) else 0)

    def stage_eval(fB, fS, t, h, Y):
        ts_st = t[:, None] + C[None, :] * h[:, None]          # (B, 3)
        if fS is not None:
            return fS(ts_st, Y)
        return torch.stack([fB(ts_st[:, i], Y[:, i]) for i in range(3)],
                           dim=1)

    def predict_K(Kp, hp, h_new, f0):
        """Stage guess from the previous accepted step's collocation
        polynomial (RADAU5's starting values by extrapolation)."""
        r = torch.clamp(h_new / torch.clamp(hp, min=1e-300), 0.0, 4.0)
        W = extrap_weights(c_np, r).to(dtype)                  # (B, 3, 3)
        Z = hp[:, None, None] * torch.einsum("ij,bjn->bin", A, Kp)
        Zg = torch.einsum("bij,bjn->bin", W, Z) - Z[:, 2:3, :]
        Kg = torch.einsum("ij,bjn->bin", Ainv, Zg) / h_new[:, None, None]
        return _finite_or(Kg, 0.0)

    def to_member_last(J):          # (B, z, m, m) -> (z, m, m, B) f32
        return J.to(_f32).permute(1, 2, 3, 0).contiguous()

    def stage_solvers(h_eff, Jd_t, Jl_t):
        """Factor once for this attempt's h; return the stage solve
        R (B, 3, n) -> dK and the error smoothing e (B, n) -> x."""
        h32 = h_eff.to(_f32).contiguous()
        MinvR, MinvCr, MinvCi = cuda_block.block_factor(
            Jd_t, h32, gamma=gamma, mu_r=mu_r, mu_i=mu_i)

        def solve_stages(R):
            R_t = R.to(_f32).reshape(Bsz, 3, var_no, z_no).permute(
                1, 2, 3, 0).contiguous()
            dK_t = cuda_block.block_apply(R_t, MinvR, MinvCr, MinvCi, Jl_t,
                                          h32, coef=coef)
            return dK_t.permute(3, 0, 1, 2).reshape(Bsz, 3, n).to(dtype)

        def solve_err(e32):
            e_t = e32.reshape(Bsz, var_no, z_no).permute(1, 2, 0).contiguous()
            x_t = cuda_block.block_apply_real(e_t, MinvR, Jl_t, h32,
                                              gamma=gamma)
            return x_t.permute(2, 0, 1).reshape(Bsz, n).to(dtype)

        return solve_stages, solve_err

    def to_blocks(x):               # (B, n) flat v*z -> (B, z, m)
        return x.reshape(Bsz, var_no, z_no).transpose(1, 2)

    def from_blocks(xb):            # (B, z, m) -> (B, n)
        return xb.transpose(1, 2).reshape(Bsz, n)

    def tridiag_solvers(h_eff, Jd, Jl, Ju):
        """Factor the tridiagonal blocks (B, z, m, m) once for this
        attempt's h; return the stage solve and the error smoothing with
        stage_solvers' signatures."""
        solve_real, solve_cplx = make_shifted_solvers_tridiag(
            Jd, Jl, Ju, h_eff, gamma, mu_r, mu_i)

        def solve_stages(R):
            # W = T^-1 R (row 0 is real and row 2 = conj(row 1))
            Wr = torch.einsum("ij,bjn->bin", Tir, R)
            Wi = torch.einsum("ij,bjn->bin", Tii, R)
            z0 = from_blocks(solve_real(to_blocks(Wr[:, 0].to(_f32))))
            z1r, z1i = solve_cplx(to_blocks(Wr[:, 1].to(_f32)),
                                  to_blocks(Wi[:, 1].to(_f32)))
            Z1r, Z1i = from_blocks(z1r), from_blocks(z1i)
            Zr = torch.stack([z0, Z1r, Z1r], dim=1).to(dtype)
            Zi = torch.stack([torch.zeros_like(z0), Z1i, -Z1i],
                             dim=1).to(dtype)
            return (torch.einsum("ij,bjn->bin", Tr, Zr)
                    - torch.einsum("ij,bjn->bin", Ti, Zi))

        def solve_err(e32):
            return from_blocks(solve_real(to_blocks(e32))).to(dtype)

        return solve_stages, solve_err

    def ns_update(P, h, J, k, workspace=None):
        """k Newton-Schulz iterations toward (I - h*gamma*J)^-1 and
        (I - h*mu*J)^-1, and rho, a bound on the residual
        ||I - M P||_F / sqrt(n) of the RESULT: by the identity
        I - M P' = (I - M P)^2 it is the square of the last pre-update
        residual where that is below 1, else inf."""
        h32 = h.to(_f32).contiguous()
        P = tuple(p.contiguous() for p in P)
        for _ in range(k):
            *P, rho_pre = cuda_ns.ns_fused_step(J, *P, h32, **ns_kw,
                                                workspace=workspace)
        inf = torch.full_like(rho_pre, float("inf"))
        rho = torch.where(rho_pre < 1.0, rho_pre ** 2, inf)
        return tuple(P), torch.where(torch.isfinite(rho), rho, inf)

    def matvec(M, v):
        return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)

    def ns_solvers(h_eff, J, P):
        """The preconditioners' stage solve R (B, 3, n) -> dK and error
        smoothing e (B, n) -> x, with block mode's signatures."""
        Pr, Pcr, Pci = P

        def solve_stages(R):
            # W = T^-1 R (row 0 is real and row 2 = conj(row 1))
            R32r = torch.einsum("ij,bjn->bin", Tir, R).to(_f32)
            R32i = torch.einsum("ij,bjn->bin", Tii, R).to(_f32)
            # five matvecs without stacking the matrices: the complex
            # one, (Pcr + i Pci)(xr + i xi), as two (n x 2)-wide products
            Z0 = matvec(Pr, R32r[:, 0])
            X = torch.stack([R32r[:, 1], R32i[:, 1]], dim=-1)   # (B, n, 2)
            Yr = torch.matmul(Pcr, X)
            Yi = torch.matmul(Pci, X)
            Z1r = Yr[..., 0] - Yi[..., 1]
            Z1i = Yi[..., 0] + Yr[..., 1]
            # stage 2 = conj(stage 1); dK = Re(T Z)
            Zr = torch.stack([Z0, Z1r, Z1r], dim=1).to(dtype)
            Zi = torch.stack([torch.zeros_like(Z0), Z1i, -Z1i],
                             dim=1).to(dtype)
            return (torch.einsum("ij,bjn->bin", Tr, Zr)
                    - torch.einsum("ij,bjn->bin", Ti, Zi))

        def solve_err(e32):
            # Pr e with one refinement through J
            x = matvec(Pr, e32)
            g32 = (gamma * h_eff.to(_f32))[:, None]
            r_e = e32 - (x - g32 * matvec(J, x))
            return (x + matvec(Pr, r_e)).to(dtype)

        return solve_stages, solve_err

    def newton_sweeps(k, fB, fS, carry, t, y, h_eff, scale3, state_floor,
                      solve_stages):
        """k masked simplified-Newton sweeps; carry (K, done, rn, dn,
        theta): dn the last increment of a member still iterating and
        theta its contraction rate (only kept with theta_target)."""
        K, done, rn, dn, theta = carry
        hcol = h_eff[:, None]
        for _ in range(k):
            Y = y[:, None, :] + h_eff[:, None, None] * torch.einsum(
                "ij,bjn->bin", A, K)
            R = stage_eval(fB, fS, t, h_eff, Y) - K
            rn_new = _finite_or(_norm_b(hcol * R.reshape(Bsz, -1), scale3),
                                float("inf"))
            dK = solve_stages(R)
            K_new = K + torch.where(done[:, None, None],
                                    torch.zeros_like(dK), dK)
            # convergence measured on the stage-value increment h*dK
            dn_new = _finite_or(
                _norm_b(hcol * dK.reshape(Bsz, -1), scale3), float("inf"))
            floor = rhs_noise * _norm_b(hcol * K.reshape(Bsz, -1), scale3)
            tol_eff = torch.clamp(3.0 * floor + state_floor, min=_NEWTON_TOL)
            rn = torch.where(done, rn, rn_new)
            done_new = done | (dn_new < tol_eff)
            if theta_target is not None:
                # only ratios of pre-convergence increments count: the
                # converging sweep's increment sits at the tolerance or
                # noise plateau
                ratio = dn_new / torch.clamp(dn, min=1e-300)
                theta = torch.where(done | done_new | ~torch.isfinite(dn),
                                    theta, ratio)
                dn = torch.where(done, dn, dn_new)
            done = done_new
            K = K_new
        return K, done, rn, dn, theta

    def dense_record(out, seg, t, t_new, h_eff, y, K, accept):
        """Interpolated states at the boundaries this step crossed, and
        the advanced pointer. The boundaries are shifted down by a few
        ulps, so the last step (t_new == ts[-1] to within ulps) counts its
        boundary, and the crossing is strict on the shifted value, so each
        boundary counts exactly once (t moves through disjoint (t, t_new]
        spans)."""
        eps_f = 8 * eps_dt * torch.clamp(torch.abs(ts[-1]), min=1.0)
        tsb = ts[1:] - eps_f                                     # (n_out-1,)
        m_cross = ((tsb[:, None] > t[None, :])
                   & (tsb[:, None] <= t_new[None, :])
                   & accept[None, :])                           # (n_out-1, B)
        if out_idx is None:
            t_r, h_r, y_r, K_r, m_r = t, h_eff, y, K, m_cross
        else:
            t_r, h_r, y_r, K_r = t[out_idx], h_eff[out_idx], y[out_idx], \
                K[out_idx]
            m_r = m_cross[:, out_idx]
        th = torch.clamp((ts[1:, None] - t_r[None, :]) / h_r[None, :], 0.0,
                         1.0)[:, :, None]                       # (n_out-1, P, 1)
        w = ((DW[:, 0] * th + DW[:, 1]) * th + DW[:, 2]) * th   # (n_out-1, P, 3)
        y_d = y_r[None] + h_r[None, :, None] * torch.einsum(
            "jps,psn->jpn", w, K_r)
        out = torch.where(m_r[:, :, None], y_d, out)
        return out, seg + torch.sum(m_cross, dim=0).to(seg.dtype)

    def attempt(s, *blocks):
        """One masked step attempt of every member. Block mode takes the
        chunk's Jacobian blocks (member-last (Jd, Jl); tridiagonal mode
        member-first (Jd, Jl, Ju)); Newton-Schulz mode reads the dense
        Jacobian s["J"] and the preconditioners s["P"]."""
        t, y, yc, fval, h = s["t"], s["y"], s["yc"], s["f"], s["h"]
        seg = s["seg"]
        seg_c = torch.clamp(seg + 1, max=n_out - 1)
        # dense mode: steps stop only at the final time; clamped mode: at
        # the next unwritten output boundary
        t_end = ts[-1].expand(Bsz) if dense_output else ts[seg_c]  # (B,)
        active = seg < (n_out - 1)
        h_eff = torch.where(active, torch.minimum(h, t_end - t), h)
        h_eff = torch.clamp(h_eff, min=1e-300)
        if block is not None:
            solve_stages, solve_err = (tridiag_solvers if tridiag
                                       else stage_solvers)(h_eff, *blocks)
            P, certified = None, None
        else:
            # warm preconditioner maintenance every attempt (h drifts by
            # at most 1.4x)
            P, rho = ns_update(s["P"], h_eff, s["J"], ns_step, ns_ws)
            solve_stages, solve_err = ns_solvers(h_eff, s["J"], P)
            # certify the linear solves: a silently bad preconditioner
            # makes Newton increments tiny while the system stays unsolved
            certified = rho < 0.5

        scale = atol + rtol * torch.abs(y)
        scale3 = scale.repeat(1, 3) * np.sqrt(3.0)
        # f32 state-representation noise floor of the Newton increment
        state_floor = _STATE_NOISE_MULT * eps_dt * _norm_b(y, scale)

        f0 = fval
        K = f0[:, None, :].expand(Bsz, 3, n)
        if predict_stages:
            K = torch.where(s["pv"][:, None, None],
                            predict_K(s["Kp"], s["hp"], h_eff, f0), K)
        not_done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        inf_b = torch.full((Bsz,), float("inf"), dtype=dtype, device=dev)
        theta0 = (torch.zeros_like(inf_b) if theta_target is not None
                  else inf_b)
        carry = (K, not_done, inf_b, inf_b, theta0)
        sweep_args = (t, y, h_eff, scale3, state_floor, solve_stages)
        if cheap_n > 0:
            # cheap sweeps first, then reset done so every member is
            # judged on accurate increments; dn too, so no cheap-against-
            # accurate ratio enters theta
            Kc, _, rnc, _, thc = newton_sweeps(cheap_n, f_cheap,
                                               f_cheap_stages, carry,
                                               *sweep_args)
            carry = (Kc, not_done, rnc, inf_b, thc)
        K, conv, res_n, _, theta_n = newton_sweeps(
            newton_iters - cheap_n, f, f_stages, carry, *sweep_args)
        newton_done = conv
        conv = conv & torch.isfinite(res_n)
        if certified is not None:
            conv = conv & certified

        bK = torch.einsum("j,bjn->bn", Bv, K)
        y1 = y + h_eff[:, None] * bK
        # embedded error estimate smoothed by (I - h*gamma*J)^-1 (f32)
        err_raw = h_eff[:, None] * (
            torch.einsum("j,bjn->bn", Bv - BHAT[1:], K) - BHAT[0] * f0)
        err_s = solve_err(err_raw.to(_f32))
        scale2 = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        err_norm = _finite_or(_norm_b(err_s, scale2), float("inf"))
        err_norm = torch.where(conv, err_norm,
                               torch.full_like(err_norm, float("inf")))

        accept = (err_norm <= 1.0) & active
        err_c = torch.clamp(err_norm, 1e-10, 1e10)
        factor = torch.clamp(_SAFETY * err_c ** _ORDER_EXP, _MIN_FACTOR,
                             max_fac)
        if theta_target is not None:
            # Newton-rate-keyed growth cap (growth only; members with no
            # rate measured get none)
            fac_con = torch.where(
                theta_n > 1e-8,
                theta_target / torch.clamp(theta_n, min=1e-8),
                torch.full_like(theta_n, float("inf")))
            factor = torch.minimum(factor,
                                   torch.clamp(fac_con, 1.0, max_fac))
        factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))
        factor = torch.where(conv, factor, torch.full_like(factor, 0.5))
        clamped = h_eff < h
        h_new = torch.where(accept & clamped,
                            torch.maximum(h, h_eff * factor), h_eff * factor)
        hbar = s["hbar"]
        if newton_h_barrier:
            # remember the failed step size; regrowth stays below it until
            # the next Jacobian refresh
            hbar = torch.where(active & ~conv,
                               torch.minimum(hbar, 0.8 * h_eff), hbar)
            h_new = torch.minimum(h_new, hbar)
        h_new = torch.where(active, h_new, h)

        t_new = torch.where(accept, t + h_eff, t)
        # Kahan-compensated state accumulation: the compensation carries
        # the low-order bits each f32 step would otherwise lose
        acc2 = accept[:, None]
        u = h_eff[:, None] * bK + yc
        y1k = y + u
        yc1 = u - (y1k - y)
        y_new = torch.where(acc2, y1k, y)
        yc_new = torch.where(acc2, yc1, yc)
        # fval only seeds the next start and the error estimate, so in
        # hybrid mode the cheap RHS suffices
        f_cand = (f_cheap if cheap_n > 0 else f)(t_new, y_new)
        f_new = torch.where(acc2, f_cand, fval)

        if dense_output:
            out, seg_new = dense_record(s["out"], seg, t, t_new, h_eff, y, K,
                                        accept)
        else:
            # boundary crossing: record the state, advance the pointer
            eps_t = 8 * eps_dt * torch.clamp(torch.abs(t_end), min=1.0)
            crossed = accept & (t_new >= t_end - eps_t)
            if out_idx is None:
                seg_r, crossed_r, y_r = seg_c, crossed, y_new
            else:
                seg_r, crossed_r, y_r = (seg_c[out_idx], crossed[out_idx],
                                         y_new[out_idx])
            onehot = (torch.arange(1, n_out, device=dev)[:, None]
                      == seg_r[None, :]) & crossed_r[None, :]
            out = torch.where(onehot[:, :, None], y_r[None, :, :], s["out"])
            seg_new = seg + crossed.to(seg.dtype)

        rejected = (~accept) & active
        st = s["stats"]
        i32 = lambda m: m.to(torch.int32)
        st = st._replace(
            n_fev=st.n_fev + i32(active) * (3 * newton_iters + 1),
            n_accepted=st.n_accepted + i32(accept),
            n_rejected=st.n_rejected + i32(rejected),
            seg=seg_new,
            n_rej_conv=st.n_rej_conv + i32(rejected & ~newton_done),
            n_rej_err=st.n_rej_err + i32(rejected & conv),
            n_rej_rho=st.n_rej_rho + i32(rejected & newton_done & ~conv),
        )
        return dict(
            t=t_new, y=y_new, yc=yc_new, f=f_new, h=h_new, seg=seg_new,
            out=out, stats=st, J=s["J"], P=P, hbar=hbar,
            # predictor state: the last ACCEPTED step's stages and size
            Kp=torch.where(accept[:, None, None], K, s["Kp"]),
            hp=torch.where(accept, h_eff, s["hp"]),
            pv=s["pv"] | accept,
        )

    # --- initialization ---
    t0 = torch.full((Bsz,), float(ts[0]), dtype=dtype, device=dev)
    f0 = f(t0, y0)
    span = ts[-1] - ts[0]
    # first step: ||h*gamma*J|| << 1 (so P0 = I is a valid Newton-Schulz
    # seed), from the row sums of J
    if block is not None and jac_blocks is not None:
        Jd0, Jl0 = (J.to(_f32) for J in jac_blocks(t0, y0))
        # the block row sums are the dense row sums of the bidiagonal J
        row_sums = torch.sum(torch.abs(Jd0), dim=-1) + torch.sum(
            torch.abs(Jl0), dim=-1)                             # (B, z, m)
        j_norm = torch.amax(row_sums, dim=(-1, -2)).to(dtype)
        J0 = P0 = None
    else:
        J0 = jac(t0, y0).to(_f32).contiguous()
        j_norm = torch.amax(torch.sum(torch.abs(J0), dim=-1),
                            dim=-1).to(dtype)
        if block is None:
            eyeB = torch.eye(n, dtype=_f32, device=dev).expand(
                Bsz, n, n).contiguous()
            P0 = (eyeB, eyeB.clone(), torch.zeros_like(eyeB))
        else:
            # block mode carries no dense J: the first chunk refreshes
            J0 = P0 = None
    h0 = torch.clamp(0.05 / (abs(gamma) * j_norm + 1e-30), max=1e-3 * span)

    zero_b = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    s = dict(
        t=t0, y=y0, yc=torch.zeros_like(y0), f=f0, h=h0, seg=zero_b.clone(),
        out=torch.zeros((n_out - 1, n_rec, n), dtype=dtype, device=dev),
        stats=EnsembleStats(zero_b + 1, 1, zero_b, zero_b, zero_b, zero_b,
                            zero_b, zero_b),
        Kp=f0[:, None, :].expand(Bsz, 3, n),
        hp=torch.ones(Bsz, dtype=dtype, device=dev),
        pv=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        J=J0, P=P0, hbar=None,
    )

    def alive(s):
        return torch.any(s["seg"] < n_out - 1)

    def read_flags(*flags):
        """The chunk's one host read of its flags, OR-ed over the mesh's
        ranks."""
        v = torch.stack(flags)
        if mesh is None:
            return v.tolist()
        from ..parallel.mesh import any_across

        return any_across(mesh, v)

    def ns_refresh_chunk(s):
        """Fresh dense Jacobian and re-converged preconditioners for the
        next chunk. Returns (J, P, rescued) or None once every member has
        finished. Its one host read carries two flags: whether any member
        is still integrating, and whether any needs the cold rescue. The
        refresh is queued before the read, so the card works through it
        while the host waits; at the early exit that refresh is dropped."""
        J = jac(s["t"], s["y"]).to(_f32).contiguous()
        # reset any non-finite preconditioner to the safe cold seed
        cold = cuda_ns.ns_cold_start(J, s["h"].to(_f32), **ns_kw)
        bad = ~(torch.isfinite(s["P"][0]) & torch.isfinite(s["P"][1])
                & torch.isfinite(s["P"][2])).all(dim=-1).all(dim=-1)
        P = tuple(torch.where(bad[:, None, None], c, p)
                  for c, p in zip(cold, s["P"]))
        P, rho_w = ns_update(P, s["h"], J, ns_refresh, ns_ws)
        # a Newton-Schulz iterate outside its basin squares AWAY from the
        # inverse while staying finite, and the warm chain never recovers
        # at a later refresh: members whose certified residual says the
        # refresh failed are redone from the cold seed
        need = ~(rho_w < 0.5)
        go, rescue = read_flags(alive(s), torch.any(need))
        if not go:
            return None
        if rescue:
            # rare: these steps allocate their own buffers, the warm
            # result lives in the workspace
            Pc, _ = ns_update(cold, s["h"], J, ns_refresh)
            P = tuple(torch.where(need[:, None, None], c, p)
                      for c, p in zip(Pc, P))
        return J, P, bool(rescue)

    n_chunks = max(max_steps // j_every, 1)
    for _ in range(n_chunks):
        # a fresh Jacobian lifts the Newton-failure barrier
        if newton_h_barrier:
            s["hbar"] = torch.full((Bsz,), float("inf"), dtype=dtype,
                                   device=dev)
        # early exit once every member has written its last segment
        st = s["stats"]
        if block is not None:
            if not read_flags(alive(s))[0]:
                break
            # refresh the Jacobian blocks once per chunk (bidiagonal:
            # member-last for the block kernels)
            if tridiag:
                lin = extract_tridiag_blocks(
                    jac(s["t"], s["y"]).to(_f32), var_no, z_no)
            else:
                if jac_blocks is not None:
                    Jd, Jl = jac_blocks(s["t"], s["y"])
                else:
                    Jd, Jl = extract_bidiag_blocks(
                        jac(s["t"], s["y"]).to(_f32), var_no, z_no)
                lin = (to_member_last(Jd), to_member_last(Jl))
        else:
            fresh = ns_refresh_chunk(s)
            if fresh is None:
                break
            s["J"], s["P"], rescued = fresh
            st = st._replace(n_rescue=st.n_rescue + int(rescued))
            lin = ()
        s["stats"] = st._replace(n_jev=st.n_jev + 1)
        for _ in range(j_every):
            s = attempt(s, *lin)

    y_fin, out, stats = s["y"], s["out"], s["stats"]
    # members that exhausted the budget keep their final state in the
    # remaining output slots (detectable through stats.seg)
    y_tail = y_fin if out_idx is None else y_fin[out_idx]
    seg_tail = stats.seg if out_idx is None else stats.seg[out_idx]
    tail = torch.arange(1, n_out, device=dev)[:, None] > seg_tail[None, :]
    out = torch.where(tail[:, :, None], y_tail[None, :, :], out)
    y0_head = y0 if out_idx is None else y0[out_idx]
    ys = torch.cat([y0_head[None], out], dim=0)
    if out_idx is not None:
        return ys, y_fin, stats
    return ys, stats
