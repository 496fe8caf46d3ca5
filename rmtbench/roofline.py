"""The work a lockstep sweep needs, in bytes and float32 operations, and the
least time an H100 could take for it.

The counts per member and call are chip_smoke.py's kernel-table
arithmetic (its block, RHS and Newton-Schulz bounds), taken from the
shapes alone: each input read once and each output written once, the
operations of the algorithm. They are multiplied by what the integrator
counted (EnsembleStats), not by launches, so a layer's share reads the
same work whatever kernels implement it. Only members still integrating
are counted: the lockstep also runs the finished ones, which needs no
work.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 outside the
# tensor cores, at the full 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
F32 = 4


def least_seconds(n_bytes, n_ops):
    """The bytes over the memory rate or the operations over the float32
    rate, whichever is larger."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)


# -- per member, per call ---------------------------------------------------

def rhs_call(n, rows, leaves, ops_per_row_node, z_no):
    """One member's share of a fused RHS call over `rows` state rows (3
    for the stages, 1 for a single evaluation): the rows read and
    written, the member's parameter leaves read once."""
    return (F32 * (2 * rows * n + leaves),
            ops_per_row_node * rows * z_no)


def block_factor(m, z):
    """block_factor: the diagonal blocks in, the real and complex shifted
    inverses out, and h; three Gauss-Jordan inversions, three m x m
    products and the shifted assemblies a node."""
    return F32 * (4 * z * m * m + 1), z * (12 * m ** 3 + 3 * m * m)


def block_apply(m, z):
    """block_apply: three inverses and the sub-diagonal blocks in, three
    stage residuals in and out, and h; eight matvecs and the two 3 x 3
    stage transforms a node."""
    return F32 * (4 * z * m * m + 6 * m * z + 1), z * (16 * m * m + 42 * m)


def block_apply_real(m, z):
    """block_apply_real: the real inverse and the sub-diagonal blocks in,
    the error vector in and out, and h; two matvecs a node."""
    return F32 * (2 * z * m * m + 2 * m * z + 1), z * (4 * m * m + 2 * m)


def ns_step(n):
    """ns_fused_step: J and the three preconditioners in, three out, h
    and rho; eight n x n products."""
    return F32 * (7 * n * n + 2), 16 * n ** 3


# -- per sweep --------------------------------------------------------------

def member_attempts(stats):
    """Each member's attempts while it was integrating."""
    return [int(a) + int(r) for a, r in zip(stats["n_accepted"],
                                            stats["n_rejected"])]


def rhs_seconds(stats, config, opts):
    """The least time of the sweep's RHS evaluations: per attempt of each
    integrating member, newton_iters stage evaluations (the first
    cheap_sweeps with the plain RHS, the rest with the leg's), and one
    evaluation at the new state (the plain RHS where cheap sweeps run);
    one evaluation of every member at the start."""
    n, z = config["n_state"], config["z_no"]
    leaves = config["rhs_leaves_per_member"]
    ops = config["rhs_ops_per_row_node"]
    mode = "df32" if opts.get("accurate_rates") == "df32" else "plain"
    cheap = int(opts.get("cheap_sweeps", 0)) if mode == "df32" else 0
    iters = int(opts["newton_iters"])
    attempts = sum(member_attempts(stats))
    members = len(stats["n_accepted"])
    calls = (  # (members x calls, rows, RHS mode)
        (attempts * cheap, 3, "plain"),
        (attempts * (iters - cheap), 3, mode),
        (attempts, 1, "plain" if cheap else mode),
        (members, 1, mode))
    return sum(c * least_seconds(*rhs_call(n, rows, leaves, ops[k], z))
               for c, rows, k in calls)


def block_solve_seconds(stats, config, opts):
    """The least time of the exact stage solves: per attempt of each
    integrating member one factorisation, newton_iters stage solves and
    one error solve."""
    m, z = config["var_no"], config["z_no"]
    attempts = sum(member_attempts(stats))
    per = (least_seconds(*block_factor(m, z))
           + int(opts["newton_iters"]) * least_seconds(*block_apply(m, z))
           + least_seconds(*block_apply_real(m, z)))
    return attempts * per


def ns_seconds(stats, config, opts):
    """The least time of the Newton-Schulz steps: ns_step a member
    attempt, and ns_refresh after each Jacobian refresh of a chunk in
    which the member integrates (a member that took a attempts integrates
    in the first ceil(a / j_every) chunks). The cold rescues are left
    out: no counter says how many members they re-seed."""
    n = config["n_state"]
    j_every = int(opts["j_every"])
    att = member_attempts(stats)
    steps = (int(opts.get("ns_step", 1)) * sum(att)
             + int(opts.get("ns_refresh", 5))
             * sum(math.ceil(a / j_every) for a in att))
    return steps * least_seconds(*ns_step(n))
