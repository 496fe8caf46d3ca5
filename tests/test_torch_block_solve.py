# The port's block extraction (rmt_tpu_torch/ops/block_solve.py) against
# rmt_tpu's, and the lockstep integrator's block mode from a dense
# Jacobian (odeint_ensemble(block=(m, z), jac=...), the route rmtExe M2
# takes) against the same run from the Jacobian's blocks (jac_blocks), on
# the CPU in float64, where the stage solves run the block kernels' twins.

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from rmt_tpu.ops import block_solve as j_bs
from rmt_tpu_torch.cases import pb_case
from rmt_tpu_torch.models import pb
from rmt_tpu_torch.ops import block_solve as t_bs
from rmt_tpu_torch.ops import jacobian
from rmt_tpu_torch.solvers.stiff_ensemble import odeint_ensemble


@pytest.mark.parametrize("B, m, z", [(1, 7, 100), (3, 7, 20), (2, 4, 5)])
def test_extract_bidiag_blocks_matches_jax(B, m, z):
    """The diagonal and subdiagonal node blocks of a random dense (B, n, n)
    matrix, equal to rmt_tpu's, with Jl[:, 0] zero."""
    J = np.random.default_rng(B * m * z).standard_normal((B, m * z, m * z))
    got = t_bs.extract_bidiag_blocks(torch.as_tensor(J), m, z)
    want = j_bs.extract_bidiag_blocks(jnp.asarray(J), m, z)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, z, m, m)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[1][:, 0].any()
    # a node block is the matrix's entries at rows v*z + zi, columns
    # v'*z + zi (diagonal) and v'*z + zi - 1 (subdiagonal)
    zi = z - 1
    rows = np.arange(m) * z + zi
    np.testing.assert_array_equal(got[0][0, zi].numpy(),
                                  J[0][np.ix_(rows, rows)])
    np.testing.assert_array_equal(got[1][0, zi].numpy(),
                                  J[0][np.ix_(rows, rows - 1)])


def test_block_mode_from_dense_jacobian_matches_jac_blocks():
    """odeint_ensemble in block mode on M2 (zNo 10, two members 2% apart,
    over 1 s in four segments): the dense colored Jacobian and the blocks
    gathered straight from the colored JVPs give the same states to
    1e-10 and the same statistics. The only difference is the first
    step: the dense Jacobian's row sums against the blocks' (the same
    entries, summed in another order), as in rmt_tpu."""
    mi = pb_case.m2_model_input(z_no=10)
    mi["operating-conditions"]["period"] = 1.0
    spec = pb.build_spec(mi, z_no=10, t_no=4)
    p = pb.build_params(mi, device="cpu")
    rhs = pb.make_m2_rhs(spec)
    rhs_frozen = pb.make_m2_rhs(spec, frozen_pressure_jac=True)
    var_no = spec.n_comp + 1
    y0 = pb.m2_initial_state(spec, p)
    y0 = torch.stack([y0, y0 * 1.02])
    ts = p["opT"] * torch.linspace(0.0, 1.0, spec.t_no + 1,
                                   dtype=torch.float64)
    jac_x = jacobian.batched_colored_jacobian(
        lambda x: rhs_frozen(None, x, p),
        jacobian.banded_coloring(var_no, spec.z_no))
    blocks = vmap(jacobian.colored_bidiag_blocks(rhs_frozen, var_no,
                                                 spec.z_no),
                  in_dims=(0, 0, None))
    kw = dict(rtol=1e-7, atol=1e-10, max_steps=512,
              block=(var_no, spec.z_no),
              f_stages=lambda ts3, Y: rhs(ts3, Y, p))
    f = lambda t, y: rhs(t, y, p)
    ys_d, st_d = odeint_ensemble(f, y0, ts, jac=lambda t, y: jac_x(y),
                                 batched=True, **kw)
    ys_b, st_b = odeint_ensemble(f, y0, ts,
                                 jac_blocks=lambda t, y: blocks(t, y, p),
                                 **kw, batched=True)
    assert bool((st_d.seg == spec.t_no).all())
    np.testing.assert_allclose(ys_d.numpy(), ys_b.numpy(), rtol=1e-10)
    for name in ("n_accepted", "n_rejected", "n_fev", "seg"):
        assert torch.equal(getattr(st_d, name), getattr(st_b, name)), name
    assert st_d.n_jev == st_b.n_jev > 1
