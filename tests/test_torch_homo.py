# The N2 slice of rmt_tpu_torch.models.homo against rmt_tpu.models.homo:
# feed state, initial state, the RHS at float64 and in df32 mode, and the
# block-bidiagonal Jacobian blocks from colored JVPs. Parameters reach the
# port through rmt_tpu_torch.convert.params_from_jax, so both packages see
# the same numbers.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ch4_case
import dme_case
from rmt_tpu.models import homo as jhomo
from rmt_tpu_torch.convert import params_from_jax
from rmt_tpu_torch.models import homo as thomo

CASES = {"dme": dme_case, "ch4": ch4_case}


def _setup(case, dtype=np.float64, seed=0, kinetic_overrides=None):
    mi = CASES[case].make_model_input(model="N2")
    if kinetic_overrides:
        mi["kinetic-overrides"] = kinetic_overrides
    jspec, tspec = jhomo.build_spec(mi), thomo.build_spec(mi)
    p = jhomo.build_params(mi)
    if dtype == np.float32:
        p = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float32)), p)
    d = jhomo.feed_state(jspec, p)
    if dtype == np.float32:
        d = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float32)), d)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    tp = params_from_jax(p, device="cpu", dtype=tdt)
    td = params_from_jax(d, device="cpu", dtype=tdt)
    y0 = np.asarray(jhomo.n2_initial_state(jspec, p, d), np.float64)
    rng = np.random.default_rng(seed)
    y = (y0 * (1 + 0.05 * rng.uniform(size=y0.shape))).astype(dtype)
    return jspec, tspec, p, d, tp, td, y


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("case", ["dme", "ch4"])
def test_feed_and_initial_state_match_jax(case):
    jspec, tspec, p, d, tp, _, _ = _setup(case)
    td = thomo.feed_state(tspec, tp)
    assert td.keys() == d.keys()
    for k, v in d.items():
        np.testing.assert_allclose(td[k].numpy(), np.asarray(v), rtol=1e-13,
                                   atol=0, err_msg=k)
    np.testing.assert_allclose(
        thomo.n2_initial_state(tspec, tp, td).numpy(),
        np.asarray(jhomo.n2_initial_state(jspec, p, d)), rtol=1e-15)


@pytest.mark.parametrize("case", ["dme", "ch4"])
def test_rhs_f64_matches_jax(case):
    jspec, tspec, p, d, tp, td, y = _setup(case)
    want = jhomo.make_n2_rhs(jspec)(0.0, jnp.asarray(y), p, d)
    got = thomo.make_n2_rhs(tspec)(0.0, torch.as_tensor(y), tp, td)
    assert got.dtype == torch.float64
    assert _scaled(got.numpy(), want) < 1e-13


def test_rhs_f64_with_kinetic_override_matches_jax():
    jspec, tspec, p, d, tp, td, y = _setup(
        "dme", kinetic_overrides={"K1": 0.02})
    want = jhomo.make_n2_rhs(jspec)(0.0, jnp.asarray(y), p, d)
    got = thomo.make_n2_rhs(tspec)(0.0, torch.as_tensor(y), tp, td)
    assert _scaled(got.numpy(), want) < 1e-13


@pytest.mark.parametrize("seed", [1, 2])
def test_rhs_df32_matches_jax_df32(seed):
    """df32 mode on identical float32 parameters and states, against
    rmt_tpu's df32 RHS and against the port's float64 RHS on the same
    (promoted) inputs. Both packages keep the kinetics chain in
    compensated pairs and the rest of the RHS in float32 (rmt_tpu's x64
    process lifts the heat-capacity polynomials to float64), so each sits
    a few float32 ulps of the RHS scale from the float64 RHS (measured
    2e-7 to 4.5e-7 over 8 seeds, f32 ulp 6e-8). Bars: 1e-6 of the scale
    between the packages, and the port no further from float64 than twice
    rmt_tpu."""
    jspec, tspec, p, d, tp, td, y = _setup("dme", np.float32, seed)
    want = jhomo.make_n2_rhs(jspec, accurate_rates="df32")(
        np.float32(0.0), jnp.asarray(y), p, d)
    got = thomo.make_n2_rhs(tspec, accurate_rates="df32")(
        0.0, torch.as_tensor(y), tp, td)
    assert got.dtype == torch.float32
    assert _scaled(got.numpy(), want) < 1e-6
    up = lambda tree: {k: up(v) if isinstance(v, dict) else v.double()
                       for k, v in tree.items()}
    ref64 = thomo.make_n2_rhs(tspec)(0.0, torch.as_tensor(y).double(),
                                     up(tp), up(td)).numpy()
    assert _scaled(got.numpy(), ref64) < max(2 * _scaled(want, ref64), 2e-7)


@pytest.mark.parametrize("case", ["dme", "ch4"])
def test_bidiag_blocks_match_jax(case):
    jspec, tspec, p, d, tp, td, y = _setup(case, seed=3)
    Jd, Jl = jhomo.make_n2_bidiag_blocks(jspec)(0.0, jnp.asarray(y), p, d)
    tJd, tJl = thomo.make_n2_bidiag_blocks(tspec)(0.0, torch.as_tensor(y),
                                                  tp, td)
    m, z = tspec.var_no_n2, tspec.z_no
    assert tuple(tJd.shape) == tuple(tJl.shape) == (z, m, m)
    assert _scaled(tJd.numpy(), Jd) < 1e-12
    assert _scaled(tJl.numpy(), Jl) < 1e-12
    assert float(tJl[0].abs().max()) == 0.0


def test_bidiag_blocks_vmap_over_members():
    """The ensemble driver maps the block Jacobian over members with
    torch.func.vmap; it must equal the per-member calls."""
    _, tspec, _, _, tp, td, y = _setup("dme", seed=4)
    ys = torch.as_tensor(np.stack([y, y * 0.98]))
    f = thomo.make_n2_bidiag_blocks(tspec)
    in_dims = ({k: (None if k != "kinetic_overrides" else {})
                for k in tp}, None)
    Jd, Jl = torch.func.vmap(f, in_dims=(None, 0) + in_dims)(0.0, ys, tp, td)
    for b in range(2):
        Jd1, Jl1 = f(0.0, ys[b], tp, td)
        torch.testing.assert_close(Jd[b], Jd1, rtol=1e-13, atol=0)
        torch.testing.assert_close(Jl[b], Jl1, rtol=1e-13, atol=0)
