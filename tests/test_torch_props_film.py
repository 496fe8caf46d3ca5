# The port's transport and film properties, axial stencils, two-zone mesh,
# collocation operators and particle residual assemblers (rmt_tpu_torch/
# props/transport.py, props/film.py, ops/stencils.py, ops/collocation.py,
# ops/oc_particle.py, ops/ocfe.py, ops/particle_fd.py) against rmt_tpu's
# on the CPU in float64, on seeded numpy inputs: properties and film
# numbers at 1e-12, stencil weights and the mesh bit for bit, their
# application at 1e-14, the OC and OCFE matrices and residuals and the
# FDM particle residuals at 1e-12.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmt_tpu.data import species as JDB
from rmt_tpu.ops import collocation as j_col
from rmt_tpu.ops import oc_particle as j_oc
from rmt_tpu.ops import ocfe as j_ocfe
from rmt_tpu.ops import particle_fd as j_fd
from rmt_tpu.ops import stencils as j_st
from rmt_tpu.props import film as j_film
from rmt_tpu.props import transport as j_tr
from rmt_tpu_torch.ops import collocation as t_col
from rmt_tpu_torch.ops import oc_particle as t_oc
from rmt_tpu_torch.ops import ocfe as t_ocfe
from rmt_tpu_torch.ops import particle_fd as t_fd
from rmt_tpu_torch.ops import stencils as t_st
from rmt_tpu_torch.props import film as t_film
from rmt_tpu_torch.props import transport as t_tr

COMP = ["H2", "CO2", "H2O", "CO", "CH3OH", "DME"]
IDX = JDB.species_indices(COMP)


def _close(got, want, rtol=1e-12):
    """Equal to rtol, with the floor rtol * max|want| for entries that
    cancel to near zero."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _mole_fractions(rng, k=6):
    x = rng.uniform(0.02, 1.0, k)
    return x / x.sum()


@pytest.mark.parametrize("T", [300.0, 523.0, 700.0])
def test_thermal_conductivity_matches_jax(T):
    _close(t_tr.thermal_conductivity(torch.tensor(T, dtype=torch.float64),
                                     IDX),
           j_tr.thermal_conductivity(T, IDX))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diffusivity_chapman_enskog_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, P = rng.uniform(400.0, 700.0), rng.uniform(1e5, 8e6)
    x = _mole_fractions(rng)
    _close(t_tr.diffusivity_chapman_enskog(
        torch.tensor(T, dtype=torch.float64),
        torch.tensor(P, dtype=torch.float64), torch.as_tensor(x), IDX),
        j_tr.diffusivity_chapman_enskog(T, P, jnp.asarray(x), IDX))


def test_film_numbers_match_jax():
    """Re, Sc, Pr, Sh (all three correlations), Nu, the transfer
    coefficients and the thermal diffusivity on seeded per-species
    inputs."""
    rng = np.random.default_rng(3)
    rho, u, dp, mu = (rng.uniform(1, 40), rng.uniform(0.05, 2),
                      rng.uniform(1e-3, 1e-2), rng.uniform(1e-5, 3e-5))
    dii = rng.uniform(1e-6, 1e-5, 6)
    cp, k, mw = rng.uniform(20, 60), rng.uniform(0.03, 0.3), rng.uniform(
        5e-3, 3e-2)

    def both(name, *args):
        t_args = [torch.as_tensor(a, dtype=torch.float64) for a in args]
        j_args = [jnp.asarray(a) for a in args]
        return getattr(t_film, name)(*t_args), getattr(j_film, name)(*j_args)

    re_t, re_j = both("reynolds", rho, u, dp, mu)
    sc_t, sc_j = both("schmidt", rho, mu, dii)
    pr_t, pr_j = both("prandtl", cp, mu, k, mw)
    for got, want in ((re_t, re_j), (sc_t, sc_j), (pr_t, pr_j)):
        _close(got, want)
    for method in (t_film.FROSSLING, t_film.ROSNER, t_film.GARNER_KEEY):
        _close(t_film.sherwood(sc_t, re_t, method),
               j_film.sherwood(sc_j, re_j, method))
    sh_t = t_film.sherwood(sc_t, re_t)
    nu_t, nu_j = t_film.nusselt(pr_t, re_t), j_film.nusselt(pr_j, re_j)
    _close(nu_t, nu_j)
    _close(t_film.mass_transfer_coefficient(sh_t, torch.as_tensor(dii), dp),
           j_film.mass_transfer_coefficient(j_film.sherwood(sc_j, re_j),
                                            jnp.asarray(dii), dp))
    _close(t_film.heat_transfer_coefficient(nu_t, k, dp),
           j_film.heat_transfer_coefficient(nu_j, k, dp))
    _close(np.float64(t_film.thermal_diffusivity(k, rho, cp, mw)),
           j_film.thermal_diffusivity(k, rho, cp, mw))


MESHES = {"uniform": None,
          "two-zone": j_st.two_zone_mesh((15, 10), 1.0, 30, 1.001)}


def test_two_zone_mesh_bit_for_bit():
    want = j_st.two_zone_mesh((15, 10), 1.0, 30, 1.001)
    got = t_st.two_zone_mesh((15, 10), 1.0, 30, 1.001)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_axial_stencils_match_jax(mesh):
    """The per-node weights bit for bit; their application to seeded
    profiles (with an inlet ghost, and with an explicit outlet mirror) at
    1e-14."""
    m = MESHES[mesh]
    z_no = 10 if m is None else m["n_nodes"]
    want = j_st.axial_stencil_weights(z_no, m)
    got = t_st.axial_stencil_weights(z_no, m)
    for k in ("W1", "W2", "dz_bc1"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rng = np.random.default_rng(4)
    F = rng.uniform(0.1, 1.0, (6, z_no))
    ghost = rng.uniform(0.1, 1.0, (6, 1))
    mirror = rng.uniform(0.1, 1.0, (6, 1))
    for W in (want["W1"], want["W2"]):
        _close(t_st.apply_axial_weights(W, torch.as_tensor(F),
                                        torch.as_tensor(ghost)),
               j_st.apply_axial_weights(W, jnp.asarray(F), jnp.asarray(ghost)),
               1e-14)
        _close(t_st.apply_axial_weights(W, torch.as_tensor(F),
                                        torch.as_tensor(ghost),
                                        torch.as_tensor(mirror)),
               j_st.apply_axial_weights(W, jnp.asarray(F), jnp.asarray(ghost),
                                        jnp.asarray(mirror)), 1e-14)


def test_collocation_and_ocfe_tables_bit_for_bit():
    """build_matrices, oc_operator and the OCFE basis and operator are the
    same numpy arithmetic: every table equal bit for bit."""
    for got, want in ((t_col.build_matrices(), j_col.build_matrices()),
                      (t_oc.oc_operator(), j_oc.oc_operator()),
                      (t_ocfe.ocfe_operator(6), j_ocfe.ocfe_operator(6)),
                      (t_ocfe.ocfe_basis(3), j_ocfe.ocfe_basis(3))):
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=k)


@pytest.mark.parametrize("flux_dir", ["lr", "rl"])
def test_oc_interface_and_residual_match_jax(flux_dir):
    """interface_update and oc_residual on a (species, points) batch of
    seeded profiles with per-species transfer numbers, at 1e-12."""
    rng = np.random.default_rng(5)
    ops_j, ops_t = j_oc.oc_operator(), t_oc.oc_operator()
    y = rng.uniform(0.1, 1.0, (6, 7))
    bulk, beta = rng.uniform(0.2, 1.0, 6), rng.uniform(1.0, 50.0, 6)
    src = rng.uniform(-1.0, 1.0, (6, 7))
    want = np.stack([j_oc.interface_update(jnp.asarray(y[i]), bulk[i],
                                           beta[i], ops_j["A"], flux_dir)
                     for i in range(6)])
    _close(t_oc.interface_update(torch.as_tensor(y), torch.as_tensor(bulk),
                                 torch.as_tensor(beta),
                                 t_oc.table(ops_t, "A", torch.as_tensor(y)),
                                 flux_dir), want)
    want = np.stack([j_oc.oc_residual(jnp.asarray(y[i]), 0.7,
                                      jnp.asarray(src[i]), beta[i], bulk[i],
                                      ops_j) for i in range(6)])
    _close(t_oc.oc_residual(torch.as_tensor(y), 0.7, torch.as_tensor(src),
                            torch.as_tensor(beta), torch.as_tensor(bulk),
                            ops_t), want)


@pytest.mark.parametrize("nu_el", [3, 6])
def test_ocfe_residual_matches_jax(nu_el):
    rng = np.random.default_rng(6 + nu_el)
    ops_j, ops_t = j_ocfe.ocfe_operator(nu_el), t_ocfe.ocfe_operator(nu_el)
    n = ops_j["NuToCoPo"]
    y = rng.uniform(0.1, 1.0, (6, n))
    src = rng.uniform(-1.0, 1.0, (6, n))
    bulk, beta = rng.uniform(0.2, 1.0, 6), rng.uniform(1.0, 50.0, 6)
    want = np.stack([j_ocfe.ocfe_residual(jnp.asarray(y[i]), 0.45,
                                          jnp.asarray(src[i]), beta[i],
                                          bulk[i], ops_j) for i in range(6)])
    _close(t_ocfe.ocfe_residual(torch.as_tensor(y), 0.45,
                                torch.as_tensor(src), torch.as_tensor(beta),
                                torch.as_tensor(bulk), ops_t), want)


@pytest.mark.parametrize("flux_dir", ["lr", "rl"])
def test_particle_fd_residuals_match_jax(flux_dir):
    """build_c_residual over a (species, rNo) batch with per-species
    scalars, and build_t_residual, at 1e-12."""
    rng = np.random.default_rng(7)
    y = rng.uniform(0.1, 1.0, (6, 7))
    src = rng.uniform(-1.0, 1.0, (6, 7))
    d, ma, cb, g = (rng.uniform(0.5, 1.5, 6), rng.uniform(0.005, 0.03, 6),
                    rng.uniform(0.1, 1.0, 6), rng.uniform(1e-6, 1e-5, 6))
    rf = 1.5e-3
    want = np.stack([j_fd.build_c_residual(
        jnp.asarray(y[i]), jnp.asarray(src[i]), d[i], ma[i], cb[i], g[i], rf,
        flux_dir) for i in range(6)])
    _close(t_fd.build_c_residual(
        torch.as_tensor(y), torch.as_tensor(src), torch.as_tensor(d),
        torch.as_tensor(ma), torch.as_tensor(cb), torch.as_tensor(g), rf,
        flux_dir), want)
    want = j_fd.build_t_residual(jnp.asarray(y[0]), jnp.asarray(src[0]),
                                 0.45, 1.7, 0.02, 1.25e-4, rf)
    _close(t_fd.build_t_residual(torch.as_tensor(y[0]),
                                 torch.as_tensor(src[0]),
                                 torch.tensor(0.45, dtype=torch.float64),
                                 1.7, 0.02, 1.25e-4, rf), want)
