# The port's ensembles on the sequential integrator
# (rmt_tpu_torch.parallel: run_n2_ensemble, make_n2_ensemble,
# make_n1_ensemble; radau.odeint_batched under the hood) against
# rmt_tpu's (jax.vmap of radau.odeint), in float64 on the CPU, at a
# narrow N2 width (zNo 5, tNo 2: both packages' build_spec are given these
# for the module, since the ensemble entry points take the grid from
# HomoSpec's defaults; a period of 0.1) and on N1 at 11 output points.

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dme_case import make_model_input
from rmt_tpu import parallel as j_par
from rmt_tpu.models import homo as j_homo
from rmt_tpu_torch import parallel as t_par
from rmt_tpu_torch.models import homo as t_homo

SWEEPS = {
    "T0": {"T0": np.array([518.0, 523.0, 530.0])},
    "opT": {"opT": np.array([0.05, 0.1, 0.15])},
}


@pytest.fixture(scope="module")
def narrow():
    mp = pytest.MonkeyPatch()
    for mod in (j_homo, t_homo):
        mp.setattr(mod, "build_spec",
                   functools.partial(mod.build_spec, z_no=5, t_no=2))
    yield make_model_input(model="N2", op_period=0.1)
    mp.undo()


@pytest.mark.parametrize("swept", sorted(SWEEPS))
def test_run_n2_ensemble_matches_jax(narrow, swept):
    """ys to 1e-6 relative (denominator max(|ref|, 1e-8)) and nfev equal,
    with each member's own output times when opT is swept."""
    sweep = SWEEPS[swept]
    yj, nj = j_par.run_n2_ensemble(
        narrow, {k: jnp.asarray(v) for k, v in sweep.items()})
    yt, nt = t_par.run_n2_ensemble(narrow, sweep, device="cpu")
    yj = np.asarray(yj)
    assert yt.dtype == torch.float64 and tuple(yt.shape) == yj.shape == (
        3, 3, 35)
    rel = np.abs(yt.numpy() - yj) / np.maximum(np.abs(yj), 1e-8)
    assert rel.max() <= 1e-6, rel.max()
    assert nt.tolist() == np.asarray(nj).tolist()


def test_run_n2_ensemble_stats_and_refusals(narrow):
    """return_stats gives the integrator's per-member statistics (every
    member finished); a mesh that is no parallel.mesh.Mesh raises
    (tests/test_torch_mesh.py runs the sharded ensemble); without a
    device argument the entry point wants the card."""
    sweep = {"T0": np.array([523.0, 526.0])}
    mi = dict(narrow, **{"operating-conditions": dict(
        narrow["operating-conditions"], period=0.05)})
    ys, st = t_par.run_n2_ensemble(mi, sweep, device="cpu",
                                   return_stats=True, max_steps=2000)
    assert st.n_unreached.tolist() == [0, 0]
    assert (st.n_accepted > 0).all()
    with pytest.raises(TypeError, match="Mesh"):
        t_par.run_n2_ensemble(narrow, sweep, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_par.run_n2_ensemble(narrow, sweep)


def test_make_n1_ensemble_single_and_build_match_jax():
    """single on one member's parameters and build over a T0 sweep, both
    against rmt_tpu's, at 11 output points and rtol 1e-5: ys to 1e-6
    relative and nfev equal."""
    mi = make_model_input(model="N1")
    t0 = np.array([519.0, 527.0])
    jspec = j_homo.build_spec(mi)
    tspec = t_homo.build_spec(mi)
    kw = dict(rtol=1e-5, atol=1e-8, z_out=10)
    j_single, j_build = j_par.make_n1_ensemble(jspec, **kw)
    t_single, t_build = t_par.make_n1_ensemble(tspec, **kw)

    jp = j_homo.build_params(mi)
    tp = t_homo.build_params(mi, dtype=torch.float64, device="cpu")
    yj1, nj1 = j_single(jp)
    yt1, nt1 = t_single(tp)
    assert tuple(yt1.shape) == np.asarray(yj1).shape == (11, 8)
    np.testing.assert_allclose(yt1.numpy(), np.asarray(yj1), rtol=1e-6,
                               atol=1e-12)
    assert int(nt1) == int(nj1)

    jps, jax_axes = j_par.batch_params(jp, {"T0": jnp.asarray(t0)})
    tps, t_axes = t_par.batch_params(tp, {"T0": t0})
    yjb, njb = j_build(jax_axes)(jps)
    ytb, ntb = t_build(t_axes)(tps)
    assert tuple(ytb.shape) == (2, 11, 8)
    np.testing.assert_allclose(ytb.numpy(), np.asarray(yjb), rtol=1e-6,
                               atol=1e-12)
    assert ntb.tolist() == np.asarray(njb).tolist()
