# The port's dp mesh (rmt_tpu_torch/parallel/mesh.py: make_mesh and
# shard_batch over a torch.distributed process group, mesh= on the
# ensemble runners, the estimation step and the lockstep integrator) and
# its multichip dry run (rmt_tpu_torch/parallel/dryrun.py, the twin of
# __graft_entry__.py::dryrun_multichip), on the CPU.
#
# One module fixture spawns the dry run's worker twice, at the same
# B = 4 members: over two gloo ranks (two members a rank) and over one
# rank, each rank on device="cpu" with one thread, meeting on a file://
# store under tmp_path; the three dry-run phases plus run_n2_ensemble
# and phase 3's interval on the lockstep M13 engine. Meanwhile this
# process runs rmt_tpu's sharded counterparts over make_mesh(
# jax.devices()[:2]) (tests/conftest.py gives 8 virtual CPU devices).
#
# Bit for bit across the two runs: run_n2_ensemble, the estimation
# step's outlet mole fractions and every rank's copy of the gathered
# results. The lockstep runs are not: on the CPU, torch.mean over the
# last axis of a (B, n) tensor whose members are contiguous in memory
# (the layout the block solves leave the stage increments in, read by
# the integrator's scaled norms) gives bits that depend on B below the
# 8-float vector width, so a member integrated in a batch of 2 takes
# other steps than in a batch of 4 (from B = 8 on, the bits agree).
# Those runs are held to the f32 leg's 5e-5 bar with the scalar counters
# equal (chip_smoke holds them bit for bit on the card at B = 4096). The
# float64 M13 interval agrees to 2e-12 (3e-15 on the vmap engine) and is
# held to 1e-10.

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from clock import CHILD_LIMIT_S
from dme_case import make_model_input
from rmt_tpu.models import homo as j_homo
from rmt_tpu.parallel import batch_params as j_batch_params
from rmt_tpu.parallel import make_mesh as j_make_mesh
from rmt_tpu.parallel import run_m13_sweep as j_m13
from rmt_tpu.parallel import run_n2_ensemble as j_seq
from rmt_tpu.parallel import run_n2_ensemble_lockstep as j_lockstep
from rmt_tpu.parallel import shard_batch as j_shard_batch
from rmt_tpu.parallel.estimation import make_estimation_step as j_est_step
from rmt_tpu_torch.cases.dme_case import make_model_input as t_input
from rmt_tpu_torch.parallel import (Mesh, batch_params, make_mesh,
                                    run_n2_ensemble_lockstep, shard_batch)
from rmt_tpu_torch.parallel import dryrun
from rmt_tpu_torch.models import homo as t_homo

B = 4
PHASES = dryrun.PHASES + dryrun.EXTRA_PHASES


def _jax_references():
    """rmt_tpu's dry-run phases over a 2-device dp mesh at B members."""
    mesh = j_make_mesh(jax.devices()[:2])
    out = {}
    mi = make_model_input(model="N2", op_period=0.5)
    spec = j_homo.build_spec(mi, z_no=8, t_no=1)
    params, axes = j_batch_params(j_homo.build_params(mi), {
        "T0": jnp.asarray(523.0 + np.linspace(-4.0, 4.0, B))})
    target = jax.device_put(jnp.full((B, spec.n_comp), 1.0 / spec.n_comp),
                            NamedSharding(mesh, P("dp")))
    step = j_est_step(spec, axes, target, **dryrun.ESTIMATION)
    theta, loss = step({k: jnp.asarray(v)
                        for k, v in dryrun.theta_523().items()},
                       j_shard_batch(mesh, params, axes))
    out["estimation"] = {"loss": float(loss),
                         "theta": {k: float(v) for k, v in theta.items()}}
    sweep = {"T0": jnp.asarray(dryrun.lockstep_sweep(B)["T0"])}
    mp = pytest.MonkeyPatch()
    mp.setattr(j_homo, "build_spec",
               functools.partial(j_homo.build_spec, z_no=8, t_no=2))
    try:
        mi = make_model_input(model="N2", op_period=0.1)
        for name, opts in (("lockstep", dryrun.LOCKSTEP),
                           ("lockstep_f32x", dryrun.F32X)):
            ys, _ = j_lockstep(mi, sweep, mesh=mesh, **opts)
            out[name] = np.asarray(ys, np.float64)
        ys, nfev = j_seq(mi, sweep, mesh=mesh)
        out["seq"] = (np.asarray(ys), np.asarray(nfev))
    finally:
        mp.undo()
    m13 = j_m13(dryrun.m13_input(), {
        "T0": jnp.asarray(dryrun.m13_sweep(B)["T0"])}, mesh=mesh)
    out["m13"] = {k: np.asarray(m13[k]) for k in ("gas", "solid")}
    return out


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """(the two-rank Launch, the one-rank Launch, rmt_tpu's results),
    both Launches ended."""
    store = tmp_path_factory.mktemp("mesh")
    two = dryrun.start(dryrun.dryrun_worker, 2, "gloo", "cpu", store,
                       PHASES, B)
    one = dryrun.start(dryrun.dryrun_worker, 1, "gloo", "cpu", store,
                       PHASES, B)
    try:
        ref = _jax_references()
    finally:
        for launch in (two, one):
            launch.results(CHILD_LIMIT_S)
    return two, one, ref


@pytest.fixture(scope="module")
def runs(launches):
    """(two-rank results by rank, one-rank results, rmt_tpu's)."""
    two, one, ref = launches
    return two.results(CHILD_LIMIT_S), one.results(CHILD_LIMIT_S)[0], ref


def test_dryrun_results_and_the_launch(launches, runs):
    """dryrun_results (what dryrun_multichip returns) is rank 0's result
    with every rank's launch counts; a Launch records the seconds from
    its start to its last rank's result, and stop() leaves no rank
    running."""
    two, _, _ = launches
    got = dryrun.dryrun_results(two)
    assert _equal({k: v for k, v in got.items() if k != "launches_by_rank"},
                  runs[0][0])
    assert got["launches_by_rank"] == [r["launches"] for r in runs[0]]
    assert 0.0 < two.wall < time.time() - two.started
    two.stop()
    assert not any(p.is_alive() for p in two.context.processes)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _rel(got, want, floor):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        floor)))


def test_every_rank_returns_the_whole_batch(runs):
    """Both ranks hold the same gathered results, in member order, of B
    members; each rank's own launch counts (no kernel on the CPU)."""
    r2, r1, _ = runs
    names = {"estimation", "lockstep", "lockstep_f32x", "m13", "seq",
             "m13_lockstep"}
    for name in names:
        assert _equal(r2[0][name], r2[1][name]), name
    assert r2[0]["lockstep"]["ys"].shape == (3, B, 56)
    assert r2[0]["seq"]["ys"].shape == (B, 3, 56)
    assert r2[0]["m13"]["gas"].shape == (B, 1, 7, 5)
    for res in (*r2, r1):
        assert set(res["launches"]) == names
        assert all(v == 0 for ph in res["launches"].values()
                   for v in ph.values())


def test_estimation_two_ranks_match_one_rank(runs):
    """The loss, gradient and theta_new summed over two ranks equal the
    one-rank step's within 1e-12 relative (float64 sums in another
    order); the outlet mole fractions bit for bit."""
    r2, r1, _ = runs
    a, b = r2[0]["estimation"], r1["estimation"]
    assert abs(a["loss"] - b["loss"]) <= 1e-12 * abs(b["loss"])
    for k in dryrun.theta_523():
        assert abs(a["grads"][k] - b["grads"][k]) <= 1e-12 * abs(
            b["grads"][k]), k
        assert abs(a["theta"][k] - b["theta"][k]) <= 1e-12 * abs(
            b["theta"][k]), k
        assert a["theta"][k] != dryrun.theta_523()[k]
    assert torch.equal(a["mf"], b["mf"])


def test_estimation_matches_jax(runs):
    """Against rmt_tpu's dp-sharded step: tests/test_torch_estimation.py's
    bar, 1e-8 relative on loss and theta_new."""
    r2, _, ref = runs
    a, want = r2[0]["estimation"], ref["estimation"]
    assert abs(a["loss"] - want["loss"]) <= 1e-8 * want["loss"]
    for k, v in want["theta"].items():
        assert abs(a["theta"][k] - v) <= 1e-8 * abs(v), k


@pytest.mark.parametrize("name", ["lockstep", "lockstep_f32x"])
def test_lockstep_two_ranks_match_one_rank(runs, name):
    """The chunk's flags are OR-ed over the ranks: the same Jacobian
    refreshes and cold rescues as the one-rank run; every member
    finished; states within the f32 leg's 5e-5 (see the module
    comment)."""
    r2, r1, _ = runs
    a, b = r2[0][name], r1[name]
    assert a["stats"]["n_jev"] == b["stats"]["n_jev"] >= 2
    assert a["stats"]["n_rescue"] == b["stats"]["n_rescue"]
    assert int(torch.sum(a["stats"]["seg"] < 2)) == 0
    assert _rel(a["ys"], b["ys"].double().numpy(), 1e-7) <= 5e-5


@pytest.mark.parametrize("name", ["lockstep", "lockstep_f32x"])
def test_lockstep_matches_jax(runs, name):
    """Against rmt_tpu's dp-sharded chunk: tests/test_torch_lockstep.py's
    bar, 5e-4 relative, denominator max(|ref|, 1e-7)."""
    r2, _, ref = runs
    assert r2[0][name]["ys"].shape == ref[name].shape
    assert _rel(r2[0][name]["ys"], ref[name], 1e-7) < 5e-4


def test_seq_ensemble_two_ranks_match_one_rank_and_jax(runs):
    """run_n2_ensemble (float64, sequential Radau): bit for bit the
    one-rank run, and rmt_tpu's dp-sharded run within
    tests/test_torch_seq_ensemble.py's 1e-6 (denominator
    max(|ref|, 1e-8)) with nfev equal."""
    r2, r1, ref = runs
    a = r2[0]["seq"]
    assert _equal(a, r1["seq"])
    ys_j, nfev_j = ref["seq"]
    assert _rel(a["ys"], ys_j, 1e-8) <= 1e-6
    assert a["nfev"].tolist() == nfev_j.tolist()


@pytest.mark.parametrize("engine", ["m13", "m13_lockstep"])
def test_m13_two_ranks_match_one_rank(runs, engine):
    """Phase 3's interval on either engine: every member converged, no
    output time unreached, the gas and solid states within 1e-10 of the
    one-rank run (see the module comment); the lockstep engine with the
    same rescued count."""
    r2, r1, _ = runs
    a, b = r2[0][engine], r1[engine]
    assert bool(a["converged"].all()) and int(a["unreached"].sum()) == 0
    assert torch.equal(a["ts"], b["ts"])
    assert torch.equal(a["converged"], b["converged"])
    assert a.get("rescued") == b.get("rescued")
    for k in ("gas", "solid"):
        assert _rel(a[k], b[k].numpy(), 1e-9) <= 1e-10, k


def test_m13_matches_jax(runs):
    """Against rmt_tpu's dp-sharded interval (vmap engine):
    tests/test_torch_sweep_m13.py's bar, rtol 1e-5, atol 1e-9."""
    r2, _, ref = runs
    for k in ("gas", "solid"):
        np.testing.assert_allclose(r2[0]["m13"][k].numpy(), ref["m13"][k],
                                   rtol=1e-5, atol=1e-9)


def _sweep_params():
    base = t_homo.build_params(t_input(model="N2"), device="cpu")
    return batch_params(base, {"T0": 523.0 + np.arange(4.0),
                               "K1": np.linspace(1.0, 2.0, 4)})


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_cuts_swept_leaves(rank):
    """Each rank gets its contiguous block of the swept leaves (a top
    level one and a kinetic override); the replicated leaves whole."""
    params, axes = _sweep_params()
    mesh = Mesh(None, rank, 2, torch.device("cpu"))
    got = shard_batch(mesh, params, axes)
    rows = slice(2 * rank, 2 * rank + 2)
    assert torch.equal(got["T0"], params["T0"][rows])
    assert torch.equal(got["kinetic_overrides"]["K1"],
                       params["kinetic_overrides"]["K1"][rows])
    assert torch.equal(got["P0"], params["P0"])
    assert set(got) == set(params)


def test_shard_batch_and_runners_refuse():
    """A B the mesh size does not divide raises ValueError, as
    jax.device_put of a P("dp") batch does; mesh with microbatch raises
    ValueError, as rmt_tpu does; a mesh that is no Mesh raises
    TypeError; make_mesh without a process group names
    init_process_group."""
    params, axes = _sweep_params()
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(Mesh(None, 0, 3, torch.device("cpu")), params, axes)
    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    mi = t_input(model="N2", op_period=0.002)
    with pytest.raises(ValueError, match="microbatch and mesh"):
        run_n2_ensemble_lockstep(mi, {"T0": 523.0 + np.arange(4.0)},
                                 mesh=mesh, microbatch=2)
    with pytest.raises(TypeError, match="Mesh"):
        run_n2_ensemble_lockstep(mi, {"T0": 523.0 + np.arange(4.0)},
                                 mesh=object())
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")
