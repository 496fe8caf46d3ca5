# The multichip dry run of the port (port of __graft_entry__.py::
# dryrun_multichip): rmt_tpu's three phases over one dp mesh of
# torch.distributed ranks, B = 2 members a rank.
#
#   1. the adjoint estimation step (zNo 8, period 0.5 s, 12 implicit
#      Radau steps, the DME constants K1-K3 at 523 K), its loss and
#      gradient summed over the ranks;
#   2. a lockstep N2 chunk (zNo 8, tNo 2, period 0.1 s), plain float32
#      with Newton-Schulz preconditioners and with the f32x options (df32
#      kinetics, exact block solves, 2 cheap sweeps); rmt_tpu's dry run
#      builds this grid's spec, but its lockstep call takes the grid of
#      HomoSpec's defaults (zNo 20, tNo 5: MULTICHIP_r05.json's 140
#      states), so the port's chunk is the smaller one it meant;
#   3. one M13 operator-splitting interval (zNo 5, rNo 4, tNo 1, the
#      frozen transport vectors of rmt_tpu's dry run).
#
# start() spawns the ranks (torch.multiprocessing, start method "spawn";
# they meet on a file:// store in a directory of the caller's, so
# parallel runs never share a port) and runs a worker function of this
# package (or of the caller's script) in each; every rank saves its
# result with torch.save, and the caller reads them back.

from __future__ import annotations

import contextlib
import functools
import math
import os
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh

PHASES = ("estimation", "lockstep", "m13")
# further checks a caller may add to the phases: run_n2_ensemble (the
# sequential float64 integrator) at phase 2's grid, and phase 3's
# interval on the lockstep M13 engine
EXTRA_PHASES = ("seq", "m13_lockstep")
# a collective that waits longer than this fails the run
COLLECTIVE_TIMEOUT_S = 900


def launch_counts():
    """Every kernel wrapper's launch count of this process, one dict."""
    from ..ops import cuda_block, cuda_ns, cuda_rhs

    return {k: v for table in (cuda_block.LAUNCHES, cuda_rhs.LAUNCHES,
                               cuda_ns.LAUNCHES) for k, v in table.items()}


def launches_since(before):
    """The kernel launches of this process since the counts ``before``."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()}


def _rank_main(rank, worker, n_ranks, backend, device, run_dir, args):
    # the ranks share the host's cores: one thread each (the CPU linear
    # algebra is then single-threaded, as the sweeps' tests run it)
    torch.set_num_threads(1)
    # the ranks share one host: gloo and NCCL bind to its loopback
    # interface, with no lookup of the host's name (a caller may set
    # another)
    for name in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(name, "lo")
    run_dir = Path(run_dir)
    dist.init_process_group(
        backend, init_method=(run_dir / "store").as_uri(),
        world_size=n_ranks, rank=rank,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        out = worker(mesh, *args)
        torch.save(out, run_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class Launch:
    """The ranks of one start() call; results() waits for them, stop()
    ends them."""

    def __init__(self, context, run_dir, n_ranks):
        self.context, self.run_dir, self.n_ranks = context, run_dir, n_ranks
        self.started = time.time()
        # seconds from start() to the last rank's saved result, once
        # results() has returned
        self.wall = None

    def stop(self):
        """Stop every rank that is still running."""
        for p in self.context.processes:
            if p.is_alive():
                p.terminate()
            p.join()

    def results(self, timeout: float | None = None) -> list:
        """Every rank's worker result, in rank order, once every rank has
        ended. A rank that fails raises here (its traceback in the
        message; the other ranks are stopped); past ``timeout`` seconds
        every rank is stopped and TimeoutError raised."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.context.join(
                None if deadline is None
                else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                self.stop()
                raise TimeoutError(f"the {self.n_ranks} ranks did not end "
                                   f"within {timeout} s")
        files = [self.run_dir / f"rank{r}.pt" for r in range(self.n_ranks)]
        self.wall = max(f.stat().st_mtime for f in files) - self.started
        return [torch.load(f) for f in files]


def start(worker, n_ranks: int, backend: str, device, store_dir,
          *args) -> Launch:
    """Spawn n_ranks processes that form a ``backend`` process group on a
    file:// store in a new directory under store_dir, and run
    worker(mesh, *args) in each (mesh: make_mesh(device=device); device
    None is each rank's own card). worker must be importable by the
    children (a function of a module, or of the script run as __main__),
    and its result a tree of tensors and Python numbers (torch.save)."""
    run_dir = Path(tempfile.mkdtemp(prefix="mesh-", dir=store_dir))
    context = torch.multiprocessing.start_processes(
        _rank_main, args=(worker, n_ranks, backend,
                          None if device is None else str(device),
                          str(run_dir), args),
        nprocs=n_ranks, join=False, start_method="spawn")
    return Launch(context, run_dir, n_ranks)


def dryrun_multichip(n_ranks: int, backend: str, device, store_dir) -> dict:
    """rmt_tpu's multichip dry run over n_ranks spawned ranks (a
    ``backend`` process group, every rank on ``device``, or on its own
    card when None) at B = 2 * n_ranks members; rank 0 prints each
    phase's "ok" lines. Returns rank 0's result (each phase's gathered
    results, see dryrun_worker) with "launches_by_rank", every rank's
    kernel launches of each phase. A failing check raises."""
    return dryrun_results(start(dryrun_worker, n_ranks, backend, device,
                                store_dir))


def dryrun_results(launch: Launch, timeout: float | None = None) -> dict:
    """dryrun_multichip's result from the Launch of its ranks
    (start(dryrun_worker, ...)), once they have ended: a caller may start
    the dry run and do other work before it waits (timeout: as
    Launch.results)."""
    results = launch.results(timeout)
    return dict(results[0],
                launches_by_rank=[r["launches"] for r in results])


@contextlib.contextmanager
def n2_grid(z_no: int, t_no: int):
    """homo.build_spec gives this grid inside the block: the N2 entry
    points take theirs from HomoSpec's defaults (zNo 20, tNo 5)."""
    from ..models import homo

    build = homo.build_spec
    homo.build_spec = functools.partial(build, z_no=z_no, t_no=t_no)
    try:
        yield
    finally:
        homo.build_spec = build


def _say(mesh, text):
    if mesh.rank == 0:
        print(text, flush=True)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


def theta_523():
    """The DME constants K1-K3 at 523 K (log space), the dry run's start."""
    rt = 8.314472 * 523.0
    return {"K1": math.log(35.45 * math.exp(-1.7069e4 / rt)),
            "K2": math.log(7.3976 * math.exp(-2.0436e4 / rt)),
            "K3": math.log(8.2894e4 * math.exp(-5.2940e4 / rt))}


def estimation_problem(b: int, device):
    """Phase 1's inputs at b members: (spec, params, axes, target,
    theta0); the sweep T0 = 523 + linspace(-4, 4, b), uniform targets."""
    from ..cases import dme_case
    from ..models import homo
    from .ensemble import batch_params

    mi = dme_case.make_model_input(model="N2", op_period=0.5)
    spec = homo.build_spec(mi, z_no=8, t_no=1)
    params, axes = batch_params(
        homo.build_params(mi, device=device),
        {"T0": 523.0 + np.linspace(-4.0, 4.0, b)})
    target = np.full((b, spec.n_comp), 1.0 / spec.n_comp)
    theta0 = {k: torch.tensor(v, dtype=torch.float64, device=device)
              for k, v in theta_523().items()}
    return spec, params, axes, target, theta0


ESTIMATION = dict(n_steps=12, lr=1e-3, integrator="radau")
LOCKSTEP = dict(max_steps=256, rtol=1e-6, atol=1e-9)
F32X = dict(LOCKSTEP, accurate_rates="df32", exact_solve=True,
            cheap_sweeps=2, j_every=8)


def _estimation(mesh, b):
    from .estimation import make_estimation_step
    from .mesh import shard_batch

    _say(mesh, "dryrun phase 1/3: dp-sharded adjoint estimation step "
         f"(B={b}, {mesh.size} ranks)")
    spec, params, axes, target, theta0 = estimation_problem(b, mesh.device)
    step = make_estimation_step(spec, axes, target, mesh=mesh, **ESTIMATION)
    local = shard_batch(mesh, params, axes)
    # step(theta0, local) in one pass that keeps the gradients
    loss, grads, mf = step.value_and_grad(theta0, local)
    theta1 = step.update(theta0, grads)
    _check(all(bool(torch.isfinite(v)) for v in theta1.values()),
           "non-finite theta")
    _say(mesh, f"  ok: loss={float(loss):.6g}")
    return {"loss": float(loss),
            "theta": {k: float(v) for k, v in theta1.items()},
            "grads": {k: float(v) for k, v in grads.items()},
            "mf": mf.cpu()}


def _stats(stats):
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in stats._asdict().items()}


def lockstep_sweep(b):
    """Phase 2's sweep at b members: T0 = 523 + linspace(-4, 4, b)."""
    return {"T0": 523.0 + np.linspace(-4.0, 4.0, b)}


def _lockstep(mesh, b, launches):
    from ..cases import dme_case
    from .ensemble import run_n2_ensemble_lockstep

    _say(mesh, "dryrun phase 2/3: dp-sharded lockstep N2 ensemble chunk")
    mi = dme_case.make_model_input(model="N2", op_period=0.1)
    out = {}
    for name, opts in (("lockstep", LOCKSTEP), ("lockstep_f32x", F32X)):
        before = launch_counts()
        with n2_grid(8, 2):
            ys, stats = run_n2_ensemble_lockstep(mi, lockstep_sweep(b),
                                                 mesh=mesh, **opts)
        _check(bool(torch.isfinite(ys[-1]).all()), f"{name}: non-finite")
        _check(int(torch.sum(stats.seg < ys.shape[0] - 1)) == 0,
               f"{name}: budget exhausted")
        attempts = int(torch.max(stats.n_accepted + stats.n_rejected))
        _say(mesh, f"  ok: {b} members x {ys.shape[-1]} states, max "
             f"attempts {attempts}" if name == "lockstep" else
             "  ok: exact_solve lockstep (df32 kinetics, block solves, "
             f"cheap_sweeps=2): {b} members, max attempts {attempts}")
        out[name] = {"ys": ys.cpu(), "stats": _stats(stats)}
        launches[name] = launches_since(before)
    return out


def m13_input():
    """Phase 3's model input: the M13 bed of rmt_tpu's dry run (its
    frozen transport vectors, FDM particle) at zNo 5, rNo 4, tNo 1 over
    a 1 s period."""
    from ..cases import hetero_case

    return hetero_case.dyn_model_input("M13", dict(zNo=5, rNo=4, tNo=1),
                                       period=1.0)


def m13_sweep(b):
    """Phase 3's sweep at b members: T0 = 523 + linspace(0, 8, b)."""
    return {"T0": 523.0 + np.linspace(0.0, 8.0, b)}


def _m13(mesh, b, engine="vmap"):
    from .ensemble import run_m13_sweep

    if engine == "vmap":
        _say(mesh, "dryrun phase 3/3: dp-sharded M13 operator-splitting "
             "interval")
    out = run_m13_sweep(m13_input(), m13_sweep(b), mesh=mesh, engine=engine)
    _check(bool(out["converged"].all()), "solid Newton failed")
    _check(int(out["unreached"].sum()) == 0, "gas budget exhausted")
    _check(bool(torch.isfinite(out["gas"]).all()), "non-finite gas")
    _say(mesh, f"  ok: gas/solid interval integrated for "
         f"{int(out['gas'].shape[0])} members ({engine} engine)")
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _seq(mesh, b):
    from ..cases import dme_case
    from .ensemble import run_n2_ensemble

    mi = dme_case.make_model_input(model="N2", op_period=0.1)
    with n2_grid(8, 2):
        ys, nfev = run_n2_ensemble(mi, lockstep_sweep(b), mesh=mesh)
    _check(bool(torch.isfinite(ys).all()), "run_n2_ensemble: non-finite")
    _say(mesh, f"  ok: run_n2_ensemble, {b} members")
    return {"ys": ys.cpu(), "nfev": nfev.cpu()}


def dryrun_worker(mesh, phases=PHASES, b=None):
    """One rank's dry run: the named phases (PHASES, and any of
    EXTRA_PHASES) at b members (default 2 * mesh.size, the dry run's).
    Returns every phase's gathered results (the whole batch's, equal on
    every rank; phase 2's two runs as "lockstep" and "lockstep_f32x"),
    this rank's kernel launches of each ("launches", by the same names)
    and the seconds this rank spent in each phase ("walls", by the
    phases' names)."""
    b = 2 * mesh.size if b is None else b
    runs = {"estimation": _estimation, "m13": _m13, "seq": _seq,
            "m13_lockstep": functools.partial(_m13, engine="lockstep")}
    out, launches, walls = {}, {}, {}
    for name in phases:
        t0 = time.perf_counter()
        if name == "lockstep":
            out.update(_lockstep(mesh, b, launches))
        else:
            before = launch_counts()
            out[name] = runs[name](mesh, b)
            launches[name] = launches_since(before)
        walls[name] = time.perf_counter() - t0
    out["launches"], out["walls"] = launches, walls
    return out
