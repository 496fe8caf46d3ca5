"""One run of one cell of the benchmark of rmt_tpu_torch.

Everything is found by name. BENCHMARK.json at the checkout's root names
the cell (`workloads`), its configuration and its traffic mix; then

  rmtbench/configs/<config>.json     sizes, reactor and feed, the case
                                     module that builds the program's input
  rmtbench/configs/<config>.py       its chemistry for the float64
                                     reference (rmtbench/reference/n2.py)
  rmtbench/traffic/<mix>.json        members, T0 band, lockstep options
  rmtbench/limits/<cell>.json        the limit of each number compared
  rmtbench/metrics/<metric>.py       a per-layer metric's reader
  rmtbench/layers/<layer>/*.json     the kernels of a layer, by name

The run does its set-up (the program's CUDA libraries built or loaded into
the checkout, the cell's input, a few attempts at the cell's members to
warm every kernel), then runs whole sweeps back to back through
rmt_tpu_torch.parallel.ensemble.run_n2_ensemble_lockstep until `seconds`
have passed. With trace, the first sweep of the window runs under
torch.profiler and the per-layer metrics are read from it.
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import check, traffic

FOLDER = "rmtbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "rmt_tpu")
BUILT_IN = ("members_per_s", "peak_mem_gib", "setup_s")
GIB = 2 ** 30


class CellError(Exception):
    """The cell's files are missing or inconsistent."""


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root):
    """The cell's entries and files, found from BENCHMARK.json and the
    benchmark's folder under ``root`` (the checkout)."""
    here = os.path.join(root, FOLDER)
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    mix = _json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits_path = os.path.join(here, "limits", f"{name}.json")
    limits = _json(limits_path) if os.path.exists(limits_path) else None

    def in_cell(entry):
        return "workloads" not in entry or name in entry["workloads"]

    return SimpleNamespace(
        dir=here, workload=w, config=config, mix=mix, limits=limits,
        reference=os.path.join(here, "configs", f"{config['name']}.py"),
        end_to_end=[m for m in bench["end_to_end"] if in_cell(m)],
        per_layer=[m for m in bench["per_layer"] if in_cell(m)])


def layer_kernels(here, layer):
    """The union of the kernel names that layers/<layer>/*.json list."""
    names = set()
    for path in sorted(glob.glob(os.path.join(here, "layers", layer,
                                              "*.json"))):
        names.update(_json(path)["kernels"])
    return names


def load_file(path, name):
    """The module of the Python file at ``path``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(here, name):
    """The read(ctx) function of metrics/<name>.py."""
    path = os.path.join(here, "metrics", f"{name}.py")
    return load_file(path, f"rmtbench_metric_{name.replace('.', '_')}").read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def program():
    """The system under test (looked up at each call)."""
    from rmt_tpu_torch.parallel import ensemble

    return ensemble.run_n2_ensemble_lockstep


def model_input(config):
    """The program's input from the configuration's case module, held to
    the numbers the configuration file states."""
    import torch
    from rmt_tpu_torch.models import homo

    case = importlib.import_module(config["case"])
    mi = case.make_model_input(model=config["model"])
    spec = homo.build_spec(mi)
    p = homo.build_params(mi, dtype=torch.float64, device="cpu")
    stated = dict(config["operating"], T0=config["t_base_K"])
    for k, v in stated.items():
        got = np.asarray(p[k].double().numpy())
        if got.shape != np.shape(v) or not np.array_equal(got, v):
            raise CellError(f"{config['name']}: the case gives {k} = "
                            f"{got.tolist()}, the configuration {v}")
    sizes = dict(z_no=spec.z_no, t_no=spec.t_no, var_no=spec.var_no_n2,
                 n_state=spec.var_no_n2 * spec.z_no)
    for k, v in sizes.items():
        if config[k] != v:
            raise CellError(f"{config['name']}: the program's {k} is {v}, "
                            f"the configuration's {config[k]}")
    if tuple(spec.comp_list) != tuple(config["components"]):
        raise CellError(f"{config['name']}: components {spec.comp_list}")
    return mi


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_stats(stats):
    """The EnsembleStats that the per-layer readers use, on the host."""
    return dict(n_jev=int(stats.n_jev),
                n_accepted=stats.n_accepted.cpu().numpy(),
                n_rejected=stats.n_rejected.cpu().numpy())


class Run:
    """Set-up, window and check of one cell on one device."""

    def __init__(self, cell, seed, device, options=None):
        import torch

        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.opts = dict(cell.mix["options"], **(options or {}))
        self.mi = model_input(cell.config)
        self.n_seg = cell.config["t_no"]
        self.sweeps = traffic.Sweeps(seed, cell.mix, cell.config)

    def sweep(self, t0, idx, **over):
        """One sweep through the timed call: (recorded states, final
        states, statistics)."""
        return program()(self.mi, {"T0": t0}, out_members=idx,
                         device=self.device, **dict(self.opts, **over))

    def warm_up(self):
        """A few attempts at the cell's members (every kernel the sweep
        launches, built or loaded), from a stream of its own."""
        warm = traffic.Sweeps(self.seed, self.cell.mix, self.cell.config,
                              stream=2)
        t0, idx = warm.next()
        self.sweep(t0, idx, max_steps=int(self.cell.mix["warm_attempts"]))
        _sync(self.device)

    def window(self, seconds, trace=False):
        """Whole sweeps until ``seconds`` have passed; the first one
        profiled with ``trace``."""
        import torch

        dev = self.device
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        # unfinished and non-finite members; attempts and rejections by
        # cause (Newton did not converge, uncertified solve, error)
        bad = torch.zeros(6, dtype=torch.int64, device=dev)
        self.recorded, self.profiled = [], None
        n = 0
        t_start = time.perf_counter()
        while True:
            t0, idx = self.sweeps.next()
            if trace and n == 0:
                self.profiled = self._profiled_sweep(t0, idx, bad)
            else:
                ys, y_fin, stats = self.sweep(t0, idx)
                self._tally(bad, ys, y_fin, stats, t0, idx)
            _sync(dev)
            n += 1
            if time.perf_counter() - t_start >= seconds:
                break
        t_end = time.perf_counter()
        self.sweeps_done = n
        self.window_s = t_end - t_start
        self.peak_bytes = (torch.cuda.max_memory_allocated(dev) if cuda
                           else None)
        (self.unfinished, self.nonfinite, *counts) = bad.tolist()
        self.counts = dict(zip(("attempts", "rej_conv", "rej_rho",
                                "rej_err"), counts))
        self.recorded = [(t, y.double().cpu().numpy())
                         for t, y in self.recorded]

    def _tally(self, bad, ys, y_fin, stats, t0, idx):
        import torch

        bad += torch.stack([
            torch.sum(stats.seg < self.n_seg),
            torch.sum(~torch.isfinite(y_fin).all(dim=-1)),
            torch.sum(stats.n_accepted + stats.n_rejected),
            torch.sum(stats.n_rej_conv), torch.sum(stats.n_rej_rho),
            torch.sum(stats.n_rej_err)])
        self.recorded.append((t0[idx], ys.transpose(0, 1)))

    def _profiled_sweep(self, t0, idx, bad):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        with profile(activities=acts) as prof:
            t_a = time.perf_counter()
            ys, y_fin, stats = self.sweep(t0, idx)
            _sync(self.device)
            wall = time.perf_counter() - t_a
        self._tally(bad, ys, y_fin, stats, t0, idx)
        # the events are reduced once the window has closed
        return SimpleNamespace(prof=prof, wall=wall, stats=host_stats(stats))

    def compare(self):
        """The reference check of a sample of the recorded members:
        (max_rel_err, members compared)."""
        t0s = np.concatenate([t for t, _ in self.recorded])
        got = np.concatenate([y for _, y in self.recorded])
        pick = check.sample(self.seed, len(t0s),
                            int(self.cell.mix["check_members"]))
        want = check.reference_states(self.cell.reference,
                                      self.cell.config, t0s[pick])
        return check.max_rel_err(got[pick], want), len(pick)

    def reduce_trace(self):
        """The profiled sweep's events, reduced (after the window)."""
        from . import trace

        p = self.profiled
        p.trace = trace.from_profiler(p.prof, p.wall)
        del p.prof

    def layer_metrics(self):
        """The cell's per-layer metrics from the profiled sweep; a reader
        that finds nothing returns None and is left out."""
        ctx = SimpleNamespace(
            config=self.cell.config, opts=self.opts, mix=self.cell.mix,
            stats=self.profiled.stats, trace=self.profiled.trace,
            layer_kernels=lambda layer: layer_kernels(self.cell.dir, layer))
        out = {}
        for m in self.cell.per_layer:
            v = metric_reader(self.cell.dir, m["name"])(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out


def checks(run, limits):
    """Each number compared, with its limit: members that did not finish,
    members with a state that is not finite, the sample's largest
    relative error against the reference, and, where the cell's limits
    name it, the rejections a sweep because Newton did not converge."""
    err, n = run.compare()
    out = {
        "unfinished": {"value": run.unfinished, "limit": 0},
        "nonfinite": {"value": run.nonfinite, "limit": 0},
        "max_rel_err": {"value": err, "members": n,
                        "limit": limits["max_rel_err"]["limit"]},
    }
    if "newton_failures" in limits:
        out["newton_failures"] = {
            "value": run.counts["rej_conv"] / run.sweeps_done,
            "limit": limits["newton_failures"]["limit"]}
    return out


def set_tf32(on):
    """TF32 in float32 products on or off (the program pins it off when it
    is imported)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def run_cell(name, seed, seconds, trace, root, device, t_process=None,
             control=None, card=None):
    """One run of cell ``name``: the result's dict, the contract's keys in
    order with "checks" last. ``t_process`` is the process's start on the
    perf_counter clock (default: now). ``control`` (the form of a cell's
    limits' "control") runs the program as that control: its lockstep
    options laid over the mix's, TF32 on where it says so."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = load_cell(name, root)
    if cell.limits is None:
        raise CellError(f"no limits/{name}.json")
    control = control or {}
    marks = [("start", t_process), ("imports", time.perf_counter())]
    run = Run(cell, seed, device, control.get("options"))
    set_tf32(bool(control.get("tf32")))
    marks.append(("input", time.perf_counter()))
    run.warm_up()
    marks.append(("warm_up", time.perf_counter()))
    setup_s = marks[-1][1] - t_process
    phases = {k: t - marks[i][1] for i, (k, t) in enumerate(marks[1:])}
    run.window(seconds, trace)
    found = forbidden_modules()
    if found:
        raise CellError(f"modules loaded: {', '.join(found)}")
    peak = run.peak_bytes
    attempted = run.sweeps_done * int(cell.mix["members"])
    if trace:
        run.reduce_trace()
        metrics = run.layer_metrics()
    else:
        values = dict(members_per_s=attempted / run.window_s,
                      peak_mem_gib=(peak / GIB if peak is not None
                                    else None),
                      setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in BUILT_IN}
    if run.device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    held = checks(run, cell.limits)
    correct = all(c["value"] <= c["limit"] for c in held.values())
    device = dict(platform="gpu" if run.device.type == "cuda" else "cpu",
                  kind=card or str(run.device),
                  count=1, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=attempted,
                  failed=run.unfinished + run.nonfinite,
                  metrics=metrics, device=device)
    if trace:
        tr = run.profiled.trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = dict(device_ops=tr.device_ops(),
                                   idle_gaps=tr.idle_gaps())
    result["setup_phases_s"] = phases
    result["checks"] = held
    return result
