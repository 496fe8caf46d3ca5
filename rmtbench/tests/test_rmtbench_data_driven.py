"""A configuration, a traffic mix, a cell, a per-layer metric and a layer's
kernel file added to a copy of the benchmark as new files and entries are
found with no edit of the harness."""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import torch

from conftest import TINY
from rmtbench import harness


def test_new_files_are_found(tiny_root):
    here = os.path.join(tiny_root, "rmtbench")
    # a configuration: its file and its reference's chemistry, by name
    shutil.copy(os.path.join(here, "configs", "ch4_n2.json"),
                os.path.join(here, "configs", "ch4_copy.json"))
    with open(os.path.join(here, "configs", "ch4_copy.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "ch4_copy"
    with open(os.path.join(here, "configs", "ch4_copy.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(here, "configs", "ch4_n2.py"),
                os.path.join(here, "configs", "ch4_copy.py"))
    # a metric and a kernel file
    with open(os.path.join(here, "metrics", "new_metric.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return float(len(ctx.layer_kernels('rhs')))\n")
    with open(os.path.join(here, "layers", "rhs", "extra.json"), "w") as f:
        json.dump({"kernels": ["extra_kernel"]}, f)
    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="ch4_copy", source="test",
                                 file="rmtbench/configs/ch4_copy.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="copy_tiny", config="ch4_copy",
                                   traffic="tiny", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="new_metric", unit="kernels", better="lower",
        source="device_trace", layer="test", moves="members_per_s",
        workloads=["copy_tiny"]))
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    shutil.copy(os.path.join(here, "limits", f"{TINY}.json"),
                os.path.join(here, "limits", "copy_tiny.json"))

    cell = harness.load_cell("copy_tiny", tiny_root)
    assert cell.config["name"] == "ch4_copy"
    assert cell.mix["members"] == 4
    assert cell.reference.endswith(os.path.join("configs", "ch4_copy.py"))
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert harness.layer_kernels(here, "rhs") == {"n2_rhs_kernel",
                                                  "extra_kernel"}
    # the metric is read from a profiled sweep's context
    run = SimpleNamespace(cell=cell, opts={}, profiled=SimpleNamespace(
        stats={}, trace=None))
    assert harness.Run.layer_metrics(run) == {
        "new_metric": {"value": 2.0, "unit": "kernels"}}
    # and the new cell runs, its reference found by its configuration's name
    torch.set_num_threads(2)
    res = harness.run_cell("copy_tiny", 11, 0.0, False, tiny_root, "cpu")
    assert res["correct"], res
    assert res["attempted"] == 4
    assert set(res["metrics"]) == {"members_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert np.isfinite(res["checks"]["max_rel_err"]["value"])
