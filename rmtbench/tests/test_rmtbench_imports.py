"""Nothing the harness or the reference loads is jax, jaxlib, flax or
rmt_tpu (top-level names compared whole: rmt_tpu_torch begins with
rmt_tpu), and the reference loads nothing of rmt_tpu_torch either."""

import json
import subprocess
import sys

from conftest import ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "rmt_tpu"}


def loaded_after(code, cwd=ROOT):
    """The top-level names of the modules a fresh interpreter holds after
    running ``code``."""
    probe = (f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=cwd,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    names = loaded_after(
        "import importlib, json\n"
        "from rmtbench import check\n"
        "cfg = json.load(open('rmtbench/configs/ch4_n2.json'))\n"
        "check.reference_member('rmtbench/configs/ch4_n2.py', cfg, "
        "973.0)\n"
        "check.reference_member('rmtbench/configs/dme_n2.py', "
        "json.load(open('rmtbench/configs/dme_n2.json')), 523.0)")
    assert not names & (FORBIDDEN | {"rmt_tpu_torch", "torch"})


def test_harness_run_loads_no_jax(tiny_root):
    names = loaded_after(
        "import torch; torch.set_num_threads(2)\n"
        "from rmtbench import harness\n"
        f"r = harness.run_cell({TINY!r}, 3, 0.0, False, {tiny_root!r}, "
        "'cpu')\n"
        "assert r['correct'], r")
    assert "rmt_tpu_torch" in names
    assert not names & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from rmtbench import harness

    monkeypatch.setitem(sys.modules, "rmt_tpu_torch_x", sys)
    assert "rmt_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
