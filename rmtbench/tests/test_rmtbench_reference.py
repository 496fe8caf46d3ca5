"""The frozen float64 reference held to the truth on the CPU: its RHS
equals rmt_tpu_torch's float64 N2 RHS to round-off at seeded states of
both chemistries, and its integration meets bench_ref.npz's probes."""

import importlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from rmtbench.reference import n2

CASES = {"dme_n2": ("dme_case", "dme"), "ch4_n2": ("ch4_case", "ch4")}


def config(name):
    with open(os.path.join(ROOT, "rmtbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def chemistry(name):
    path = os.path.join(ROOT, "rmtbench", "configs", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"chem_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CHEMISTRY


@pytest.mark.parametrize("name", sorted(CASES))
def test_rhs_equals_the_ports_float64_rhs(name):
    from rmt_tpu_torch.models import homo

    case = importlib.import_module(f"rmt_tpu_torch.cases.{CASES[name][0]}")
    mi = case.make_model_input(model="N2")
    spec = homo.build_spec(mi)
    f = homo.make_n2_rhs(spec)
    cfg, chem = config(name), chemistry(name)
    rng = np.random.default_rng(7)
    for dt0 in (-4.3, 0.0, 2.7):
        t0 = cfg["t_base_K"] + dt0
        p = homo.build_params(mi, dtype=torch.float64, device="cpu")
        p["T0"] = torch.tensor(t0, dtype=torch.float64)
        d = homo.feed_state(spec, p)
        y0 = homo.n2_initial_state(spec, p, d).numpy()
        rhs, dd = n2.make_rhs(chem, n2.member_params(cfg, t0), cfg["z_no"])
        assert np.allclose(n2.initial_state(chem, n2.member_params(cfg, t0),
                                            dd, cfg["z_no"]), y0,
                           rtol=1e-15, atol=1e-15)
        for _ in range(4):
            y = y0 * (1 + 0.05 * rng.uniform(-1, 1, y0.shape)) \
                + 0.01 * rng.uniform(0, 1, y0.shape)
            want = f(torch.tensor(0.0, dtype=torch.float64),
                     torch.tensor(y), p, d).numpy()
            got = rhs(0.0, y)
            # round-off of a few hundred float64 operations
            assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
            # the columns at once, as SciPy's Jacobian asks for them
            both = rhs(0.0, np.stack([y, y0], axis=1))
            assert np.allclose(both[:, 0], got, rtol=0, atol=0)


@pytest.mark.parametrize("name,probes", [("ch4_n2", (0, 15)),
                                         ("dme_n2", (32,))])
def test_integration_meets_bench_ref(name, probes):
    """bench_ref.npz is rmt_tpu's float64 Radau at rtol 1e-9 (CPU); the
    two independent integrators agree to 3.6e-10 on these probes."""
    key = CASES[name][1]
    with np.load(os.path.join(ROOT, "bench_ref.npz")) as z:
        offs, ys = z[f"{key}_offsets"], z[f"{key}_ys"]
        t_base = float(z[f"{key}_t_base"])
    cfg, chem = config(name), chemistry(name)
    for i in probes:
        got = n2.integrate(chem, cfg, t_base + offs[i])
        rel = np.abs(got - ys[:, i]) / np.maximum(np.abs(ys[:, i]), 1e-7)
        assert rel.max() < 2e-9, (name, i, rel.max())
