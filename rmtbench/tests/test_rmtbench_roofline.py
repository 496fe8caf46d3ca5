"""The work counts of rmtbench/roofline.py equal chip_smoke.py's kernel
table (PERF.md's "Bound ms" column, at chip_smoke's shapes: B = 4096,
z = 20, m = 7, n = 140, the RHS at M = 3B rows), and the configurations'
RHS counts equal the port's own (cuda_rhs.operation_count, the leaves of
cuda_rhs.pack_leaves)."""

import importlib
import json
import os

import pytest

from conftest import ROOT
from rmtbench import roofline

B, Z, M, N = 4096, 20, 7, 140


def config(name):
    with open(os.path.join(ROOT, "rmtbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def bound_ms(per_member):
    n_bytes, n_ops = per_member
    return round(roofline.least_seconds(B * n_bytes, B * n_ops) * 1e3, 4)


@pytest.mark.parametrize("kernel,work,table_ms", [
    ("block_factor", roofline.block_factor(M, Z), 0.0192),
    ("block_apply", roofline.block_apply(M, Z), 0.0233),
    ("block_apply_real", roofline.block_apply_real(M, Z), 0.0110),
    ("ns_fused_step", roofline.ns_step(N), 2.6840),
])
def test_kernel_bounds_equal_the_table(kernel, work, table_ms):
    assert bound_ms(work) == table_ms


@pytest.mark.parametrize("mode,table_ms", [("plain", 0.0043),
                                           ("df32", 0.0172)])
def test_rhs_bound_equals_the_table(mode, table_ms):
    cfg = config("dme_n2")
    work = roofline.rhs_call(N, 3, cfg["rhs_leaves_per_member"],
                             cfg["rhs_ops_per_row_node"][mode], Z)
    assert bound_ms(work) == table_ms


@pytest.mark.parametrize("name,case", [("dme_n2", "dme_case"),
                                       ("ch4_n2", "ch4_case")])
def test_rhs_counts_equal_the_ports(name, case):
    from rmt_tpu_torch.models import homo
    from rmt_tpu_torch.ops import cuda_rhs

    mod = importlib.import_module(f"rmt_tpu_torch.cases.{case}")
    spec = homo.build_spec(mod.make_model_input(model="N2"))
    cfg = config(name)
    assert cfg["rhs_ops_per_row_node"] == {
        "plain": cuda_rhs.operation_count(spec, False),
        "df32": cuda_rhs.operation_count(spec, "df32")}
    assert cfg["rhs_leaves_per_member"] == (
        len(cuda_rhs._P_1D) + len(cuda_rhs._D_1D) + 2 * spec.n_comp)


def test_sweep_work_counts_members_that_integrate():
    cfg = config("dme_n2")
    opts = dict(newton_iters=5, cheap_sweeps=2, accurate_rates="df32",
                j_every=8)
    stats = dict(n_accepted=[100, 50], n_rejected=[10, 0])
    per = (roofline.least_seconds(*roofline.block_factor(M, Z))
           + 5 * roofline.least_seconds(*roofline.block_apply(M, Z))
           + roofline.least_seconds(*roofline.block_apply_real(M, Z)))
    assert roofline.block_solve_seconds(stats, cfg, opts) == \
        pytest.approx(160 * per)
    # ns: one step an attempt, five after each of ceil(110 / 8) + ceil(50 /
    # 8) refreshes
    ns = (160 + 5 * (14 + 7)) * roofline.least_seconds(*roofline.ns_step(N))
    assert roofline.ns_seconds(stats, cfg, opts) == pytest.approx(ns)
