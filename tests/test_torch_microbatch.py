# microbatch of the port's lockstep ensemble
# (rmt_tpu_torch.parallel.run_n2_ensemble_lockstep(microbatch=K)): a host
# loop over member slices whose joined result is each slice's separate
# call, held to rmt_tpu's microbatch scan, with bench.py's f32x options
# (df32 kinetics, exact block solves, 2 cheap sweeps) on a short DME
# period at rtol 1e-4 to keep the CPU time small. On the CPU every kernel
# of the path runs as its plain PyTorch twin.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dme_case import make_model_input
from rmt_tpu.parallel import run_n2_ensemble_lockstep as j_run
from rmt_tpu_torch.cases.dme_case import make_model_input as t_input
from rmt_tpu_torch.parallel import run_n2_ensemble_lockstep as t_run

T0 = 523.0 + np.array([-4.0, -1.0, 2.0, 5.0])
PERIOD = 0.01
KW = dict(max_steps=768, rtol=1e-4, atol=1e-6, newton_iters=5, j_every=8,
          accurate_rates="df32", exact_solve=True, cheap_sweeps=2)


@pytest.fixture(scope="module")
def microbatched():
    return t_run(t_input(model="N2", op_period=PERIOD), {"T0": T0},
                 microbatch=2, device="cpu", **KW)


def test_microbatch_equals_separate_calls(microbatched):
    """microbatch=2 at B = 4 is the two slices' separate calls joined, bit
    for bit: states and per-member statistics concatenated, the scalar
    counters summed."""
    ys, st = microbatched
    mi = t_input(model="N2", op_period=PERIOD)
    parts = [t_run(mi, {"T0": T0[lo:lo + 2]}, device="cpu", **KW)
             for lo in (0, 2)]
    assert tuple(ys.shape) == (6, 4, 140)
    assert torch.equal(ys, torch.cat([p[0] for p in parts], dim=1))
    for name in ("n_fev", "n_accepted", "n_rejected", "seg", "n_rej_conv",
                 "n_rej_err", "n_rej_rho"):
        want = torch.cat([getattr(p[1], name) for p in parts])
        assert torch.equal(getattr(st, name), want), name
    assert st.n_jev == sum(p[1].n_jev for p in parts)
    assert st.n_rescue == sum(p[1].n_rescue for p in parts)


def test_microbatch_matches_jax_microbatch(microbatched):
    """Against rmt_tpu's microbatch=2 scan on the same sweep: the bar of
    tests/test_torch_lockstep.py (5e-4 relative, denominator
    max(|ref|, 1e-7)); every member finishes in both, attempts within
    1.25x, the summed Jacobian refreshes equal."""
    ys_t, st_t = microbatched
    ys_j, st_j = j_run(make_model_input(model="N2", op_period=PERIOD),
                       {"T0": jnp.asarray(T0)}, microbatch=2, **KW)
    ys_j = np.asarray(ys_j, np.float64)
    assert tuple(ys_t.shape) == ys_j.shape
    assert int(torch.sum(st_t.seg < 5)) == 0
    assert int(np.sum(np.asarray(st_j.seg) < 5)) == 0
    rel = np.abs(ys_t.numpy().astype(np.float64) - ys_j) / np.maximum(
        np.abs(ys_j), 1e-7)
    assert float(rel.max()) < 5e-4, float(rel.max())
    att_t = (st_t.n_accepted + st_t.n_rejected).numpy()
    att_j = np.asarray(st_j.n_accepted + st_j.n_rejected)
    assert att_t.max() <= 1.25 * att_j.max(), (att_t, att_j)
    assert st_t.n_jev == int(st_j.n_jev)


def test_microbatch_refusals():
    """The reference's refusals: a member count that is not a multiple of
    the microbatch, and out_members (global indices) with microbatches
    (local ones). Both raise before anything is integrated."""
    mi = t_input(model="N2", op_period=PERIOD)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        t_run(mi, {"T0": T0[:3]}, microbatch=2, device="cpu", **KW)
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_run(mi, {"T0": T0}, microbatch=2, out_members=np.array([0]),
              device="cpu", **KW)


def test_microbatch_not_below_the_batch_is_one_call():
    """microbatch >= B is the single call (out_members allowed), as in
    the reference, where only b_total > microbatch splits."""
    mi = t_input(model="N2", op_period=0.002)
    kw = dict(KW, max_steps=8)
    ys_sel, y_fin, st = t_run(mi, {"T0": T0[:2]}, microbatch=2,
                              out_members=np.array([1]), device="cpu", **kw)
    ys, st_one = t_run(mi, {"T0": T0[:2]}, device="cpu", **kw)
    assert torch.equal(ys_sel, ys[:, [1]])
    assert torch.equal(st.n_accepted, st_one.n_accepted)
