"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run of the small CPU cell (the card's
look skipped) with the program replaced by a broken one, for each fault
these cells can have: a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced. The cells
take one card, so no exchange between cards can be left out. The sound
program passes the same run."""

import pytest
import torch

from conftest import TINY
from rmtbench import harness


def broken(fault, real):
    """The program ``real`` with ``fault`` planted."""

    def program(mi, sweep, out_members, device, **opts):
        t0 = sweep["T0"]
        if fault == "half_left_out":
            half = len(t0) // 2
            keep = [i for i in out_members if i < half]
            _, y_half, st = real(mi, {"T0": t0[:half]},
                                 out_members=keep or [0], device=device,
                                 **opts)
            ys, y_fin, stats = real(mi, sweep, out_members=out_members,
                                    device=device, **dict(opts, max_steps=0))
            y_fin[:half] = y_half
            seg = stats.seg.clone()
            seg[:half] = st.seg
            return ys, y_fin, stats._replace(seg=seg)
        ys, y_fin, stats = real(mi, sweep, out_members=out_members,
                                device=device, **opts)
        if fault == "state_unchanged":
            ys = ys[:1].expand_as(ys).clone()
        elif fault == "answer_altered":
            ys = ys.clone()
            ys[1:] *= 1.0 + 1e-4
        return ys, y_fin, stats

    return program


@pytest.fixture
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct(tiny_root, cpu_threads):
    res = harness.run_cell(TINY, 5, 0.0, False, tiny_root, "cpu")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_fault_is_not_correct(fault, tiny_root, cpu_threads, monkeypatch):
    bad = broken(fault, harness.program())
    monkeypatch.setattr(harness, "program", lambda: bad)
    res = harness.run_cell(TINY, 5, 0.0, False, tiny_root, "cpu")
    assert not res["correct"], (fault, res["checks"])
