"""Each cell's control comes out not correct, on the card, at the cell's
own size (the run as the benchmark makes it, with the program run as the
control that limits/<cell>.json names: plain float32 kinetics for the DME
cell, TF32 on for the CH4 cell)."""

import json
import os

import pytest

from conftest import ROOT
from rmtbench import harness

CELLS = ("dme_f32x_b131072", "ch4_f32x_b131072")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    with open(os.path.join(ROOT, "rmtbench", "limits", f"{name}.json")) as f:
        control = json.load(f)["control"]
    try:
        res = harness.run_cell(name, 4000000001, 0.0, False, ROOT, "cuda:0",
                               control=control)
    finally:
        harness.set_tf32(False)
    assert not res["correct"], res["checks"]
