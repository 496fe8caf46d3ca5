# The port's dynamic packed-bed model M9 (coupled pressure and velocity
# marches) end to end against rmt_tpu on the CPU in float64: rmt_tpu's
# rmtExe M9 exhausts its attempt budget (no rmt_tpu test runs it), and the
# port must fail the same way, not succeed with another budget or
# solver. Its RHS and Jacobian: tests/test_torch_models.py.

import pytest

import rmt_tpu
import rmt_tpu_torch
from rmt_tpu_torch.cases import pb_case


def test_rmtexe_m9_raises_like_rmt_tpu():
    """rmt_tpu's M9 run exhausts its attempt budget (max(1024, 256 tNo))
    at the first output segment; the port's does too, with the same
    RuntimeError (zNo 5, tNo 1)."""
    def mi():
        m = pb_case.conc_model_input("M9", kmol=True)
        m["solver-config"]["zNo"] = 5
        m["solver-config"]["tNo"] = 1
        return m

    msg = "M9: lockstep integrator exhausted its attempt budget at output " \
          "segment 0/1"
    with pytest.raises(RuntimeError) as want:
        rmt_tpu.rmtExe(mi())
    assert str(want.value) == msg
    with pytest.raises(RuntimeError) as got:
        rmt_tpu_torch.rmtExe(mi(), device="cpu")
    assert str(got.value) == msg
