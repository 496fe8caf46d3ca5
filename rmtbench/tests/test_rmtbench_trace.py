"""The trace reduction on a hand-made event list: busy time as the union
of device intervals, kernels by name without namespaces and template
arguments, and the idle gaps named by the innermost host operation."""

import pytest

from rmtbench import trace


class Event:
    def __init__(self, kind, name, start, dur, tid=1):
        self.kind, self._name, self.s, self.d, self.tid = (
            kind, name, start, dur, tid)

    def device_type(self):
        return f"DeviceType.{self.kind}"

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def start_thread_id(self):
        return self.tid


EVENTS = [
    Event("CPU", "aten::add", 0, 1000),
    Event("CPU", "cudaLaunchKernel", 100, 50),
    Event("CPU", "aten::mul", 1000, 2000),
    Event("CPU", "aten::item", 3000, 500),
    Event("CUDA", "void (anonymous namespace)::factor_kernel<7>(float "
          "const*, int)", 200, 300),
    Event("CUDA", "void n2_rhs_kernel<4>(float const*)", 400, 200),
    Event("CUDA", "Memcpy DtoH (Device -> Pinned)", 3100, 100),
    Event("CPU", "other thread", 0, 4000, tid=2),
]


def test_reduction():
    tr = trace.Trace(EVENTS, window_s=4000e-9)
    # [200, 600) and [3100, 3200)
    assert tr.busy_ns == 500
    assert tr.gaps == [(600, 3100)]
    assert [k[2] for k in tr.kernels] == [EVENTS[4].name(),
                                          EVENTS[5].name()]
    assert tr.layer_seconds({"factor_kernel"}) == pytest.approx(300e-9)
    assert tr.layer_seconds({"n2_rhs_kernel", "factor_kernel"}) == \
        pytest.approx(400e-9)
    assert tr.device_ops()[0] == ["factor_kernel<7>", 300e-9]
    # the gap's middle, 1850, lies in aten::mul
    assert tr.idle_gaps() == [["aten::mul", 2500e-9]]
