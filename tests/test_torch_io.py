# The port's output layer (rmt_tpu_torch.io: save, plot) as
# tests/test_io.py holds rmt_tpu's: the save writers round-trip, the plot
# functions render under Agg with every show counted, and the
# display-result gate plots through the port's rmtExe (N2 here, N1 in
# tests/test_torch_api.py). Also the RMT_TORCH_PROFILE switch: a trace
# written, and a call inside a running profiler warned about and run
# untraced. On the CPU, at a narrow N2 (zNo 5, tNo 2).

import functools
import json
import os

import numpy as np
import pytest
import torch

import rmt_tpu_torch
from dme_case import make_model_input
from rmt_tpu_torch.io import save as io_save
from rmt_tpu_torch.models import homo as t_homo


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(t_homo, "build_spec",
                        functools.partial(t_homo.build_spec, z_no=5, t_no=2))


@pytest.fixture
def shown(monkeypatch):
    """matplotlib under Agg with plt.show counted."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    calls = []
    monkeypatch.setattr(plt, "show", lambda: calls.append(1))
    yield calls
    plt.close("all")


def _n2(period=0.02, **kw):
    return make_model_input(model="N2", op_period=period, **kw)


def test_save_text_and_csv_roundtrip(tmp_path):
    data = [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    p_txt = io_save.save_list_to_text(data, str(tmp_path / "out.txt"))
    lines = open(p_txt).read().strip().splitlines()
    assert len(lines) == 2 and "3.0" in lines[1]

    p_csv = io_save.save_list_to_csv(torch.tensor(data), ["a", "b", "c"],
                                     str(tmp_path / "out.csv"))
    rows = open(p_csv).read().strip().splitlines()
    assert rows[0] == "a,b,c"
    back = np.asarray([r.split(",") for r in rows[1:]], dtype=float)
    np.testing.assert_allclose(back, np.asarray(data))


def test_save_result_json_roundtrip(tmp_path, narrow):
    """A port rmtExe result with tensors added (one that wants a gradient)
    serialises and reads back to the same numbers."""
    res = rmt_tpu_torch.rmtExe(_n2(), device="cpu")
    res["extra"] = {"t": torch.arange(3.0, requires_grad=True) * 2,
                    "i": torch.tensor([1, 2], dtype=torch.int32)}
    path = io_save.save_result_json(res, str(tmp_path / "res.json"))
    loaded = json.load(open(path))
    for got, want in zip(loaded["resModel"]["dataPack"],
                         res["resModel"]["dataPack"]):
        np.testing.assert_allclose(np.asarray(got["dataYs"]), want["dataYs"])
    np.testing.assert_allclose(loaded["resModel"]["checkpoint"]["state"],
                               res["resModel"]["checkpoint"]["state"])
    assert loaded["extra"] == {"t": [0.0, 2.0, 4.0], "i": [1, 2]}


def test_plot_functions_render(shown):
    from rmt_tpu_torch.io import plot as io_plot

    xs = np.linspace(0, 1, 11)
    pack = {
        "modelId": "N2",
        "processType": "non-iso-thermal",
        "successStatus": True,
        "dataTime": 0.1,
        "dataXs": xs,
        "dataYs": np.vstack([xs, 1 - xs, 500 + xs]),
        "labelList": ["A", "B", "T"],
        "indexList": [2, 3, 2],
    }
    io_plot.plot_results_steady_state([pack])
    # dynamic plotting draws 2 random slices x (concentration +
    # temperature) figures = 4 shows (reference plotResultsDynamic
    # semantics, solResultAnalysis.py:373-459)
    io_plot.plot_results_dynamic(
        {"computation-time": 1.0, "dataPack": [pack, pack]}, t_no=2
    )
    io_plot.plot_xy_series(
        [{"x": xs, "y": xs**2, "leg": "sq"}], "x", "y", title="t"
    )
    assert len(shown) == 6


def test_plotclass_script_surface(shown):
    """The reference notebooks' plotClass surface (PyREMOT/library/
    plot.py:36-218)."""
    from rmt_tpu_torch.io.plot import plotClass

    xs = np.linspace(0, 1, 11)
    ys_list = [xs, xs**2, 1 - xs]
    labels = plotClass.makeLabels(["A", "B"], ["T"])
    assert labels == ["A", "B", "T"]

    xy = plotClass.plots2DSetXYList(xs, ys_list)
    assert len(xy) == 3 and xy[1][1] is ys_list[1]
    items = plotClass.plots2DSetDataList(xy, labels)
    assert items[2] == {"x": xs, "y": ys_list[2], "leg": "T"}

    plotClass.plots2D(items, "x", "y", title="t")       # list form
    plotClass.plots2D(items[0], "x", "y")               # single-item form
    plotClass.plots2DSub([items, items[:1]], "x", "y",
                         dataListPoint=[items[:1]])
    plotClass.plot2D(xs, ys_list[0])
    assert len(shown) == 4


def test_display_result_plots_n2(shown, narrow):
    """display-result "True" on N2 plots two random intervals, each its
    concentrations and its temperature: four shows after the run."""
    res = rmt_tpu_torch.rmtExe(_n2(display="True"), device="cpu")
    assert len(res["resModel"]["dataPack"]) == 2
    assert len(shown) == 4


def test_profile_switch_writes_a_trace(tmp_path, monkeypatch, narrow):
    """RMT_TORCH_PROFILE=<dir> writes one Chrome trace of the call into
    <dir>, with the run's operations in it; inside a running profiler the
    call warns and runs untraced. A period of 1e-6 s keeps the trace
    small (9 steps)."""
    out = tmp_path / "trace"
    monkeypatch.setenv("RMT_TORCH_PROFILE", str(out))
    res = rmt_tpu_torch.rmtExe(_n2(1e-6), device="cpu")
    assert res["resModel"]["dataPack"]
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.load(open(out / files[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::linalg_lu") for n in names)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.warns(RuntimeWarning, match="RMT_TORCH_PROFILE"):
            rmt_tpu_torch.rmtExe(_n2(1e-6), device="cpu")
    assert len(os.listdir(out)) == 1
