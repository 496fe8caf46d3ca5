# Result plotting (host-side matplotlib; port of rmt_tpu/io/plot.py),
# gated by solver-config display-result == "True" exactly like the
# reference (reference: PyREMOT/solvers/solResultAnalysis.py:307-459,
#  PyREMOT/library/plot.py:36-201). matplotlib is imported at the first
# plot, never with the module: a run that plots nothing needs none.

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib.pyplot as plt

    return plt


def plot_results_steady_state(data_pack) -> None:
    plt = _plt()
    pack = data_pack[0]
    xs = np.asarray(pack["dataXs"])
    ys = np.asarray(pack["dataYs"])
    labels = pack["labelList"]
    n_comp = pack["indexList"][0]

    fig, axes = plt.subplots(1, 2 if ys.shape[0] > n_comp else 1, figsize=(10, 4))
    axes = np.atleast_1d(axes)
    for i in range(n_comp):
        axes[0].plot(xs, ys[i], label=labels[i])
    axes[0].set_xlabel("dimensionless reactor length")
    axes[0].set_ylabel("mole fraction")
    axes[0].legend(fontsize=7)
    if ys.shape[0] > n_comp and len(axes) > 1:
        for j in range(n_comp, ys.shape[0]):
            axes[1].plot(xs, ys[j], label=labels[min(j, len(labels) - 1)])
        axes[1].set_xlabel("dimensionless reactor length")
        axes[1].legend(fontsize=7)
    fig.tight_layout()
    plt.show()


def select_random_for_list(items, n):
    """n distinct random picks (reference solResultAnalysis.py
    selectRandomForList semantics: sampling without replacement)."""
    import random

    n = min(n, len(items))
    return random.sample(list(items), n)


def plot_results_dynamic(res_pack, t_no: int, n_slices: int = 2) -> None:
    """Reference plotResultsDynamic semantics
    (solResultAnalysis.py:373-459): pick `n_slices` RANDOM time
    intervals from the dataPack, and for each successful one draw the
    concentration series and (non-isothermal only) the temperature
    series as separate figures, titled with the interval's dataTime."""
    elapsed = res_pack.get("computation-time")
    data_pack = res_pack["dataPack"]
    first = data_pack[0]
    model_id = first.get("modelId", "")
    process_type = first.get("processType", "")
    labels = first["labelList"]
    n_comp, _idx_p, idx_t = first["indexList"][:3]
    base_title = f"Dynamic Modeling {model_id}, computation-time {elapsed}"

    for i in select_random_for_list(range(min(t_no, len(data_pack))),
                                    n_slices):
        pack = data_pack[i]
        if pack.get("successStatus") is not True:
            continue
        xs = np.asarray(pack["dataXs"])
        ys = np.asarray(pack["dataYs"])
        title = base_title + f" at t={pack.get('dataTime')}"
        series = plots2DSetDataList(plots2DSetXYList(xs, ys), labels)
        plots2D(series[0:n_comp], "Reactor Length (m)",
                "Concentration (mol/$m^3$)", title)
        if process_type != "iso-thermal" and idx_t < len(series):
            plots2D([series[idx_t]], "Reactor Length (m)",
                    "Temperature (K)", title)


def plot_xy_series(data_list, x_label, y_label, title=""):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    for item in data_list:
        ax.plot(np.asarray(item["x"]), np.asarray(item["y"]), label=item["leg"])
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    if title:
        ax.set_title(title)
    ax.legend(fontsize=7)
    fig.tight_layout()
    plt.show()


# ---------------------------------------------------------------------------
# User-callable plotting surface with the reference's script-level API
# (PyREMOT/library/plot.py:36-218: plotClass.plots2D / plots2DSub /
# plots2DSetXYList / plots2DSetDataList / makeLabels). The reference's
# notebooks call these directly on dataPack series, so they are part of
# the public surface, not internals. Data items are dicts
# {"x": pts, "y": pts, "leg": name}; each argument may be one item or a
# list of items.
# ---------------------------------------------------------------------------


def _as_items(data):
    """Normalize one-item-or-list to a list of {"x","y","leg"} dicts."""
    items = data if isinstance(data, list) else [data]
    return [
        {"x": np.asarray(it["x"]), "y": np.asarray(it["y"]),
         "leg": it.get("leg", "line")}
        for it in items
    ]


def plot2D(x, y, type="LINE"):
    """Single-series quick plot (reference plot.py:24-33)."""
    plt = _plt()
    plt.plot(np.asarray(x), np.asarray(y))
    plt.show()


def plots2D(data, xLabel, yLabel, title=""):
    """Multi-line plot from {"x","y","leg"} items (reference plot.py:36-82)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    for it in _as_items(data):
        ax.plot(it["x"], it["y"], label=it["leg"])
    if title:
        ax.set_title(title)
    ax.set_xlabel(xLabel)
    ax.set_ylabel(yLabel)
    ax.legend()
    fig.tight_layout()
    plt.show()


def plots2DSetXYList(X, Ys):
    """Pair one x vector with each y series (reference plot.py:85-90)."""
    return [[X, y] for y in Ys]


def plots2DSetDataList(XYList, labelList):
    """[(x, y)] + labels -> plots2D items (reference plot.py:93-115)."""
    return [
        {"x": xy[0], "y": xy[1], "leg": leg}
        for xy, leg in zip(XYList, labelList)
    ]


def plots2DSub(dataList, xLabel, yLabel, title="", dataListPoint=()):
    """One stacked subplot per entry of dataList; optional scatter
    overlays per subplot via dataListPoint (reference plot.py:118-201)."""
    plt = _plt()
    n = len(dataList)
    fig, axes = plt.subplots(n, figsize=(8, 2.5 * n), squeeze=False)
    axes = axes.ravel()
    for ax, data in zip(axes, dataList):
        for it in _as_items(data):
            ax.plot(it["x"], it["y"], label=it["leg"])
        ax.legend(fontsize=7)
    for ax, pts in zip(axes, dataListPoint):
        for it in _as_items(pts):
            ax.scatter(it["x"], it["y"], alpha=0.5)
    if title:
        axes[0].set_title(title)
    axes[-1].set_xlabel(xLabel)
    axes[-1].set_ylabel(yLabel)
    fig.tight_layout()
    plt.show()


def makeLabels(*kid):
    """Flatten label groups into one list (reference plot.py:204-218)."""
    labels = []
    for group in kid:
        labels.extend(group)
    return labels


class plotClass:
    """Reference-compatible namespace: scripts written against
    `from PyREMOT.library.plot import plotClass` keep working with
    `from rmt_tpu_torch.io.plot import plotClass` (plot.py:10-218)."""

    plot2D = staticmethod(plot2D)
    plots2D = staticmethod(plots2D)
    plots2DSetXYList = staticmethod(plots2DSetXYList)
    plots2DSetDataList = staticmethod(plots2DSetDataList)
    plots2DSub = staticmethod(plots2DSub)
    makeLabels = staticmethod(makeLabels)
