# The port's public API (rmt_tpu_torch.rmtExe / rmtCom, api/rmt.py)
# against rmt_tpu's on the CPU in float64: N1 non-isothermal and
# isothermal, N2 at a narrow grid (zNo 5, tNo 2: both packages'
# build_spec are given these, since rmtExe takes the N2 grid from
# HomoSpec's defaults), checkpoint/resume, the solver-config routes,
# display-result on N1, the schema gate of tests/test_api_schema.py, and
# the device rules.

import functools

import numpy as np
import pytest
import torch

import rmt_tpu
import rmt_tpu_torch
from dme_case import make_model_input
from rmt_tpu.models import homo as j_homo
from rmt_tpu_torch.api import rmt as t_rmt
from rmt_tpu_torch.cases import hetero_case
from rmt_tpu_torch.models import homo as t_homo


def t_exe(mi):
    return rmt_tpu_torch.rmtExe(mi, device="cpu")


def _assert_same(got, want, rtol=1e-6):
    """Same keys, the same values of the layout keys, and arrays of the
    same shape equal to rtol (float64 noise floor 1e-12)."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == "computation-time":
            continue
        if key == "solverStats":
            assert set(g) == set(w)
            continue
        if isinstance(w, (list, tuple)) or np.ndim(w) == 0 or key in (
                "labelList", "indexList", "dataShape"):
            if key in ("dataTime",) or isinstance(w, (float, np.floating)):
                np.testing.assert_allclose(g, w, rtol=1e-12)
            else:
                assert g == w or np.array_equal(np.asarray(g),
                                                np.asarray(w)), key
            continue
        w = np.asarray(w)
        g = np.asarray(g)
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12 * np.max(
            np.abs(w)) if w.size else 0, err_msg=key)


@pytest.fixture(scope="module")
def narrow():
    """zNo 5, tNo 2 in both packages' N2 spec for the module."""
    mp = pytest.MonkeyPatch()
    for mod in (j_homo, t_homo):
        mp.setattr(mod, "build_spec",
                   functools.partial(mod.build_spec, z_no=5, t_no=2))
    yield
    mp.undo()


PERIOD = 0.1   # N2's period here (the DME case's default is 0.5)


@pytest.fixture(scope="module")
def n2_pair(narrow):
    mi = make_model_input(model="N2", op_period=PERIOD)
    return rmt_tpu.rmtExe(mi)["resModel"], t_exe(mi)["resModel"]


@pytest.mark.parametrize("process", ["non-iso-thermal", "iso-thermal"])
def test_rmtexe_n1_matches_jax(process):
    mi = make_model_input(model="N1", process_type=process)
    want = rmt_tpu.rmtExe(mi)
    got = t_exe(mi)
    assert set(got) == set(want) == {"resModel", "comTime"}
    assert len(got["resModel"]) == len(want["resModel"]) == 1
    g, w = got["resModel"][0], want["resModel"][0]
    _assert_same(g, w)
    assert g["dataYs"].shape == (8 if process == "non-iso-thermal" else 7,
                                 101)
    assert g["solverStats"]["n_unreached"] == 0


def test_rmtexe_n2_matches_jax(n2_pair):
    want, got = n2_pair
    assert set(got) == set(want)
    assert len(got["dataPack"]) == len(want["dataPack"]) == 2
    for g, w in zip(got["dataPack"], want["dataPack"]):
        _assert_same(g, w)
        assert np.asarray(g["dataYCons1"]).shape == (6, 5)
    np.testing.assert_allclose([p["dataTime"] for p in got["dataPack"]],
                               [PERIOD / 2, PERIOD], rtol=1e-15)
    assert set(got["solverStats"]) == set(want["solverStats"])
    assert got["checkpoint"]["model"] == "N2"
    assert got["checkpoint"]["t"] == want["checkpoint"]["t"] == PERIOD
    np.testing.assert_allclose(got["checkpoint"]["state"],
                               want["checkpoint"]["state"], rtol=1e-6)


def test_rmtexe_n2_resume_matches_single_run(n2_pair):
    """Two chained half-period runs (checkpoint -> resume-state) land on
    the state of one run over the period (tests/test_n2.py's check)."""
    _, full = n2_pair
    half = PERIOD / 2
    res_a = t_exe(make_model_input(model="N2", op_period=half))["resModel"]
    ck = res_a["checkpoint"]
    assert ck["model"] == "N2" and abs(ck["t"] - half) < 1e-12
    mi_b = make_model_input(model="N2", op_period=half)
    mi_b["resume-state"] = ck
    res_b = t_exe(mi_b)["resModel"]
    assert abs(res_b["dataPack"][-1]["dataTime"] - PERIOD) < 1e-12
    np.testing.assert_allclose(res_b["checkpoint"]["state"],
                               full["checkpoint"]["state"], rtol=1e-5,
                               atol=1e-8)
    mi_bad = make_model_input(model="N2", op_period=half)
    mi_bad["resume-state"] = dict(ck, state=ck["state"][:-1])
    with pytest.raises(ValueError, match="resume-state"):
        t_exe(mi_bad)


def test_stiff_ivp_names_route_to_one_integrator(narrow):
    """LSODA and BDF both run the Radau IIA(5) integrator: equal arrays
    (the narrow N2 over a short period keeps it short)."""
    out = []
    for ivp in ("LSODA", "BDF"):
        mi = make_model_input(model="N2", op_period=0.02, ivp=ivp)
        res = t_exe(mi)["resModel"]
        out.append(np.stack([p["dataYs"] for p in res["dataPack"]]))
    assert np.array_equal(out[0], out[1])


def test_fixed_stepper_divergence_raises():
    mi = make_model_input(model="N1", ivp="AM")
    with pytest.raises(RuntimeError, match="AM"):
        t_exe(mi)


@pytest.mark.parametrize("model", ["M10", "M11", "M12", "M13"])
def test_dyn_model_refuses_another_models_checkpoint(model):
    """The router of the dynamic heterogeneous models (every model id is
    ported): a resume-state of another model raises ValueError before any
    integration, as rmt_tpu's _resume_or and _run_m13 do."""
    mi = hetero_case.dyn_model_input(model, dict(zNo=4, rNo=3, tNo=1))
    mi["resume-state"] = {"model": "M2", "t": 0.0, "state": np.zeros(4)}
    with pytest.raises(ValueError, match="resume-state is for model 'M2'"):
        t_exe(mi)


def test_unknown_model_id_raises_not_implemented():
    with pytest.raises(NotImplementedError):
        t_exe(make_model_input(model="M6"))


def test_display_result_is_not_ported(monkeypatch):
    """display-result "True" on N1 plots the profiles through the port's
    io/plot after the run (one figure, one show, as rmt_tpu's
    tests/test_io.py counts), and returns the result unchanged."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(1))
    res = t_exe(make_model_input(model="N1", display="True"))
    plt.close("all")
    assert len(shown) == 1
    assert res["resModel"][0]["dataYs"].shape == (8, 101)


def _typo(mi, section, key):
    mi[section][key] = 1.0


@pytest.mark.parametrize("mutate, match, err", [
    (lambda mi: mi.__setitem__("reactor-config", {}), "reactor-config",
     ValueError),
    (lambda mi: _typo(mi, "operating-conditions", "presure"), "presure",
     ValueError),
    (lambda mi: _typo(mi, "solver-config", "rtoll"), "rtoll", ValueError),
    (lambda mi: mi.pop("model"), "model", ValueError),
    (lambda mi: mi["feed"].pop("components"), "components", ValueError),
    (lambda mi: mi.__setitem__("reaction-rates",
                               {"VARS": {}, "RATES": [1, 2]}), "RATES",
     ValueError),
    (lambda mi: mi.__setitem__("reactions", {"R1": 42}), "reaction",
     ValueError),
    (lambda mi: mi["solver-config"].__setitem__("ivp", "LSODAX"), "LSODAX",
     ValueError),
    (lambda mi: mi["solver-config"].__setitem__("mesh", "refined"),
     "mesh", ValueError),
    (lambda mi: mi["feed"]["components"].__setitem__("shell", ["CO2", "Xe"]),
     "Xe", KeyError),
], ids=["top-level", "operating-condition", "solver-config", "model-id",
        "components", "reaction-rates", "reactions", "ivp", "mesh",
        "unknown-component"])
def test_schema_rejections_mirror_jax(mutate, match, err):
    """Each malformed modelInput raises as rmt_tpu.rmtExe raises
    (tests/test_api_schema.py), before any device is touched."""
    for exe in (rmt_tpu.rmtExe, rmt_tpu_torch.rmtExe):
        mi = make_model_input(model="N1")
        mutate(mi)
        with pytest.raises(err, match=match):
            exe(mi)


def test_rmtexe_wants_the_card_by_default():
    """Without device= rmtExe runs on the CUDA card: on a host without
    one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rmt_tpu_torch.rmtExe(make_model_input(model="N1"))


def test_rmtcom_and_package_exports():
    assert rmt_tpu_torch.rmtCom() == rmt_tpu.rmtCom()
    assert rmt_tpu_torch.rmtExe is t_rmt.rmtExe
    assert set(t_rmt._MODEL_IDS) == set(rmt_tpu.api.rmt._MODEL_IDS)
