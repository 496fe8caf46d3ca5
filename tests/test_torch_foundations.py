# Foundations of the PyTorch port (rmt_tpu_torch): the copied tables and
# stoichiometry equal rmt_tpu's bit for bit, the package imports no jax,
# the jax-free DME and CH4 cases equal the test fixtures, and the parameter
# conversion feeds both packages the same numbers.

import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ch4_case
import dme_case
from clock import CHILD_LIMIT_S
from rmt_tpu import constants as jc
from rmt_tpu.data import defaults as jdef
from rmt_tpu.data import species as jsp
from rmt_tpu.kinetics import Stoichiometry as JStoich
from rmt_tpu.kinetics import compile_rate_program as j_compile
from rmt_tpu.models import homo as jhomo
from rmt_tpu_torch import config as tconfig
from rmt_tpu_torch import constants as tc
from rmt_tpu_torch.cases import ch4_case as t_ch4_case
from rmt_tpu_torch.cases import dme_case as t_dme_case
from rmt_tpu_torch.convert import params_from_jax
from rmt_tpu_torch.data import defaults as tdef
from rmt_tpu_torch.data import species as tsp
from rmt_tpu_torch.kinetics import Stoichiometry as TStoich
from rmt_tpu_torch.kinetics import compile_rate_program as t_compile
from rmt_tpu_torch.utils import round as tround
from rmt_tpu.utils import round as jround

ROOT = Path(__file__).resolve().parent.parent


def _tables(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
            and not callable(v)}


@pytest.mark.parametrize("pair", [
    (jsp, tsp), (jdef, tdef), (jc, tc), (jround, tround)],
    ids=["species", "defaults", "constants", "round"])
def test_tables_equal_bit_for_bit(pair):
    ref, port = _tables(pair[0]), _tables(pair[1])
    assert ref.keys() == port.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == port[k].dtype, k
            np.testing.assert_array_equal(port[k], v, err_msg=k)
        else:
            assert port[k] == v, k


@pytest.mark.parametrize("case", [dme_case, ch4_case], ids=["dme", "ch4"])
def test_stoichiometry_equal_bit_for_bit(case):
    ref = JStoich(case.REACTION_SET, case.COMP_LIST)
    port = TStoich(case.REACTION_SET, case.COMP_LIST)
    for k in ("nu_comp", "eq_nu", "eq_idx", "dh_rxn_25"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    assert port.eq_symbols == ref.eq_symbols


def test_feed_helpers_equal():
    for args in ((1.0, 0.5), (2.0, 0.25)):
        np.testing.assert_array_equal(tdef.setFeedMoleFraction(*args),
                                      jdef.setFeedMoleFraction(*args))


def test_import_is_jax_free():
    """Importing every module of the port leaves jax and rmt_tpu out of
    sys.modules (the card's machine has no jax)."""
    mods = ["rmt_tpu_torch"] + sorted(
        "rmt_tpu_torch." + ".".join(p.relative_to(ROOT / "rmt_tpu_torch")
                                    .with_suffix("").parts)
        for p in (ROOT / "rmt_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'rmt_tpu' or "
              "m.startswith('rmt_tpu.'))\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=CHILD_LIMIT_S)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "rmt_tpu_torch.parallel.ensemble" in mods


def test_tf32_is_off_after_import():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert tconfig.default_float() in (torch.float32, torch.float64)


def _strip(mi):
    """modelInput without the kinetics lambdas (compared separately)."""
    out = {k: v for k, v in mi.items() if k != "reaction-rates"}
    out["feed"] = dict(mi["feed"])
    out["feed"]["concentration"] = np.asarray(mi["feed"]["concentration"])
    return out


@pytest.mark.parametrize("kw", [{}, dict(model="N2", T=528.0, P=4e6)],
                         ids=["default", "n2"])
def test_jax_free_dme_case_equals_fixture(kw):
    ref = dme_case.make_model_input(**kw)
    port = t_dme_case.make_model_input(**kw)
    a, b = _strip(ref), _strip(port)
    np.testing.assert_array_equal(b["feed"].pop("concentration"),
                                  a["feed"].pop("concentration"))
    assert a == b
    assert (ref["reaction-rates"]["VARS"].keys()
            == port["reaction-rates"]["VARS"].keys())
    assert (ref["reaction-rates"]["RATES"].keys()
            == port["reaction-rates"]["RATES"].keys())
    for name in ("REACTION_SET", "COMP_LIST", "REA_D", "REA_L", "BED_POR",
                 "CAT_D", "CAT_RHO", "CAT_CP", "BULK_RHO", "R_CONST"):
        assert getattr(t_dme_case, name) == getattr(dme_case, name), name


def test_jax_free_dme_case_rates_equal_fixture():
    """The copy's kinetics give the original's rates (float64, both
    packages' DSL evaluators)."""
    rng = np.random.default_rng(11)
    T = rng.uniform(500, 560, 16)
    P = rng.uniform(4.5e6, 5e6, 16)
    mf = rng.dirichlet(np.ones(6), 16).T
    conc = mf * 1149.83
    ref = np.asarray(j_compile(dme_case.dme_kinetics())(
        jnp.asarray(T), jnp.asarray(P), jnp.asarray(mf), jnp.asarray(conc)))
    tt = lambda a: torch.as_tensor(a, dtype=torch.float64)
    port = t_compile(t_dme_case.dme_kinetics())(tt(T), tt(P), tt(mf),
                                                tt(conc)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-13, atol=0)


@pytest.mark.parametrize("kw", [{}, dict(T=978.0, P=2.5e5, op_period=5.0)],
                         ids=["default", "swept"])
def test_jax_free_ch4_case_equals_fixture(kw):
    ref = ch4_case.make_model_input(**kw)
    port = t_ch4_case.make_model_input(**kw)
    a, b = _strip(ref), _strip(port)
    np.testing.assert_array_equal(b["feed"].pop("concentration"),
                                  a["feed"].pop("concentration"))
    assert a == b
    for part in ("VARS", "RATES"):
        assert (ref["reaction-rates"][part].keys()
                == port["reaction-rates"][part].keys())
    assert (port["reaction-rates"]["VARS"]["k0"]
            == ref["reaction-rates"]["VARS"]["k0"])
    for name in ("REACTION_SET", "COMP_LIST", "BED_POR", "CAT_D", "CAT_RHO",
                 "CAT_CP", "BULK_RHO"):
        assert getattr(t_ch4_case, name) == getattr(ch4_case, name), name


def test_jax_free_ch4_case_rates_equal_fixture():
    """The copy's kinetics give the original's rate (float64, both
    packages' DSL evaluators)."""
    rng = np.random.default_rng(12)
    T = rng.uniform(950, 1000, 16)
    P = rng.uniform(2.5e5, 3e5, 16)
    mf = rng.dirichlet(np.ones(3), 16).T
    conc = mf * 37.08
    ref = np.asarray(j_compile(ch4_case.ch4_kinetics())(
        jnp.asarray(T), jnp.asarray(P), jnp.asarray(mf), jnp.asarray(conc)))
    tt = lambda a: torch.as_tensor(a, dtype=torch.float64)
    port = t_compile(t_ch4_case.ch4_kinetics())(tt(T), tt(P), tt(mf),
                                                tt(conc)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-13, atol=0)


def test_params_from_jax_default_device_is_the_ports():
    """device=None means the CUDA card, as at every other entry point of
    the port; on a host without a card such a call raises, it never runs
    quietly on the CPU."""
    from rmt_tpu_torch.models import homo as thomo
    from rmt_tpu_torch.parallel import prepare_n2_ensemble

    assert tconfig.default_device() == torch.device("cuda")
    tree = {"T0": np.float64(523.0), "sub": {"a": [1.0, 2.0]}}
    mi = t_dme_case.make_model_input(model="N2")
    if torch.cuda.is_available():
        tp = params_from_jax(tree)
        assert tp["T0"].device.type == "cuda"
        assert tp["sub"]["a"].device.type == "cuda"
        assert thomo.build_params(mi)["T0"].device.type == "cuda"
    else:
        calls = (lambda: params_from_jax(tree),
                 lambda: thomo.build_params(mi),
                 lambda: prepare_n2_ensemble(mi, {"T0": [523.0, 524.0]}))
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()
    # naming the CPU still works everywhere
    assert params_from_jax(tree, device="cpu")["T0"].device.type == "cpu"
    assert thomo.build_params(mi, device="cpu")["T0"].device.type == "cpu"


def test_params_from_jax_round_trip():
    mi = dme_case.make_model_input(model="N2")
    mi["kinetic-overrides"] = {"K1": 0.5}
    p = jhomo.build_params(mi)
    tp = params_from_jax(p, device="cpu", dtype=torch.float64)
    assert tp.keys() == p.keys()
    assert tp["kinetic_overrides"].keys() == {"K1"}
    for k, v in p.items():
        if k == "kinetic_overrides":
            continue
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))
    t32 = params_from_jax(p, device="cpu", dtype=torch.float32)
    assert t32["T0"].dtype == torch.float32
    assert float(t32["kinetic_overrides"]["K1"]) == 0.5
