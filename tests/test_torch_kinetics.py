# Kinetics of the PyTorch port: the DSL evaluator against
# rmt_tpu.kinetics at float64 (the cases of tests/test_kinetics.py), the
# DF32 pair arithmetic against rmt_tpu.ops.df32 and a float64 oracle (the
# bars of tests/test_df32.py), and the CUDA RHS code generator's traced
# expression DAG against direct evaluation.

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ch4_case
import dme_case
from rmt_tpu.kinetics import compile_rate_program as j_compile
from rmt_tpu.ops import df32 as JD
from rmt_tpu_torch.cases.dme_case import make_model_input
from rmt_tpu_torch.kinetics import compile_rate_program as t_compile
from rmt_tpu_torch.models import homo
from rmt_tpu_torch.ops import cuda_rhs
from rmt_tpu_torch.ops import df32 as TD

T, P = 523.0, 5e6
MOFRI = np.array([0.4999925, 0.2499963, 1e-5, 0.2499962, 1e-5, 1e-5])
MOFRI = MOFRI / MOFRI.sum()
CONC = MOFRI * 1149.83

f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _rel(a, b, floor=1e-300):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def _batch(rng, z, n_comp, scale):
    T_ = np.float32(rng.uniform(500, 620, z)).astype(np.float64)
    P_ = np.float32(rng.uniform(4.5e6, 5e6, z)).astype(np.float64)
    mf = np.float32(rng.dirichlet(np.ones(n_comp), z).T).astype(np.float64)
    return T_, P_, mf, np.float32(mf * scale).astype(np.float64)


@pytest.mark.parametrize("case", ["dme_point", "dme_batch", "ch4_batch"])
def test_rates_match_jax_f64(case):
    rng = np.random.default_rng(5)
    if case == "dme_point":
        kin, args = dme_case.dme_kinetics(), (T, P, MOFRI, CONC)
    elif case == "dme_batch":
        kin, args = dme_case.dme_kinetics(), _batch(rng, 20, 6, 1149.83)
    else:
        kin, args = ch4_case.ch4_kinetics(), _batch(rng, 20, 3, 40.0)
    ref = np.asarray(j_compile(kin)(*[jnp.asarray(a) for a in args]))
    got = t_compile(kin)(*[f64(a) for a in args]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)


def test_kinetic_overrides_replace_and_differentiate():
    prog = t_compile(dme_case.dme_kinetics())
    k1_base = 35.45 * np.exp(-1.7069e4 / (8.314472 * T))
    k1 = torch.tensor(k1_base, dtype=torch.float64, requires_grad=True)
    r = prog(f64(T), f64(P), f64(MOFRI), f64(CONC), {"K1": k1})
    r[0].backward()
    # r1 is linear in K1, so dr1/dK1 = r1/K1
    np.testing.assert_allclose(float(k1.grad), float(r[0].detach()) / k1_base,
                               rtol=1e-9)
    ref = np.asarray(j_compile(dme_case.dme_kinetics())(
        T, P, jnp.asarray(MOFRI), jnp.asarray(CONC), {"K1": 2 * k1_base}))
    got = prog(f64(T), f64(P), f64(MOFRI), f64(CONC),
               {"K1": f64(2 * k1_base)}).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def _pair(x):
    """The same f64 values as a DF32 pair of each package."""
    return (TD.DF32.from_value(f64(x)), JD.DF32.from_value(jnp.asarray(x)))


def test_df32_split_equals_jax(rng):
    x = rng.uniform(0.1, 10, 512) * 10.0 ** rng.integers(-8, 8, 512)
    t, j = _pair(x)
    np.testing.assert_array_equal(t.hi.numpy(), np.asarray(j.hi))
    np.testing.assert_array_equal(t.lo.numpy(), np.asarray(j.lo))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "sqrt", "pow3",
                                "exp", "log", "log10", "rpow10", "powf"])
def test_df32_ops_vs_f64_and_jax(rng, op):
    """Each DF32 operation holds the tests/test_df32.py bar against the
    float64 oracle and agrees with rmt_tpu.ops.df32 to within that bar."""
    x = rng.uniform(0.1, 10, 2048) * 10.0 ** rng.integers(-8, 8, 2048)
    y = rng.uniform(0.1, 10, 2048) * 10.0 ** rng.integers(-8, 8, 2048)
    a = rng.uniform(-35, 35, 2048)
    t = rng.uniform(1e-8, 1500, 2048)
    lk = rng.uniform(-8, 8, 2048)
    b = rng.uniform(0.5, 50, 2048)
    e = rng.uniform(-3, 3, 2048)
    cases = {
        "add": ((x, y), lambda X, Y, m: X + Y, x + y, 1e-13),
        "sub": ((x * (1 + 1e-6), x), lambda Z, X, m: Z - X,
                x * (1 + 1e-6) - x, 1e-6),
        "mul": ((x, y), lambda X, Y, m: X * Y, x * y, 1e-13),
        "div": ((x, y), lambda X, Y, m: X / Y, x / y, 1e-13),
        "sqrt": ((x,), lambda X, m: m.sqrt(X), np.sqrt(x), 1e-13),
        "pow3": ((x,), lambda X, m: X ** 3, x ** 3, 1e-13),
        "exp": ((a,), lambda A, m: m.exp(A), np.exp(a), 5e-9),
        "log": ((t,), lambda A, m: m.log(A), np.log(t), 2e-9),
        "log10": ((t,), lambda A, m: m.log10(A), np.log10(t), 2e-9),
        "rpow10": ((lk,), lambda A, m: 10.0 ** A, 10.0 ** lk, 5e-9),
        "powf": ((b, e), lambda B_, E_, m: B_ ** E_, b ** e, 5e-9),
    }
    args, fn, want, bar = cases[op]
    pairs = [_pair(v) for v in args]
    got_t = fn(*[p[0] for p in pairs], TD).value(torch.float64).numpy()
    got_j = np.asarray(fn(*[p[1] for p in pairs], JD).value(jnp.float64))
    assert _rel(got_t, want) < bar
    assert _rel(got_t, got_j, floor=np.abs(want).max() * 1e-30) < bar


def test_df32_python_constants_keep_full_precision():
    c = 1.7069e4
    t = np.float64(523.0)
    Tp = TD.DF32.from_value(f64(t))
    assert _rel((Tp * c).value(torch.float64), t * c) < 1e-14
    assert _rel((c / Tp).value(torch.float64), c / t) < 1e-13
    assert _rel((1 - Tp * 1e-4).value(torch.float64), 1 - t * 1e-4) < 1e-13


def test_dme_rates_df32_vs_f64_and_jax(rng):
    """The DME dict-program through DF32 pairs: the tests/test_df32.py bar
    against the f64 chain, and rmt_tpu's df32 rates to the same bar."""
    args = _batch(rng, 20, 6, 1.15)
    r64 = t_compile(dme_case.dme_kinetics())(*[f64(a) for a in args])
    rdf = t_compile(dme_case.dme_kinetics())(
        *[TD.DF32.from_value(f64(a)) for a in args])
    assert isinstance(rdf, TD.DF32)
    got = rdf.value(torch.float64).numpy()
    assert _rel(got, r64.numpy()) < 2e-8
    jdf = j_compile(dme_case.dme_kinetics())(
        *[JD.DF32.from_value(jnp.asarray(a)) for a in args])
    assert _rel(got, np.asarray(jdf.value(jnp.float64))) < 2e-8


# -- the CUDA RHS code generator ---------------------------------------------

def _spec(case="dme"):
    if case == "dme":
        return homo.build_spec(make_model_input(model="N2"))
    mi = ch4_case.make_model_input(model="N2")
    return homo.build_spec(mi)


@pytest.mark.parametrize("mode", [False, "df32"])
@pytest.mark.parametrize("case", ["dme", "ch4"])
def test_traced_dag_reproduces_direct_rates(mode, case):
    """Interpreting the recorded DAG on tensors (or DF32 pairs) gives the
    rates the DSL gives when evaluated directly, bit for bit."""
    spec = _spec(case)
    df32_mode = mode == "df32"
    graph, rates = cuda_rhs.trace_rates(spec, df32_mode)
    rng = np.random.default_rng(3)
    nc = spec.n_comp
    T_, P_, mf, conc = _batch(rng, 20, nc, 30.0)
    lift = ((lambda a: TD.DF32.from_value(torch.as_tensor(a, dtype=torch.float32)))
            if df32_mode else
            (lambda a: torch.as_tensor(a, dtype=torch.float32)))
    inputs = {"T": lift(T_), "P": lift(P_)}
    inputs.update({f"mofri{i}": lift(mf[i]) for i in range(nc)})
    inputs.update({f"conc{i}": lift(conc[i]) for i in range(nc)})
    got = cuda_rhs.interpret(graph, rates, inputs)
    want = spec.rates.call_list(
        inputs["T"], inputs["P"], [inputs[f"mofri{i}"] for i in range(nc)],
        [inputs[f"conc{i}"] for i in range(nc)], {})
    assert len(got) == len(want) == spec.stoich.n_rxn
    for g, w in zip(got, want):
        if df32_mode:
            assert torch.equal(g.hi, w.hi) and torch.equal(g.lo, w.lo)
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("mode", [False, "df32"])
def test_emitted_source_is_deterministic(mode):
    a = cuda_rhs.kernel_source(_spec(), mode)
    b = cuda_rhs.kernel_source(_spec(), mode)
    assert a == b
    assert 'extern "C" int n2_rhs_launch' in a
    # the rates function works on DF32 pairs exactly in df32 mode
    assert ("const df v" in a) == (mode == "df32")
    from rmt_tpu_torch.ops import _build

    assert _build.library_path("x", a) == _build.library_path("x", b)


def test_generator_raises_on_what_it_cannot_express():
    mi = make_model_input(model="N2")
    kin = dme_case.dme_kinetics()
    kin["VARS"]["K1"] = lambda x: 35.45 * (2.0 if x["T"] else 1.0)
    mi["reaction-rates"] = kin
    with pytest.raises(TypeError, match="control flow"):
        cuda_rhs.kernel_source(homo.build_spec(mi), "df32")
    import math

    kin = dme_case.dme_kinetics()
    kin["VARS"]["K2"] = lambda x: math.sin(x["T"])
    mi["reaction-rates"] = kin
    with pytest.raises((TypeError, AttributeError)):
        cuda_rhs.kernel_source(homo.build_spec(mi), False)
