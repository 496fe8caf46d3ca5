# The port's compensated float32 transcendentals
# (rmt_tpu_torch/ops/accurate_math.py, ops/floatbits.py) against
# rmt_tpu's (ops/accurate_math.py, ops/floatbits.py) and against float64,
# the kinetics DSL's accurate-f32 switch (RMT_TORCH_ACCURATE_F32) against
# rmt_tpu's DSL, and their derivatives under torch.func.jvp and autograd
# (the colored Jacobians take forward-mode JVPs through the DSL).

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dme_case import make_model_input
from rmt_tpu.kinetics.dsl import RateProgram as JRateProgram
from rmt_tpu.ops import accurate_math as jam
from rmt_tpu.ops import floatbits as jfb
from rmt_tpu_torch.kinetics import dsl as tdsl
from rmt_tpu_torch.ops import accurate_math as tam
from rmt_tpu_torch.ops import floatbits as tfb

# the DSL's exponent range (tests/test_accurate_math.py): Arrhenius and
# equilibrium exponents |y ln x| <= 30
EXP_ARGS = np.concatenate([np.linspace(-30.0, 30.0, 4001),
                           np.linspace(-0.01, 0.01, 101),
                           np.linspace(-86.9, 86.9, 1001)]).astype(np.float32)
LOG_ARGS = np.concatenate([np.logspace(-30, 30, 4001),
                           np.linspace(0.9, 1.1, 201)]).astype(np.float32)
P_ARGS = np.logspace(-3, 1.7, 301).astype(np.float32)
Y_ARGS = np.linspace(-3.0, 3.0, 301).astype(np.float32)
Z_ARGS = (3066.0 / np.linspace(450.0, 700.0, 501) - 10.92).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b)))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _rel(got, want, floor=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.abs(want) if floor is None else np.maximum(np.abs(want), floor)
    return float(np.max(np.abs(got - want) / den))


def test_floatbits_bit_for_bit():
    """frexp_pos and ldexp2 equal rmt_tpu's bit for bit on positive
    normal inputs and normal results (XLA on the CPU flushes denormal
    results to zero, PyTorch does not)."""
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal(4000) * np.exp(
        rng.uniform(-80.0, 80.0, 4000))).astype(np.float32)
    x = x[x >= np.finfo(np.float32).tiny]
    m_j, e_j = jfb.frexp_pos(jnp.asarray(x))
    m_t, e_t = tfb.frexp_pos(_t(x))
    assert e_t.dtype == torch.int32
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    assert np.all((m_t.numpy() >= 0.5) & (m_t.numpy() < 1.0))
    k = rng.integers(-253, 254, x.size).astype(np.int32)
    want = np.asarray(jfb.ldexp2(jnp.asarray(x), jnp.asarray(k)))
    got = tfb.ldexp2(_t(x), torch.as_tensor(k)).numpy()
    normal = np.isfinite(want) & (np.abs(want) >= np.finfo(np.float32).tiny)
    assert normal.sum() > 1000
    np.testing.assert_array_equal(got[normal], want[normal])
    assert np.array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("fn", ["exp", "log", "log10", "pow", "pow10"])
def test_accurate_math_within_one_ulp_of_jax(fn):
    """Each function agrees with rmt_tpu's (jitted, as the DSL runs it)
    within 1 float32 ulp: the same constants, Horner order and guards;
    XLA may contract a product and a sum into one FMA where PyTorch's
    eager operations round each."""
    if fn == "pow":
        got = tam.pow(_t(P_ARGS), _t(Y_ARGS))
        want = jax.jit(jam.pow)(jnp.asarray(P_ARGS), jnp.asarray(Y_ARGS))
    elif fn == "pow10":
        got = tam.pow(10, _t(Z_ARGS))
        want = jax.jit(jam.pow)(jnp.float32(10.0), jnp.asarray(Z_ARGS))
    else:
        args = EXP_ARGS if fn == "exp" else LOG_ARGS
        got = getattr(tam, fn)(_t(args))
        want = jax.jit(getattr(jam, fn))(jnp.asarray(args))
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want) <= 1


def test_accurate_math_meets_float64_targets():
    """tests/test_accurate_math.py's targets against float64 at the
    float32 arguments: 5e-7 for exp, log and log10 (log and log10
    absolute where |log| < 0.25), 1e-6 for pow."""
    x = EXP_ARGS[:4102]
    assert _rel(tam.exp(_t(x)), np.exp(x.astype(np.float64))) < 5e-7
    assert _rel(tam.log(_t(LOG_ARGS)), np.log(LOG_ARGS.astype(np.float64)),
                0.25) < 5e-7
    x10 = np.logspace(-10, 10, 2001).astype(np.float32)
    assert _rel(tam.log10(_t(x10)), np.log10(x10.astype(np.float64)),
                0.25) < 5e-7
    assert _rel(tam.pow(10, _t(Z_ARGS)),
                np.power(10.0, Z_ARGS.astype(np.float64))) < 1e-6
    assert _rel(tam.pow(_t(P_ARGS), _t(Y_ARGS)),
                np.power(P_ARGS.astype(np.float64),
                         Y_ARGS.astype(np.float64))) < 1e-6


def test_pow_static_integer_exponent_is_a_product_chain():
    x = _t([1.5, 2.5, 523.0])
    assert torch.equal(tam.pow(x, 2), x * x)
    assert torch.equal(tam.pow(x, 3), x * x * x)
    assert torch.equal(tam.pow(x, 4), (x * x) * (x * x))
    assert torch.equal(tam.pow(x, -2), 1.0 / (x * x))
    want = np.asarray(jnp.power(jnp.asarray(x.numpy()), 5))
    np.testing.assert_array_equal(tam.pow(x, 5).numpy(), want)


def test_float64_passes_through():
    x = torch.tensor([0.5, 1.0, 12.2], dtype=torch.float64)
    assert torch.equal(tam.exp(x), torch.exp(x))
    assert torch.equal(tam.log(x), torch.log(x))
    assert torch.equal(tam.log10(x), torch.log10(x))
    y = torch.tensor(1.7, dtype=torch.float64)
    assert torch.equal(tam.pow(x, y), torch.pow(x, y))


def test_edge_semantics_match_native():
    """Outside the guarded domains the native op's value: inf, 0, nan and
    the subnormal results of exp, log of 0 and of negatives, and pow of
    a negative base."""
    x = _t([-1.0, 0.0, np.inf, -np.inf, np.nan, 100.0, -100.0, 1e-40])
    for fn in ("exp", "log", "log10"):
        got, want = getattr(tam, fn)(x), getattr(torch, fn)(x)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=fn)
    b = _t([-2.0, 0.0, np.inf, 1e-40, 2.0])
    e = _t([0.5, 0.5, 0.5, 0.5, np.nan])
    np.testing.assert_array_equal(tam.pow(b, e).numpy(),
                                  torch.pow(b, e).numpy())


@pytest.mark.parametrize("fn", ["exp", "log", "log10", "pow_x", "pow_y"])
def test_derivatives_are_clean_and_accurate(fn):
    """Forward-mode derivatives (torch.func.jvp) agree with the native
    op's to 1e-6 relative on the DSL's ranges (the bit views carry no
    derivative, the power-of-two scales are exact products). The
    reverse-mode gradient is finite, within 1 float32 ulp of rmt_tpu's
    jax.grad and within 1e-6 of the float64 derivative (measured 2.6e-7
    to 8.2e-7; for pow in x, it and the native gradient err by 7.4e-7 and
    6.2e-7 in opposite directions, 1.23e-6 apart in both packages; for
    pow in y the floor is 1e-3 of the largest derivative, where ln x
    vanishes)."""
    y_t, p_t = _t(Y_ARGS), _t(P_ARGS)
    y_j, p_j = jnp.asarray(Y_ARGS), jnp.asarray(P_ARGS)
    y64, p64 = Y_ARGS.astype(np.float64), P_ARGS.astype(np.float64)
    x, f, g, fj, exact, floor = {
        "exp": (EXP_ARGS[:4102], tam.exp, torch.exp, jam.exp, np.exp,
                None),
        "log": (LOG_ARGS, tam.log, torch.log, jam.log, lambda v: 1.0 / v,
                None),
        "log10": (LOG_ARGS, tam.log10, torch.log10, jam.log10,
                  lambda v: 1.0 / (v * np.log(10.0)), None),
        "pow_x": (P_ARGS, lambda a: tam.pow(a, y_t),
                  lambda a: torch.pow(a, y_t), lambda a: jam.pow(a, y_j),
                  lambda v: y64 * v ** (y64 - 1.0), 1e-30),
        "pow_y": (Y_ARGS, lambda a: tam.pow(p_t, a),
                  lambda a: torch.pow(p_t, a), lambda a: jam.pow(p_j, a),
                  lambda v: p64 ** v * np.log(p64), "scale"),
    }[fn]
    xt = _t(x)
    ones = torch.ones_like(xt)
    d_am = torch.func.jvp(f, (xt,), (ones,))[1]
    d_nat = torch.func.jvp(g, (xt,), (ones,))[1]
    assert bool(torch.isfinite(d_am).all())
    assert _rel(d_am.numpy(), d_nat.numpy(), 1e-30) < 1e-6
    xg = xt.clone().requires_grad_()
    f(xg).sum().backward()
    grad = xg.grad.numpy()
    assert np.all(np.isfinite(grad))
    want_j = np.asarray(jax.grad(lambda a: jnp.sum(fj(a)))(jnp.asarray(x)))
    assert _ulps(grad, want_j) <= 1
    ex = exact(x.astype(np.float64))
    if floor == "scale":
        floor = 1e-3 * np.abs(ex).max()
    assert _rel(grad, ex, floor) < 1e-6


def test_masked_branches_keep_gradients_finite():
    z = torch.tensor([2.0, 5.0], requires_grad=True)
    tam.log(z).sum().backward()
    assert bool(torch.isfinite(z.grad).all())
    t = torch.tensor(523.0, requires_grad=True)
    k = 35.45 * tam.exp(-1.7069e4 / (8.314 * t))
    kp = tam.pow(10.0, 3066.0 / t - 10.92)
    (k * kp + tam.log(t)).backward()
    assert bool(torch.isfinite(t.grad))


def _dme_rates(T):
    """The DME rate program at temperatures T (float32, shape (z,)) and a
    fixed composition at 5e6 Pa, in both packages' float32; the port's
    with the switch off and on."""
    mi = make_model_input(model="N1")
    rr = mi["reaction-rates"]
    mf = np.array([0.5, 0.4, 0.01, 0.01, 0.06, 0.02])
    P = 5e6
    T = np.asarray(T, np.float32)
    conc = (mf[:, None] * P / (8.314 * T[None].astype(np.float64))
            / 1000.0).astype(np.float32)
    mf32 = np.broadcast_to(mf[:, None], conc.shape).astype(np.float32)
    jprog = JRateProgram(rr["VARS"], rr["RATES"])
    want = np.asarray(jprog(jnp.asarray(T), jnp.float32(P), jnp.asarray(mf32),
                            jnp.asarray(conc)))
    tprog = tdsl.RateProgram(rr["VARS"], rr["RATES"])
    args = (_t(T), torch.tensor(P, dtype=torch.float32), _t(mf32), _t(conc))
    out = {}
    for on in (False, True):
        with tdsl.accurate_f32_math(on):
            out[on] = tprog(*args).numpy()
    w64 = np.asarray(jprog(jnp.asarray(T.astype(np.float64)), jnp.float64(P),
                           jnp.asarray(mf32.astype(np.float64)),
                           jnp.asarray(conc.astype(np.float64))))
    return want, out[False], out[True], w64


def test_dsl_switch_follows_rmt_tpu_rates():
    """With the switch on the port's DSL evaluates the DME rates as
    rmt_tpu's DSL does (its switch RMT_TPU_ACCURATE_F32 is on by
    default): closer to rmt_tpu's rates than with the switch off, in the
    largest and the mean relative error (measured 2.0e-6 and 3.1e-7 on,
    2.4e-6 and 3.7e-7 off: the rest is PyTorch's number / tensor, which
    rounds a reciprocal and a product), within 4e-6 of them, and as far
    from the float64 rates as rmt_tpu's, within 1.25 times (measured
    1.10)."""
    want, off, on, w64 = _dme_rates(np.linspace(480.0, 560.0, 41))
    assert np.all(np.isfinite(on))

    def mean_rel(a, b):
        return float(np.mean(np.abs(a.astype(np.float64) - b) / np.abs(b)))

    assert _rel(on, want) < _rel(off, want) < 4e-6
    assert _rel(on, want) < 4e-6
    assert mean_rel(on, want) < mean_rel(off, want)
    assert _rel(on, w64) <= 1.25 * _rel(want, w64)


def test_switch_is_read_where_the_shim_dispatches(monkeypatch):
    """RMT_TORCH_ACCURATE_F32 is read at each call (so it can be flipped
    between calls), accurate_f32_math overrides it inside its block, and
    the default is the one chosen on the card (off)."""
    monkeypatch.delenv(tdsl.SWITCH, raising=False)
    assert tdsl.accurate_f32() is False
    x = _t(EXP_ARGS[:4001])
    shim = tdsl._MATH_SHIM
    assert torch.equal(shim.exp(x), torch.exp(x))
    monkeypatch.setenv(tdsl.SWITCH, "1")
    assert tdsl.accurate_f32() is True
    assert torch.equal(shim.exp(x), tam.exp(x))
    assert torch.equal(shim.pow(10, x[:100] / 10), tam.pow(10, x[:100] / 10))
    with tdsl.accurate_f32_math(False):
        assert torch.equal(shim.log(x.abs() + 1), torch.log(x.abs() + 1))
    monkeypatch.setenv(tdsl.SWITCH, "0")
    with tdsl.accurate_f32_math(True):
        assert torch.equal(shim.log10(x.abs() + 1), tam.log10(x.abs() + 1))
    assert shim.exp(1.0) == np.exp(1.0)          # Python numbers: stdlib


def test_vmapped_jvp_equals_per_member_calls():
    """The colored Jacobians run the DSL under torch.func.vmap of a JVP:
    the functions' values and tangents there equal the unmapped calls,
    member by member (no dtype view, which PyTorch cannot batch)."""
    x = _t(np.linspace(0.5, 30.0, 12).reshape(3, 4))
    tang = torch.ones_like(x)

    def f(v):
        return (tam.exp(-v) + tam.log(v) + tam.log10(v)
                + tam.pow(v, _t(1.7)) + tam.pow(10, v / 30.0))

    val, tan = torch.func.vmap(
        lambda v, t: torch.func.jvp(f, (v,), (t,)))(x, tang)
    for b in range(3):
        v1, t1 = torch.func.jvp(f, (x[b],), (tang[b],))
        assert torch.equal(val[b], v1) and torch.equal(tan[b], t1)
    assert val.shape == tan.shape == x.shape
