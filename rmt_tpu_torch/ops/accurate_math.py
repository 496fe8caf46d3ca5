# Compensated float32 transcendentals (port of rmt_tpu/ops/accurate_math.py).
#
# rmt_tpu routes the kinetics DSL's float32 exp/log/pow through these
# because a TPU's libm approximates them to about 1e-5 relative. The
# algorithms are classic argument reduction with two-term constants and
# Horner polynomials in plain float32 adds and multiplies, with the same
# constants, the same Horner order and the same guards as rmt_tpu's (|x| <
# 87 for exp; x at least the smallest normal and finite for log and pow),
# so each function computes the reference's value. Targets against
# float64: 5e-7 relative for exp and log, 1e-6 for pow at the exponent
# magnitudes the DSL uses (|y ln x| <= 30). pow carries a compensated
# logarithm and a Dekker product of y and log(x), so the low bits that
# exp amplifies survive.
#
# The kinetics DSL (kinetics/dsl.py) calls them when the switch
# RMT_TORCH_ACCURATE_F32 is on; the generated fused RHS kernel
# (ops/cuda_rhs.py) then emits the same algorithms as device functions.
# float64 tensors (and Python numbers) pass through to the native ops.
# Every step is a separate PyTorch operation, so nothing is contracted
# into an FMA, as the Dekker product requires.

from __future__ import annotations

import math as _math

import numpy as np
import torch

from . import floatbits as _fb

_f32 = torch.float32


def _c(x) -> float:
    """A Python float holding exactly the f32 rounding of x."""
    return float(np.float32(x))


# smallest normal f32: the bit-view frexp garbles denormals, so the
# guarded entry points send them to the native op
MIN_NORMAL = _c(1.1754943508222875e-38)

# ln2 split: LN2_HI has its 12 low mantissa bits zeroed, so k * LN2_HI is
# exact in f32 for integer |k| < 2^11 (covers |x| <= 88)
LN2_HI = _c(0.693145751953125)
LN2_LO = _c(1.428606765330187e-06)
INV_LN2 = _c(1.4426950408889634)
INV_LN10 = _c(0.4342944819032518)
SQRT_HALF = _c(0.7071067811865476)
# exp(r) Taylor on r in [-ln2/2, ln2/2]: 1/8!, 1/7!, ..., 1/2!
EXP_COEFS = tuple(_c(1.0 / _math.factorial(k)) for k in range(8, 1, -1))
# atanh-form log: log(m) = 2s + s^3 poly(s^2), s = (m-1)/(m+1); the
# Taylor coefficients 2/11, 2/9, ..., 2/3
LOG_COEFS = tuple(_c(2.0 / k) for k in (11.0, 9.0, 7.0, 5.0, 3.0))
# exponents that fit the reduction's exact-k range
EXP_LIMIT = 87.0
SPLIT = 4097.0
# static integer exponents that pow expands into a product chain
MAX_INT_POW = 8


def _is_f32(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.dtype == _f32 for x in xs)


def _native(fn, x):
    return fn(x if isinstance(x, torch.Tensor)
              else torch.as_tensor(x, dtype=torch.float64))


def exp_kernel(x, extra=None):
    """exp(x + extra) for f32 x, |x| < 87; extra (optional) is a small
    correction folded into the reduced argument."""
    k = torch.round(x * INV_LN2)
    r = (x - k * LN2_HI) - k * LN2_LO
    if extra is not None:
        r = r + extra
    p = EXP_COEFS[0]
    for c in EXP_COEFS[1:]:
        p = p * r + c
    p = p * r + 1.0
    p = p * r + 1.0
    return _fb.ldexp2(p, k)


def exp(x):
    """Accurate f32 exp; other dtypes go to torch.exp."""
    if not _is_f32(x):
        return _native(torch.exp, x)
    # outside the exact-k range the result under- or overflows anyway:
    # the native op gives inf / 0 / nan there
    safe = torch.abs(x) < EXP_LIMIT
    xs = torch.where(safe, x, 0.0)
    return torch.where(safe, exp_kernel(xs), torch.exp(x))


def log_ext(x):
    """Compensated log of positive normal f32 x: (hi, lo) with hi + lo =
    log(x) to about 1e-9 absolute."""
    m, e = _fb.frexp_pos(x)                # x = m * 2^e, m in [0.5, 1)
    small = m < SQRT_HALF
    m = torch.where(small, m + m, m)       # m in [sqrt(1/2), sqrt(2))
    e = (e - small.to(e.dtype)).to(_f32)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = LOG_COEFS[0]
    for c in LOG_COEFS[1:]:
        p = p * s2 + c
    poly = (s * s2) * p                    # log(m) - 2s
    two_s = s + s
    hi = e * LN2_HI + two_s
    lo = (e * LN2_HI - (hi - two_s)) + poly + e * LN2_LO
    return hi, lo


def _log_guarded(x, native, scale=None):
    ok = (x >= MIN_NORMAL) & torch.isfinite(x)
    hi, lo = log_ext(torch.where(ok, x, 1.0))
    v = hi + lo
    if scale is not None:
        v = v * scale
    return torch.where(ok, v, native(x))


def log(x):
    """Accurate f32 natural log; other dtypes go to torch.log."""
    if not _is_f32(x):
        return _native(torch.log, x)
    return _log_guarded(x, torch.log)


def log10(x):
    """Accurate f32 log10; other dtypes go to torch.log10."""
    if not _is_f32(x):
        return _native(torch.log10, x)
    return _log_guarded(x, torch.log10, INV_LN10)


def two_prod(a, b):
    """Dekker product: a * b = p + err exactly in f32 (no FMA)."""
    p = a * b
    c = SPLIT * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    c = SPLIT * b
    b_hi = c - (c - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def int_pow(x, n: int):
    """x ** n for a static integer n by binary powering, the product
    chain rmt_tpu's integer powers expand to (lax.integer_pow)."""
    if n == 0:
        return torch.ones_like(x)
    acc, base, k = None, x, abs(n)
    while k:
        if k & 1:
            acc = base if acc is None else acc * base
        k >>= 1
        if k:
            base = base * base
    return 1.0 / acc if n < 0 else acc


def pow(x, y):
    """Accurate f32 x ** y for x > 0; other cases, and other dtypes, go to
    torch.pow. A static small integer exponent is an exact product chain
    (more accurate than any exp(y log x) route). The y log(x) product is
    kept as a pair so exp sees its low bits."""
    if isinstance(y, (int, float)) and float(y).is_integer() \
            and abs(y) <= MAX_INT_POW and isinstance(x, torch.Tensor):
        return int_pow(x, int(y))
    if not _is_f32(x, y):
        return torch.pow(x, y)
    ref = x if isinstance(x, torch.Tensor) else y
    x32 = torch.as_tensor(x, device=ref.device).to(_f32)
    y32 = torch.as_tensor(y, device=ref.device).to(_f32)
    ok = (x32 >= MIN_NORMAL) & torch.isfinite(x32) & torch.isfinite(y32)
    ys = torch.where(ok, y32, 1.0)
    hi, lo = log_ext(torch.where(ok, x32, 1.0))
    p_hi, p_err = two_prod(ys, hi)
    p_lo = p_err + ys * lo
    safe = torch.abs(p_hi) < EXP_LIMIT
    out = exp_kernel(torch.where(safe, p_hi, 0.0),
                     extra=torch.where(safe, p_lo, 0.0))
    out = torch.where(safe, out, torch.exp(p_hi))
    return torch.where(ok, out, torch.pow(x, y))


def sqrt(x):
    """float32 sqrt is correctly rounded: the native op (kept so callers
    can route every DSL transcendental through one module)."""
    return _native(torch.sqrt, x)
