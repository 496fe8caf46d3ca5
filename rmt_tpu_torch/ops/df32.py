# Double-float32 (compensated-pair) arithmetic for the kinetics chain,
# ported from rmt_tpu/ops/df32.py step for step.
#
# Why it exists: near chemical equilibrium the net formation rate nu@R is
# a small difference of large opposing rates, so f32 rounding of the
# individual rates is amplified ~10^3x. A DF32 value x = hi + lo with
# |lo| <= ulp(hi)/2 carries ~2^-48 relative precision through PURE f32
# adds and multiplies (Dekker 1971, Knuth TAOCP 4.2.2; error bounds per
# Joldes, Muller & Popescu 2017), so the chain resolves the cancellation
# before its one final rounding.
#
# The fused CUDA RHS kernel (csrc/df32.cuh) mirrors every function here
# operation for operation; this module is its plain-PyTorch twin and the
# interpreter the tests hold the kernel's code generator against.
#
# CONTRACTION. The error-free transforms must not be contracted into
# FMAs. Eager PyTorch runs each operation as its own kernel, so nothing
# here can be contracted; the CUDA mirror uses the __fadd_rn/__fmul_rn
# intrinsics and builds with -fmad=false. The EFTs keep the
# contraction-robust forms of the reference all the same, so the two
# implementations are the same algorithm.
#
# Every value is float32: hi/lo are f32 tensors, and Python constants are
# split with np.float32 and enter as f32 values, never promoted.

from __future__ import annotations

import math as _math

import numpy as np
import torch

_f32 = torch.float32


def f32c(x) -> float:
    """A Python float holding exactly the f32 rounding of x."""
    return float(np.float32(x))


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x if x.dtype == _f32 else x.to(_f32)
    return torch.tensor(f32c(x), dtype=_f32)


def _two_sum(a, b):
    """a + b = s + err exactly (Knuth; no magnitude ordering required)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """a + b = s + err, requires |a| >= |b| (or a == 0); contraction-
    robust form err = (a - s) + b."""
    s = a + b
    err = (a - s) + b
    return s, err


def _opaque(x):
    """NaN-guard select of the reference (a product that is NaN becomes
    0); kept so the pair arithmetic is the same function."""
    return torch.where(x == x, x, torch.zeros_like(x))


_SPLIT = f32c(4097.0)  # 2^12 + 1 for f32's 24-bit mantissa


def _split(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 bits."""
    c = _opaque(a * _SPLIT)
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """a * b = p + err exactly (Dekker product, no fma)."""
    p = _opaque(a * b)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


class DF32:
    """An unevaluated f32 pair hi + lo (double-float32 number/tensor)."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=None):
        self.hi = _as_f32(hi)
        self.lo = torch.zeros_like(self.hi) if lo is None else _as_f32(lo)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_value(x):
        """Lift x to DF32 keeping all the precision it carries: Python
        floats and f64 tensors split hi/lo; f32 tensors get lo = 0."""
        if isinstance(x, DF32):
            return x
        if isinstance(x, (int, float)):
            hi = np.float32(x)
            return DF32(float(hi), float(x) - float(hi))
        if x.dtype == torch.float64:
            hi = x.to(_f32)
            return DF32(hi, (x - hi.to(torch.float64)).to(_f32))
        return DF32(x.to(_f32), torch.zeros_like(x, dtype=_f32))

    @staticmethod
    def stack(values):
        vals = [DF32.from_value(v) for v in values]
        his = torch.broadcast_tensors(*[v.hi for v in vals])
        los = torch.broadcast_tensors(*[v.lo for v in vals])
        return DF32(torch.stack(his), torch.stack(los))

    # -- output ------------------------------------------------------------
    def value(self, dtype=None):
        """Collapse to one tensor: f32 (default) applies the single final
        rounding; float64 keeps both words."""
        if dtype == torch.float64:
            return self.hi.to(torch.float64) + self.lo.to(torch.float64)
        return self.hi + self.lo

    def __getitem__(self, idx):
        return DF32(self.hi[idx], self.lo[idx])

    def __repr__(self):
        return f"DF32(hi={self.hi!r}, lo={self.lo!r})"

    # the kinetics DSL's math shim routes math.exp(<DF32>) etc. here
    @staticmethod
    def _math_dispatch(name, *args):
        return _MATH[name](*args)

    # -- arithmetic --------------------------------------------------------
    def __neg__(self):
        return DF32(-self.hi, -self.lo)

    def __add__(self, other):
        # "sloppy" DW+DW (Joldes et al. alg. 5), as in the reference
        o = DF32.from_value(other)
        s, e = _two_sum(self.hi, o.hi)
        e = e + (self.lo + o.lo)
        return DF32(*_quick_two_sum(s, e))

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-DF32.from_value(other))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        o = DF32.from_value(other)
        p, e = _two_prod(self.hi, o.hi)
        e = e + (self.hi * o.lo + self.lo * o.hi)
        return DF32(*_quick_two_sum(p, e))

    __rmul__ = __mul__

    def __truediv__(self, other):
        # two-quotient long division (Joldes et al. alg. 17)
        o = DF32.from_value(other)
        q1 = self.hi / o.hi
        r = self - o * q1
        q2 = (r.hi + r.lo) / o.hi
        return DF32(*_quick_two_sum(q1, q2))

    def __rtruediv__(self, other):
        return DF32.from_value(other) / self

    def __pow__(self, n):
        if isinstance(n, (int, float)) and float(n).is_integer():
            return _int_pow(self, int(n))
        return exp(log(self) * DF32.from_value(n))

    def __rpow__(self, base):
        # 10 ** x, e ** x, ...: exp(x * log(base))
        if isinstance(base, (int, float)):
            lb = DF32.from_value(_math.log(float(base)))
        else:
            lb = log(DF32.from_value(base))
        return exp(self * lb)


def _int_pow(x: DF32, n: int) -> DF32:
    if n == 0:
        return DF32.from_value(1.0)
    if n < 0:
        return DF32.from_value(1.0) / _int_pow(x, -n)
    out = None
    base = x
    while n:
        if n & 1:
            out = base if out is None else out * base
        n >>= 1
        if n:
            base = base * base
    return out


# -- transcendentals --------------------------------------------------------
# ln2 as a pair: hi has its 12 low mantissa bits zeroed, so k * LN2_HI is
# exact for integer |k| < 2^11
LN2_HI = f32c(0.693145751953125)
LN2_LO = f32c(1.428606765330187e-06)
LN2_LO2 = f32c(5.4956039718e-14)
INV_LN2 = f32c(1.4426950408889634)

# Taylor tail Q(r) = sum_{k>=3} r^(k-3)/k!, evaluated in plain f32
EXP_TAIL = tuple(f32c(1.0 / _math.factorial(k)) for k in range(9, 2, -1))


def exp(x: DF32) -> DF32:
    """exp of a DF32, ~2e-9 relative for |x| <= ~80."""
    x = DF32.from_value(x)
    k = torch.round(x.hi * INV_LN2)          # round half to even
    r = (x - k * LN2_HI) - DF32(k * LN2_LO, k * LN2_LO2)
    q = torch.full_like(r.hi, EXP_TAIL[0])
    for c in EXP_TAIL[1:]:
        q = q * r.hi + c                     # plain f32 Horner
    r2 = r * r                               # DF: r^2
    tail = (r2.hi * r.hi) * q                # f32: r^3 * Q(r)
    out = r2 * f32c(0.5) + (r + DF32(tail))
    out = out + 1.0
    ki = k.to(torch.int32)
    return DF32(torch.ldexp(out.hi, ki), torch.ldexp(out.lo, ki))


# atanh-series correction log(m) - 2s = s^3 * poly(s^2), plain f32
LOG_TAIL = tuple(f32c(2.0 / (2 * k + 1)) for k in range(5, 0, -1))
_SQRT_HALF = f32c(0.7071067811865476)
_TINY = f32c(1.1754943508222875e-38)     # smallest normal f32


def log(x: DF32) -> DF32:
    """Natural log of a DF32 (positive finite input), ~1e-9 relative."""
    x = DF32.from_value(x)
    m, e = torch.frexp(x.hi)                 # x.hi = m * 2^e, m in [0.5, 1)
    small = m < _SQRT_HALF
    m = torch.where(small, m + m, m)         # m in [sqrt(1/2), sqrt(2))
    e = (e - small.to(e.dtype)).to(_f32)
    num = m - 1.0                            # exact (Sterbenz)
    s = DF32(num) / DF32(*_two_sum(m, torch.ones_like(m)))
    s2 = s.hi * s.hi
    p = torch.full_like(s2, LOG_TAIL[0])
    for c in LOG_TAIL[1:]:
        p = p * s2 + c                       # plain f32 Horner
    tail = (s2 * s.hi) * p + x.lo / x.hi     # series corr + lo folding
    out = DF32(s.hi + s.hi, s.lo + s.lo)     # 2s, exact doubling
    out = out + DF32(e * LN2_HI, e * LN2_LO)
    out = out + DF32(tail)
    # domain guard: x <= 0 or denormal gives nan, so a bad Newton iterate
    # poisons the increment instead of returning a plausible value
    bad = x.hi < _TINY
    nan = torch.full_like(out.hi, float("nan"))
    return DF32(torch.where(bad, nan, out.hi), torch.where(bad, nan, out.lo))


INV_LN10_HI = f32c(0.4342944920063019)
INV_LN10_LO = f32c(-1.0103049952192578e-08)


def log10(x: DF32) -> DF32:
    return log(x) * DF32(INV_LN10_HI, INV_LN10_LO)


def sqrt(x: DF32) -> DF32:
    """Square root via one exact-residual Newton correction."""
    x = DF32.from_value(x)
    y0 = torch.sqrt(x.hi)
    r = x - DF32(y0) * DF32(y0)
    d = r.hi + r.lo
    return DF32(*_quick_two_sum(y0, d / (y0 + y0)))


def pow(x, y):
    """x ** y with DF32 semantics on either argument."""
    if isinstance(y, (int, float)) and float(y).is_integer():
        return _int_pow(DF32.from_value(x), int(y))
    if isinstance(x, (int, float)):
        y = y if isinstance(y, DF32) else DF32.from_value(y)
        return y.__rpow__(x)
    if isinstance(x, DF32):
        return x ** y
    return DF32.from_value(x) ** y


def _log_base(x, base=None):
    if base is None:
        return log(x)
    return log(x) / log(DF32.from_value(base))


_MATH = {"exp": exp, "log": _log_base, "log10": log10, "sqrt": sqrt,
         "pow": pow}
