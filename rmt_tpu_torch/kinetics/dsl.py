# Kinetics DSL: the user's reaction-rate program evaluated on tensors.
#
# modelInput['reaction-rates'] = {"VARS": {...}, "RATES": {...}} where
# each entry is ``lambda x: ...`` over a growing dict x seeded with
# {R_CONST, T, P, MoFri, SpCoi} and evaluated in insertion order -- a
# topologically ordered scalar expression DAG (reference: PyREMOT/docs/
# rmtReaction.py:11-61; port of rmt_tpu/kinetics/dsl.py).
#
# The user's lambdas call math.exp / math.pow, so each lambda is re-bound
# to a shim ``math`` that dispatches on its argument:
#   * a torch.Tensor goes to the native torch op (torch.exp, ...), or,
#     with the switch RMT_TORCH_ACCURATE_F32 on, exp/log/log10/pow go to
#     ops/accurate_math (compensated float32 algorithms; float64 passes
#     through to the native ops);
#   * a value with a ``_math_dispatch`` hook handles the call itself --
#     DF32 pairs (ops/df32.py) run the compensated transcendentals, and
#     the CUDA code generator's symbolic values (ops/cuda_rhs.py) record
#     the call as a node of the expression DAG;
#   * plain Python numbers use the stdlib math module.
# Any DSL variable may be overridden with a tensor (kinetic_overrides),
# which makes kinetic constants sweepable per member.
#
# rmt_tpu turns its switch (RMT_TPU_ACCURATE_F32) on by default because a
# TPU's libm approximates float32 exp/log/pow to about 1e-5. The port's
# switch is read where the shim dispatches (so it can be flipped between
# calls, or for a block of code with accurate_f32_math), and its default
# comes from a measurement on the card (scripts/libm_f32_error.py,
# PERF.md section 6): _DEFAULT.

from __future__ import annotations

import contextlib
import math as _math
import os
import types
from typing import Any, Mapping

import torch

from ..constants import R_CONST
from ..ops import accurate_math as _am
from ..ops import df32 as _df

SWITCH = "RMT_TORCH_ACCURATE_F32"
_DEFAULT = "0"
_override: list[bool] = []


def accurate_f32() -> bool:
    """Whether the shim sends float32 exp/log/log10/pow to
    ops/accurate_math: the innermost accurate_f32_math block, else the
    environment switch RMT_TORCH_ACCURATE_F32 (default _DEFAULT)."""
    if _override:
        return _override[-1]
    return os.environ.get(SWITCH, _DEFAULT) != "0"


@contextlib.contextmanager
def accurate_f32_math(on: bool):
    """Set the switch for the code inside the block, whatever the
    environment says."""
    _override.append(bool(on))
    try:
        yield
    finally:
        _override.pop()


def _hook(*args):
    for a in args:
        h = getattr(type(a), "_math_dispatch", None)
        if h is not None:
            return h
    return None


def _unary(name, torch_fn, math_fn, am_fn=None):
    def fn(x):
        h = _hook(x)
        if h is not None:
            return h(name, x)
        if isinstance(x, torch.Tensor):
            if am_fn is not None and accurate_f32():
                return am_fn(x)
            return torch_fn(x)
        return math_fn(x)

    fn.__name__ = name
    return staticmethod(fn)


class _MathShim(types.ModuleType):
    """Drop-in replacement for the stdlib ``math`` module inside user
    lambdas (see the module note for the dispatch rule)."""

    pi = _math.pi
    e = _math.e
    inf = _math.inf
    nan = _math.nan

    def __init__(self):
        super().__init__("math")

    exp = _unary("exp", torch.exp, _math.exp, _am.exp)
    log10 = _unary("log10", torch.log10, _math.log10, _am.log10)
    sqrt = _unary("sqrt", torch.sqrt, _math.sqrt)
    fabs = _unary("fabs", torch.abs, _math.fabs)

    @staticmethod
    def log(x, base=None):
        h = _hook(x, base)
        if h is not None:
            return h("log", x, base)
        if isinstance(x, torch.Tensor) or isinstance(base, torch.Tensor):
            log = _am.log if accurate_f32() else torch.log
            x = torch.as_tensor(x)
            lg = log(x)
            if base is None:
                return lg
            if not isinstance(base, torch.Tensor):
                # a Python base takes the dtype of x: its log rounds as x's
                base = torch.as_tensor(base, dtype=x.dtype, device=x.device)
            return lg / log(base)
        return _math.log(x) if base is None else _math.log(x, base)

    @staticmethod
    def pow(x, y):
        h = _hook(x, y)
        if h is not None:
            return h("pow", x, y)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            return (_am.pow if accurate_f32() else torch.pow)(x, y)
        return _math.pow(x, y)

    power = pow


_MATH_SHIM = _MathShim()


def _rebind(fn):
    """Return ``fn`` with ``math``/``np``/``numpy`` rebound to the shim in
    its globals, so the user's lambdas run on tensors unchanged."""
    if not isinstance(fn, types.FunctionType):
        return fn
    g = dict(fn.__globals__)
    g["math"] = _MATH_SHIM
    g["np"] = _MATH_SHIM
    g["numpy"] = _MATH_SHIM
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


class RateProgram:
    """A compiled view of a {"VARS": ..., "RATES": ...} reaction-rate spec.

    Calling it evaluates the dict-program and returns the stacked
    reaction rates (n_rxn, ...). ``overrides`` replaces named DSL
    variables (kinetic constants) with caller-supplied tensors.
    """

    def __init__(self, vars_dict: Mapping[str, Any],
                 rates_dict: Mapping[str, Any]):
        self.var_names = tuple(vars_dict.keys())
        self.rate_names = tuple(rates_dict.keys())
        self._vars = {k: _rebind(v) for k, v in vars_dict.items()}
        self._rates = {k: _rebind(v) for k, v in rates_dict.items()}
        self.n_rxn = len(self._rates)

    def call_list(self, T, P, mole_frac, conc,
                  overrides: Mapping[str, Any] | None = None):
        """Evaluate the dict-program and return the per-reaction rates as
        a plain LIST (no stacking) -- the form the fused RHS consumes and
        the CUDA code generator traces."""
        x: dict[str, Any] = {
            "R_CONST": R_CONST,
            "T": T,
            "P": P,
            "MoFri": mole_frac,
            "SpCoi": conc,
        }
        overrides = overrides or {}
        for name, fn in self._vars.items():
            if name in overrides:
                x[name] = overrides[name]
            elif callable(fn):
                x[name] = fn(x)
            else:
                x[name] = fn
        rates = []
        for name, fn in self._rates.items():
            if name in overrides:
                rates.append(overrides[name])
            else:
                rates.append(fn(x))
        return rates

    def __call__(self, T, P, mole_frac, conc,
                 overrides: Mapping[str, Any] | None = None):
        rates = self.call_list(T, P, mole_frac, conc, overrides)
        if any(isinstance(r, _df.DF32) for r in rates):
            # keep the pairs so the caller's nu@R cancellation resolves
            # before the one final rounding (ops/df32.py rationale)
            return _df.DF32.stack(rates)
        return torch.stack(torch.broadcast_tensors(
            *[torch.as_tensor(r) for r in rates]))


def compile_rate_program(reaction_rate_expr: Mapping[str, Any]) -> RateProgram:
    """Build a RateProgram from the modelInput['reaction-rates'] dict."""
    return RateProgram(reaction_rate_expr["VARS"], reaction_rate_expr["RATES"])
