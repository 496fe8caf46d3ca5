# Fused N2 RHS (port of rmt_tpu/ops/pallas_rhs.py): one whole evaluation
# of the N2 dynamic RHS per member row, as ONE CUDA kernel generated per
# chemistry, beside its plain-PyTorch twin.
#
# The kernel covers what the TPU kernel covers: EPS clamps;
# concentrations, mole fractions and molecular weight; the closed-form
# Ergun pressure march; the user's DSL kinetics; nu-weighted formation
# rates; mixture Cp; heat of reaction; the Tm == 0 adiabatic rule; and
# backward-difference convection with the inlet BC (modelEquationN2
# semantics, QUIRKs included, pbHomoReactor.py:3706-4134). Two modes:
# plain f32, and df32 (kinetics, nu@R and the heat-of-reaction sum in
# compensated pairs, ops/df32.py). With the DSL's accurate-f32 switch on
# (kinetics/dsl.py, RMT_TORCH_ACCURATE_F32) the plain float32 exp, log,
# log10 and pow of the rate program are ops/accurate_math's algorithms,
# emitted as device functions (_AM_SOURCE): the plain mode's
# accurate-math variant, launched as n2_rhs_plain_am.
#
# The chemistry is the user's, so the kernel source is GENERATED: the
# DSL program (RateProgram.call_list) is traced with symbolic values
# through the same math shim the tensor path uses, which records the
# expression DAG of the VARS/RATES program; the DAG is emitted as one
# __device__ function per mode, with the Python-level dispatch of every
# operation reproduced exactly (the DF32 operator that Python would pick,
# Python float constants split hi/lo as DF32.from_value does). A program
# the generator cannot express raises; there is no fallback.
#
# Layouts: the wrapper takes y (M, n) row-major with M = s*B rows (s = 3
# for the stage-stacked form, stage-major: member = row % B) and the
# parameters packed member-last by pack_leaves, and returns a contiguous
# row-major (M, n) result. The kernel reads and writes those rows itself:
# a block of spec_geometry(...).mt rows stages its contiguous span of y
# into shared memory (16-byte copies where a row's bytes allow,
# staging_map) and writes its result tile back the same way, so no
# transposing copy runs around it.
#
# Replaces the TPU kernel rmt_tpu/ops/pallas_rhs.py::build_n2_fused
# (rhs_f, _n2_core_ml, _shift_down, _prefix_prod_excl, _prefix_sum_excl).
# One thread per (row, node). What bounds it on an H100 is instruction
# issue, not bytes (the note at the head of the generated source gives
# the counts); the pressure march (a prefix product and sum over the
# nodes) shares the nodes' a_z factors through shared memory and runs as
# a short sequential loop in each thread instead of the TPU's
# Hillis-Steele doubling, and what depends on the member alone is
# computed once per member.

from __future__ import annotations

import ctypes
import functools
import math as _math
import operator
from typing import NamedTuple

import numpy as np
import torch

from ..constants import EPS_CONST, R_CONST, Tref
from ..data import species as DB
from ..kinetics import dsl as _dsl
from ..kinetics.dsl import _MATH_SHIM
from . import _build
from . import accurate_math as _am
from . import df32 as _df32

LAUNCHES = {"n2_rhs_df32": 0, "n2_rhs_plain": 0, "n2_rhs_plain_am": 0}

# parameter leaves the N2 core reads, in fixed packing order
_P_1D = ("T0", "BeVoFr", "PaDi", "P0", "Tm", "U")
_D_1D = ("Cmax", "SuGaVe0", "vf", "zf", "InGaVe0", "GaMiVi", "GaDe0",
         "GaCpMeanMix0", "GaMaCoTe0", "GaHeCoTe0", "aEff")

_f32 = torch.float32


def pack_leaves(p, d, ko_keys=()):
    """Pack the per-member parameters (every leaf with a leading member
    axis: (B,) scalars, (B, n_comp) vectors) into the member-last f32
    tensors the fused RHS reads: leaves1 (6 + 11 + n_overrides, B) and
    leaves2 (2, n_comp, B) = [SpCoi0, mw]."""
    rows = [p[k] for k in _P_1D] + [d[k] for k in _D_1D]
    rows += [p["kinetic_overrides"][k] for k in ko_keys]
    leaves1 = torch.stack([r.to(_f32) for r in rows]).contiguous()
    leaves2 = torch.stack([p["SpCoi0"].to(_f32).T,
                           d["mw"].to(_f32).T]).contiguous()
    return leaves1, leaves2


def _unpack(leaves1, leaves2, ko_keys, reps):
    """Leaf dicts tiled to the M = reps*B rows (stage-major)."""
    l1 = leaves1.repeat(1, reps) if reps > 1 else leaves1
    l2 = leaves2.repeat(1, 1, reps) if reps > 1 else leaves2
    it = iter(l1)
    p = {k: next(it) for k in _P_1D}
    d = {k: next(it) for k in _D_1D}
    p["kinetic_overrides"] = {k: next(it) for k in ko_keys}
    p["SpCoi0"], d["mw"] = l2[0], l2[1]
    return p, d


class _Consts:
    """The constants of one spec in one float type (float32 by default),
    shared by the twin and the kernel generator; c(x) rounds a Python
    number to that type."""

    def __init__(self, spec, dtype=np.float32):
        f = self.f = np.dtype(dtype).type
        self.dz = f(1.0 / (spec.z_no - 1))
        self.inv_dz = f(f(1.0) / self.dz)
        self.eps_c = f(EPS_CONST)
        self.r_const = f(R_CONST)
        self.tref = f(Tref)
        self.nu = np.asarray(spec.stoich.nu_comp, dtype=np.float64)
        self.eq_nu = np.asarray(spec.stoich.eq_nu, dtype=np.float64)
        self.dh25 = np.asarray(spec.stoich.dh_rxn_25, dtype=f)
        self.cp = np.asarray(DB.CP_COEFF[spec.comp_idx], dtype=f)
        self.cp_eq = np.asarray(DB.CP_COEFF[spec.stoich.eq_idx], dtype=f)
        # Cp at the reference temperature, in the type's arithmetic
        self.cp_ref = [self._poly(c, self.tref) for c in self.cp]
        self.cp_eq_ref = [self._poly(c, self.tref) for c in self.cp_eq]

    @staticmethod
    def _poly(c, T):
        return (c[0] + c[1] * T + c[2] * T * T + c[3] * T * T * T)

    def c(self, x) -> float:
        return float(self.f(x))


def _cp_poly(c, T):
    """c0 + c1*T + c2*T^2 + c3*T^3 in the reference's (Horner-free) order."""
    c0, c1, c2, c3 = (float(v) for v in c)
    return c0 + c1 * T + c2 * T * T + c3 * T * T * T


# -- plain-PyTorch twin ---------------------------------------------------------

def n2_core_ml(spec, df32_mode: bool, Y, p, d, frozen_pressure=False):
    """Member-last N2 RHS core: Y (var, z, M) -> dY/dt (var, z, M), in
    Y's dtype (float32 on the kernel's path; float64 with the constants in
    float64, for homo.make_n2_rhs_b).

    p/d leaves are member-last: (M,) scalars, (n_comp, M) vectors. The
    order of every operation is the kernel's (csrc is generated from the
    same steps), including the sequential prefix loops of the pressure
    march. frozen_pressure=True detaches R T / MW, the pressure march's
    only dependence on the state (homo.make_n2_rhs's frozen_pressure_jac:
    the Jacobian is then block bidiagonal in z)."""
    n_comp, z_no = spec.n_comp, spec.z_no
    K = _Consts(spec, np.float64 if Y.dtype == torch.float64
                else np.float32)
    cst = K.c
    dz, one = float(K.dz), 1.0

    c_raw = [Y[s] for s in range(n_comp)]                 # (z, M) each
    # QUIRK: clamped for kinetics/sources, raw for convection
    # (pbHomoReactor.py:3899 vs 4086)
    c_cl = [torch.clamp(c, min=float(K.eps_c)) for c in c_raw]
    T_dl = Y[n_comp] if not spec.iso_thermal else torch.zeros_like(Y[0])

    co_re = [c * d["Cmax"] for c in c_cl]
    T_re = T_dl * p["T0"] + p["T0"]
    ctot = functools.reduce(operator.add, co_re)
    mo_fri = [c / ctot for c in co_re]
    mi_mo_we = functools.reduce(
        operator.add, [mo_fri[s] * d["mw"][s] for s in range(n_comp)]
    ) * cst(1e-3)

    # frozen-velocity assumption (QUIRK, pbHomoReactor.py:4066)
    su_ga_ve = d["SuGaVe0"]
    v_dl = su_ga_ve / d["vf"]
    in_ga_ve_dl = (su_ga_ve / p["BeVoFr"]) / d["InGaVe0"]

    eps = p["BeVoFr"]
    erg_a = 150.0 * d["GaMiVi"] * su_ga_ve / (p["PaDi"] * p["PaDi"])
    erg_b = (one - eps) * (one - eps) / (eps * eps * eps)
    erg_c_coef = 1.75 * su_ga_ve * su_ga_ve / p["PaDi"]
    erg_d = (one - eps) / (eps * eps * eps)
    # R / MW as a true division (a Python number over a tensor would
    # run as reciprocal-then-multiply, two roundings)
    rg_t = (torch.full_like(mi_mo_we, float(K.r_const)) / mi_mo_we) * T_re
    if frozen_pressure:
        rg_t = rg_t.detach()

    # explicit axial pressure march as the affine recurrence
    # P_{z+1} = a_z P_z + b, in closed form (QUIRK, pbHomoReactor.py:
    # 3970-3979): P_k = A_k (P0 + S_k), A_k = prod_{i<k} a_i,
    # S_k = sum_{i<k} b / (A_i a_i), accumulated in node order
    a_co = one - (erg_c_coef * erg_d / rg_t) * dz
    b_co = -(erg_a * erg_b) * dz
    A = torch.ones_like(b_co)
    S = torch.zeros_like(b_co)
    P_rows = []
    for k in range(z_no):
        P_rows.append(A * (p["P0"] + S))
        S = S + b_co / (A * a_co[k])
        A = A * a_co[k]
    P_z = torch.stack(P_rows)
    ga_de_dl = (P_z / rg_t) / d["GaDe0"]

    ko = p["kinetic_overrides"]
    if df32_mode:
        DF = _df32.DF32.from_value
        r_list = spec.rates.call_list(DF(T_re), DF(P_z),
                                      [DF(m) for m in mo_fri],
                                      [DF(c) for c in co_re], ko)
        r_list = [DF(r) for r in r_list]
    else:
        r_list = spec.rates.call_list(T_re, P_z, mo_fri, co_re, ko)
        r_list = [r if isinstance(r, torch.Tensor)
                  else torch.full_like(T_re, cst(r)) for r in r_list]

    ri = []
    for s in range(n_comp):
        acc = None
        for m, r_m in enumerate(r_list):
            cmk = float(K.nu[m, s])
            if cmk == 0.0:
                continue
            term = r_m * (cmk if df32_mode else cst(cmk))
            acc = term if acc is None else acc + term
        if acc is None:
            ri.append(torch.zeros_like(T_re))
        else:
            ri.append(acc.value(Y.dtype) if df32_mode else acc)

    # mixture heat capacity (plain f32)
    cp_mean_i = [0.5 * (float(K.cp_ref[s]) + _cp_poly(K.cp[s], T_re))
                 for s in range(n_comp)]
    cp_mix = functools.reduce(
        operator.add, [mo_fri[s] * cp_mean_i[s] for s in range(n_comp)])
    cp_mix_dl = cp_mix / d["GaCpMeanMix0"]
    cp_mix_eff_dl = cp_mix_dl * eps

    if not spec.iso_thermal:
        # heat of reaction at T (rmtThermo.py:258-312 semantics); the
        # r-weighted sum keeps df32 pairs so no re-rounding enters
        cp_mean_eq = [0.5 * (float(K.cp_eq_ref[e]) + _cp_poly(K.cp_eq[e], T_re))
                      for e in range(len(K.cp_eq))]
        dT = T_re - float(K.tref)
        ov = None
        for m, r_m in enumerate(r_list):
            en = None
            for e in range(len(cp_mean_eq)):
                cme = float(K.eq_nu[m, e])
                if cme == 0.0:
                    continue
                t_ = cst(cme) * cp_mean_eq[e]
                en = t_ if en is None else en + t_
            dh = float(K.dh25[m])
            he_m = en * dT + dh if en is not None else torch.full_like(dT, dh)
            term = r_m * he_m
            ov = term if ov is None else ov + term
        ov_he_re_t = ov.value(Y.dtype) if df32_mode else ov
        # Qm with the Tm == 0 => adiabatic rule (rmtUtility.py:437-444)
        qm = torch.where(p["Tm"] == 0.0, torch.zeros_like(T_re),
                         p["U"] * d["aEff"] * (p["Tm"] - T_re))

    const_f1 = one / (eps * (d["zf"] / d["vf"]))
    inv_dz = float(K.inv_dz)
    inv_gmc = one / d["GaMaCoTe0"]
    rows = []
    for s in range(n_comp):
        c_in = (p["SpCoi0"][s] / d["Cmax"])[None, :]
        c_back = torch.cat([c_in, c_cl[s][:-1]], dim=0)
        dcdz = (c_raw[s] - c_back) * inv_dz
        rows.append(const_f1 * (-v_dl * dcdz + ri[s] * inv_gmc))

    if not spec.iso_thermal:
        t_back = torch.cat([torch.zeros_like(T_dl[:1]), T_dl[:-1]], dim=0)
        dtdz = (T_dl - t_back) * inv_dz
        const_t2 = one / (ga_de_dl * cp_mix_dl * eps * (d["zf"] / d["vf"]))
        inv_ghc = one / d["GaHeCoTe0"]
        convective = -in_ga_ve_dl * ga_de_dl * cp_mix_eff_dl * dtdz
        rows.append(const_t2 * (convective + (-ov_he_re_t + qm) * inv_ghc))

    return torch.stack(rows, dim=0)                        # (var, z, M)


def n2_rhs_twin(spec, df32_mode, ko_keys, y, leaves1, leaves2,
                accurate_math=False):
    """The fused RHS in plain PyTorch: y (M, n) -> (M, n) f32, the DSL's
    float32 transcendentals accurate (ops/accurate_math) or native as
    accurate_math says, whatever the switch."""
    M = y.shape[0]
    B = leaves1.shape[1]
    if M % B:
        raise ValueError(f"batch {M} not a multiple of member count {B}")
    p, d = _unpack(leaves1, leaves2, ko_keys, M // B)
    Y = y.to(_f32).reshape(M, spec.var_no_n2, spec.z_no).permute(1, 2, 0)
    with _dsl.accurate_f32_math(accurate_math):
        out = n2_core_ml(spec, df32_mode, Y, p, d)
    return out.permute(2, 0, 1).reshape(M, -1)


# -- the DSL recorder -----------------------------------------------------------

class _Graph:
    """Expression DAG of one traced rate program: nodes are
    (op, args, kind) in evaluation order; args are node Syms, Python
    numbers or None; kind is "df" (a DF32 pair) or "f" (plain f32)."""

    def __init__(self):
        self.nodes = []

    def add(self, op, args, kind):
        self.nodes.append((op, args, kind))
        return _Sym(self, len(self.nodes) - 1, kind)


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class _Sym:
    """A symbolic DSL value: every operation on it records a node."""

    __slots__ = ("g", "i", "kind")

    def __init__(self, g, i, kind):
        self.g, self.i, self.kind = g, i, kind

    def _rec(self, op, *args):
        for a in args:
            if not (isinstance(a, _Sym) or _number(a) or a is None):
                raise TypeError(
                    f"the CUDA RHS generator cannot express {op} on "
                    f"{type(a).__name__}")
        kind = "df" if any(isinstance(a, _Sym) and a.kind == "df"
                           for a in args) else "f"
        return self.g.add(op, args, kind)

    def __add__(self, o):
        return self._rec("add", self, o)

    def __radd__(self, o):
        return self._rec("add", o, self)

    def __sub__(self, o):
        return self._rec("sub", self, o)

    def __rsub__(self, o):
        return self._rec("sub", o, self)

    def __mul__(self, o):
        return self._rec("mul", self, o)

    def __rmul__(self, o):
        return self._rec("mul", o, self)

    def __truediv__(self, o):
        return self._rec("div", self, o)

    def __rtruediv__(self, o):
        return self._rec("div", o, self)

    def __pow__(self, o):
        return self._rec("pow", self, o)

    def __rpow__(self, o):
        return self._rec("pow", o, self)

    def __neg__(self):
        return self._rec("neg", self)

    def __bool__(self):
        raise TypeError("the CUDA RHS generator cannot express control "
                        "flow on a traced value")

    @staticmethod
    def _math_dispatch(name, *args):
        if name not in _CALLS:
            raise TypeError(f"the CUDA RHS generator cannot express "
                            f"math.{name}")
        sym = next(a for a in args if isinstance(a, _Sym))
        return sym._rec("call:" + name, *args)


_CALLS = ("exp", "log", "log10", "sqrt", "pow", "fabs")
_BINARY = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "div": operator.truediv, "pow": operator.pow}


def trace_rates(spec, df32_mode: bool, ko_keys=()):
    """Trace spec.rates.call_list with symbolic inputs. Returns
    (graph, rates) where rates are Syms or Python numbers."""
    g = _Graph()
    kind = "df" if df32_mode else "f"
    T = g.add("in", ("T",), kind)
    P = g.add("in", ("P",), kind)
    mofri = [g.add("in", (f"mofri{i}",), kind) for i in range(spec.n_comp)]
    conc = [g.add("in", (f"conc{i}",), kind) for i in range(spec.n_comp)]
    # overrides are plain f32 leaves in both modes, as in the twin
    ko = {k: g.add("in", (f"ko{j}",), "f") for j, k in enumerate(ko_keys)}
    rates = spec.rates.call_list(T, P, mofri, conc, ko)
    return g, rates


def interpret(graph, rates, inputs):
    """Evaluate a traced DAG on actual values (tensors or DF32 pairs)
    with Python's own dispatch; inputs maps the "in" names (T, P,
    mofri<i>, conc<i>, ko<j>) to values. Returns the rate list."""
    vals = []
    for op, args, _ in graph.nodes:
        a = [vals[x.i] if isinstance(x, _Sym) else x for x in args]
        if op == "in":
            vals.append(inputs[args[0]])
        elif op == "neg":
            vals.append(-a[0])
        elif op.startswith("call:"):
            name = op[5:]
            if name == "log":
                vals.append(_MATH_SHIM.log(a[0], a[1]))
            else:
                vals.append(getattr(_MATH_SHIM, name)(*a))
        else:
            vals.append(_BINARY[op](*a))
    return [vals[r.i] if isinstance(r, _Sym) else r for r in rates]


# -- the CUDA emitter -----------------------------------------------------------

def _hexf(x) -> str:
    v = float(np.float32(x))
    if not np.isfinite(v):
        raise ValueError(f"non-finite constant {x!r} in the rate program")
    return v.hex() + "f"


def _dflit(c) -> str:
    hi = np.float32(c)
    lo = np.float32(float(c) - float(hi))
    return f"df{{{_hexf(hi)}, {_hexf(lo)}}}"


def _is_int(v):
    return _number(v) and float(v).is_integer()


def _int_pow_expr(x: str, n: int) -> str:
    """accurate_math.int_pow's product chain as a C expression."""
    if n == 0:
        return "1.0f"
    acc, base, k = None, x, abs(n)
    while k:
        if k & 1:
            acc = base if acc is None else f"({acc} * {base})"
        k >>= 1
        if k:
            base = f"({base} * {base})"
    return f"(1.0f / {acc})" if n < 0 else acc


class _Emitter:
    """Emits the body of one rates device function from a traced DAG,
    reproducing at each node the operation Python dispatch performs on
    actual values (torch ops for plain f32; DF32 methods for pairs;
    ops/accurate_math's functions for the plain f32 exp, log, log10 and
    pow where `accurate` says)."""

    def __init__(self, graph, accurate=False):
        self.g = graph
        self.names = {}
        self.accurate = accurate

    def _kind(self, v):
        return v.kind if isinstance(v, _Sym) else "c"

    def f(self, v):
        return self.names[v.i] if isinstance(v, _Sym) else _hexf(v)

    def df(self, v):
        """DF32.from_value(v) as a C expression."""
        if isinstance(v, _Sym):
            n = self.names[v.i]
            return n if v.kind == "df" else f"df_f({n})"
        return _dflit(v)

    def fpow(self, a, b):
        """torch.pow semantics on f32 (its special-cased exponents)."""
        x = self.f(a)
        if _number(b):
            special = {2.0: f"({x} * {x})", 3.0: f"(({x} * {x}) * {x})",
                       0.5: f"sqrtf({x})", -0.5: f"(1.0f / sqrtf({x}))",
                       -1.0: f"(1.0f / {x})", -2.0: f"(1.0f / ({x} * {x}))",
                       1.0: x, 0.0: "1.0f"}
            if float(b) in special:
                return special[float(b)]
        return f"powf({x}, {self.f(b)})"

    def dfpow_method(self, a, b):
        """DF32.__pow__(a, b) with a a DF32."""
        if _is_int(b):
            return f"df_int_pow({self.df(a)}, {int(b)})"
        return f"df_exp(df_mul(df_log({self.df(a)}), {self.df(b)}))"

    def dfrpow_method(self, y, base):
        """DF32.__rpow__(y, base): exp(y * log(base))."""
        if _number(base):
            return f"df_exp(df_mul({self.df(y)}, {_dflit(_math.log(float(base)))}))"
        return f"df_exp(df_mul({self.df(y)}, df_log({self.df(base)})))"

    def binary(self, op, a, b):
        ka, kb = self._kind(a), self._kind(b)
        if ka != "df" and kb != "df":
            if op == "pow":
                return self.fpow(a, b)
            if op == "div" and ka == "c":
                # number / tensor: torch runs reciprocal-then-multiply
                return f"((1.0f / {self.f(b)}) * {self.f(a)})"
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
            return f"({self.f(a)} {sym} {self.f(b)})"
        if ka == "df":          # a.__op__(b)
            return {
                "add": lambda: f"df_add({self.df(a)}, {self.df(b)})",
                "sub": lambda: f"df_sub({self.df(a)}, {self.df(b)})",
                "mul": lambda: f"df_mul({self.df(a)}, {self.df(b)})",
                "div": lambda: f"df_div({self.df(a)}, {self.df(b)})",
                "pow": lambda: self.dfpow_method(a, b),
            }[op]()
        # b is the pair: Python falls back to b.__rop__(a)
        return {
            "add": lambda: f"df_add({self.df(b)}, {self.df(a)})",
            "sub": lambda: f"df_add(df_neg({self.df(b)}), {self.df(a)})",
            "mul": lambda: f"df_mul({self.df(b)}, {self.df(a)})",
            "div": lambda: f"df_div({self.df(a)}, {self.df(b)})",
            "pow": lambda: self.dfrpow_method(b, a),
        }[op]()

    def am_pow(self, a, b):
        """accurate_math.pow semantics on f32."""
        if (_number(b) and float(b).is_integer()
                and abs(b) <= _am.MAX_INT_POW and isinstance(a, _Sym)):
            return _int_pow_expr(self.f(a), int(b))
        return f"am_pow({self.f(a)}, {self.f(b)})"

    def call(self, name, args, kind):
        if kind != "df" and self.accurate and name != "sqrt" \
                and name != "fabs":
            x = self.f(args[0])
            if name == "pow":
                return self.am_pow(*args)
            if name == "log":
                base = args[1]
                return f"am_log({x})" if base is None else \
                    f"(am_log({x}) / am_log({self.f(base)}))"
            return f"am_{name}({x})"
        if kind != "df":
            x = self.f(args[0])
            if name == "pow":
                return self.fpow(*args)
            if name == "log":
                base = args[1]
                return f"logf({x})" if base is None else \
                    f"(logf({x}) / logf({self.f(base)}))"
            return {"exp": "expf", "log10": "log10f", "sqrt": "sqrtf",
                    "fabs": "fabsf"}[name] + f"({x})"
        if name == "pow":        # ops/df32.pow
            x, y = args
            if _is_int(y):
                return f"df_int_pow({self.df(x)}, {int(y)})"
            if _number(x):
                return self.dfrpow_method(y, x)
            return self.dfpow_method(x, y)
        if name == "log":
            x, base = args
            lg = f"df_log({self.df(x)})"
            return lg if base is None else f"df_div({lg}, df_log({self.df(base)}))"
        if name == "fabs":
            raise TypeError("the CUDA RHS generator cannot express "
                            "math.fabs on a DF32 pair")
        return {"exp": "df_exp", "log10": "df_log10",
                "sqrt": "df_sqrt"}[name] + f"({self.df(args[0])})"

    def body(self, inputs):
        lines = []
        for i, (op, args, kind) in enumerate(self.g.nodes):
            name = f"v{i}"
            self.names[i] = name
            ctype = "df" if kind == "df" else "float"
            if op == "in":
                src = inputs[args[0]]
                expr = f"df_f({src})" if kind == "df" else src
            elif op == "neg":
                expr = (f"df_neg({self.df(args[0])})" if kind == "df"
                        else f"(-{self.f(args[0])})")
            elif op.startswith("call:"):
                expr = self.call(op[5:], args, kind)
            else:
                expr = self.binary(op, *args)
            unused = "[[maybe_unused]] " if op == "in" else ""
            lines.append(f"  {unused}const {ctype} {name} = {expr};")
        return lines


def _rates_function(spec, df32_mode, ko_keys, accurate_math=False):
    g, rates = trace_rates(spec, df32_mode, ko_keys)
    em = _Emitter(g, accurate_math)
    inputs = {"T": "T", "P": "P"}
    for i in range(spec.n_comp):
        inputs[f"mofri{i}"] = f"mofri[{i}]"
        inputs[f"conc{i}"] = f"conc[{i}]"
    for j in range(len(ko_keys)):
        inputs[f"ko{j}"] = f"ko[{j}]"
    rt = "df" if df32_mode else "float"
    lines = [
        "__device__ __forceinline__ void rates(float T, float P, "
        "const float* mofri, const float* conc, const float* ko, "
        f"{rt}* r) {{",
        "  (void)ko;",
    ]
    lines += em.body(inputs)
    for m, r in enumerate(rates):
        lines.append(f"  r[{m}] = {em.df(r) if df32_mode else em.f(r)};")
    lines.append("}")
    return "\n".join(lines)


class TileGeometry(NamedTuple):
    """Thread-block geometry of the fused RHS kernel: mt member rows a
    block, one thread per (row, node), blockDim (mt, z_no). A block's rows
    are one contiguous span of mt*n floats of y; it stages them into a
    shared tile of mt rows at `pitch` floats, and writes its result from a
    second tile of the same shape, `vec` floats a copy (4: 16-byte copies;
    1 where a row's bytes are not a multiple of 16)."""
    mt: int
    threads: int
    pitch: int
    vec: int
    smem_bytes: int


# static shared memory a block may declare
_SMEM_STATIC = 48 * 1024


def tile_geometry(n, z_no, member_rows=0, mt=16):
    """The fused RHS kernel's tile for rows of n = var_no * z_no floats.

    mt (a power of two) is halved until the block fits 1024 threads and
    the static shared memory: two tiles of mt x pitch floats, the pressure
    march's factors (z_no x mt) and `member_rows` per-member rows (the
    leaves and the per-member quantities). The pitch makes a warp's reads
    of s_y[tx][s*z_no + zn] (and of the upwind node zn - 1) hit 32
    distinct banks: a warp holds min(mt, 32) rows tx of g = 32 / min(mt,
    32) consecutive nodes, so the pitch is g times an odd number."""
    if n % z_no or n <= 0:
        raise ValueError(f"row length {n} is not a multiple of z_no {z_no}")
    if mt < 1 or mt & (mt - 1):
        raise ValueError(f"mt {mt} is not a power of two")
    while mt >= 1:
        g = 32 // min(mt, 32)
        pitch = n + (-n) % g
        if (pitch // g) % 2 == 0:
            pitch += g
        smem = 4 * (2 * mt * pitch + (z_no + member_rows) * mt)
        if mt * z_no <= 1024 and smem <= _SMEM_STATIC:
            return TileGeometry(mt, mt * z_no, pitch,
                                4 if n % 4 == 0 else 1, smem)
        mt //= 2
    raise ValueError(f"no tile of the fused RHS fits n = {n}, z_no = {z_no}")


def staging_map(geo, n, rows):
    """The kernel's copies between a block's span of rows*n floats in
    device memory and its shared tile, as index arrays (span offset,
    tile offset), one entry per float: copy q moves vec floats from span
    offset q*vec to tile row r = q // (n/vec), column (q - r*(n/vec))*vec.
    The same map stages y in and writes the result out."""
    per_row = n // geo.vec
    q = np.arange(rows * per_row)
    r = q // per_row
    c = (q - r * per_row) * geo.vec
    k = np.arange(geo.vec)
    src = (q * geo.vec)[:, None] + k
    dst = (r * geo.pitch + c)[:, None] + k
    return src.ravel(), dst.ravel()


def _member_quantities(spec, K, leaf):
    """The per-member quantities of the kernel (functions of the leaves
    alone), each as (name, C expression) in n2_core_ml's order of
    operations; `leaf` maps a leaf name to its shared-memory read."""
    h = _hexf
    su, eps, vf, pa = leaf("SuGaVe0"), leaf("BeVoFr"), leaf("vf"), leaf("PaDi")
    cube = f"(({eps} * {eps}) * {eps})"
    erg_a = f"((({h(150.0)} * {leaf('GaMiVi')}) * {su}) / ({pa} * {pa}))"
    erg_b = f"(((1.0f - {eps}) * (1.0f - {eps})) / {cube})"
    erg_c_coef = f"((({h(1.75)} * {su}) * {su}) / {pa})"
    erg_d = f"((1.0f - {eps}) / {cube})"
    q = [("v_dl", f"{su} / {vf}"),
         ("ergcd", f"{erg_c_coef} * {erg_d}"),
         ("b_co", f"(-({erg_a} * {erg_b})) * {h(K.dz)}"),
         ("const_f1", f"1.0f / ({eps} * ({leaf('zf')} / {vf}))"),
         ("inv_gmc", f"1.0f / {leaf('GaMaCoTe0')}")]
    if not spec.iso_thermal:
        q += [("in_ga_ve_dl", f"({su} / {eps}) / {leaf('InGaVe0')}"),
              ("zf_vf", f"{leaf('zf')} / {vf}"),
              ("inv_ghc", f"1.0f / {leaf('GaHeCoTe0')}")]
    q += [(f"c_in{s}", f"{leaf(f'SpCoi0_{s}')} / {leaf('Cmax')}")
          for s in range(spec.n_comp)]
    return q


# rows a block, by mode: a df32 warp that holds one node of 32 members
# takes the same branches through the pair functions (measured faster
# than 16 rows on an H100); the plain kernel's 64 registers fit three
# 16-row blocks an SM
_MT_PLAIN, _MT_DF32 = 16, 32


def spec_geometry(spec, accurate_rates=False, ko_keys=()):
    """tile_geometry for one spec and mode: its row length, the mode's
    rows a block, and as member rows the leaves (leaves1's rows and
    leaves2's) and the per-member quantities."""
    n_leaves = len(_P_1D) + len(_D_1D) + len(ko_keys) + 2 * spec.n_comp
    n_pm = len(_member_quantities(spec, _Consts(spec), str))
    return tile_geometry(spec.var_no_n2 * spec.z_no, spec.z_no,
                         n_leaves + n_pm,
                         _MT_DF32 if accurate_rates == "df32" else _MT_PLAIN)


def kernel_source(spec, accurate_rates=False, ko_keys=(),
                  accurate_math=False) -> str:
    """The complete CUDA translation unit of the fused RHS for one spec
    and mode: df32 helpers, with accurate_math the accurate-math device
    functions, the generated rates function and the kernel around it (the
    rest of n2_core_ml), for the tile of spec_geometry. accurate_math is
    written into the source, so it is part of the build's cache key."""
    df32_mode = accurate_rates == "df32"
    K = _Consts(spec)
    nc, nz, nr = spec.n_comp, spec.z_no, spec.stoich.n_rxn
    n = spec.var_no_n2 * nz
    rt = "df" if df32_mode else "float"
    h = _hexf
    leaves = list(_P_1D) + list(_D_1D)
    n1 = len(leaves) + len(ko_keys)
    # shared row of each per-member leaf: leaves1 rows, then leaves2's
    # SpCoi0 and mw rows
    row = {k: i for i, k in enumerate(leaves)}
    row.update({f"SpCoi0_{s}": n1 + s for s in range(nc)})
    row.update({f"mw_{s}": n1 + nc + s for s in range(nc)})
    leaf = lambda k: f"s_l[{row[k]}][tx]"
    pm = _member_quantities(spec, K, leaf)
    pmi = {name: i for i, (name, _) in enumerate(pm)}
    geo = spec_geometry(spec, accurate_rates, ko_keys)
    L = []
    L.append("// Generated by rmt_tpu_torch/ops/cuda_rhs.py -- the fused N2 RHS "
             f"({'df32' if df32_mode else 'plain f32'} mode) for one chemistry.")
    L.append(_SOURCE_NOTE)
    L.append(f"// accurate f32 math: {'on' if accurate_math else 'off'} (the "
             "rate program's plain float32 exp, log, log10 and pow)")
    L.append("#include <cuda_runtime.h>")
    consts = {
        "DF_LN2_HI": _df32.LN2_HI, "DF_LN2_LO": _df32.LN2_LO,
        "DF_LN2_LO2": _df32.LN2_LO2, "DF_INV_LN2": _df32.INV_LN2,
        "DF_SQRT_HALF": _df32._SQRT_HALF, "DF_TINY": _df32._TINY,
        "DF_INV_LN10_HI": _df32.INV_LN10_HI,
        "DF_INV_LN10_LO": _df32.INV_LN10_LO,
    }
    for k, v in consts.items():
        L.append(f"#define {k} {h(v)}")
    L.append("#define DF_EXP_TAIL {" + ", ".join(h(c) for c in _df32.EXP_TAIL) + "}")
    L.append("#define DF_LOG_TAIL {" + ", ".join(h(c) for c in _df32.LOG_TAIL) + "}")
    L.append((_build.CSRC / "df32.cuh").read_text())
    if accurate_math:
        L.append(am_source())
    L.append(_rates_function(spec, df32_mode, ko_keys, accurate_math))

    K_body = []
    add = K_body.append
    add(f"constexpr int NZ = {nz};")
    add(f"constexpr int N = {n};")
    add(f"constexpr int MT = {geo.mt};")
    add(f"constexpr int PITCH = {geo.pitch};")
    add("constexpr int THREADS = MT * NZ;")
    add(f"constexpr int NL1 = {n1};")
    add(f"constexpr int NL = {n1 + 2 * nc};")
    add(f"constexpr int NPM = {len(pm)};")
    add("__device__ __forceinline__ float clampe(float c) {"
        f" return c < {h(K.eps_c)} ? {h(K.eps_c)} : c; }}")
    add("template <int VEC>")
    add("__global__ void __launch_bounds__(THREADS)")
    add("n2_rhs_kernel(const float* __restrict__ y, const float* __restrict__ l1,")
    add("              const float* __restrict__ l2, float* __restrict__ out,")
    add("              int M, int B) {")
    add("  __shared__ float s_y[MT * PITCH];")
    add("  __shared__ float s_o[MT * PITCH];")
    add("  __shared__ float s_l[NL][MT];")
    add("  __shared__ float s_pm[NPM][MT];")
    add("  __shared__ float s_a[NZ][MT];")
    add("  const int tx = threadIdx.x, zn = threadIdx.y;")
    add("  const int tid = zn * MT + tx;")
    add("  const int mm0 = blockIdx.x * MT;")
    add("  const int rows = min(MT, M - mm0);")
    add("  constexpr int PER_ROW = N / VEC;")
    add("  // 1. the block's rows of y, one contiguous span, into the padded")
    add("  // tile (cuda_rhs.staging_map), and each member's leaves once")
    add("  const float* __restrict__ ys = y + (long)mm0 * N;")
    add("  for (int q = tid; q < rows * PER_ROW; q += THREADS) {")
    add("    const int row = q / PER_ROW, col = (q - row * PER_ROW) * VEC;")
    add("    float* d = s_y + row * PITCH + col;")
    add("    if constexpr (VEC == 4) {")
    add("      const float4 v = __ldg(reinterpret_cast<const float4*>(ys) + q);")
    add("      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;")
    add("    } else {")
    add("      d[0] = __ldg(ys + q);")
    add("    }")
    add("  }")
    add("  for (int q = tid; q < NL * MT; q += THREADS) {")
    add("    const int i = q / MT, t = q - i * MT;")
    add("    const long b = min(mm0 + t, M - 1) % B;  // a ragged tile repeats its last row")
    add("    s_l[i][t] = i < NL1 ? __ldg(l1 + i * (long)B + b)")
    add("                        : __ldg(l2 + (i - NL1) * (long)B + b);")
    add("  }")
    add("  __syncthreads();")
    add("  // 2. the per-member quantities, one thread each")
    add("  for (int q = zn; q < NPM; q += NZ) {")
    add("    float v;")
    add("    switch (q) {")
    for i, (name, expr) in enumerate(pm):
        add(f"      case {i}: v = {expr}; break;  // {name}")
    add("      default: v = 0.0f;")
    add("    }")
    add("    s_pm[q][tx] = v;")
    add("  }")
    add("  __syncthreads();")
    add("  // 3. node zn of row tx; a dead row of a ragged tile computes on")
    add("  // row 0 and is not stored")
    add("  const float* yr = s_y + (tx < rows ? tx : 0) * PITCH;")
    node_leaves = ["T0", "P0", "BeVoFr", "Cmax", "GaDe0", "GaCpMeanMix0"]
    if not spec.iso_thermal:
        node_leaves += ["Tm", "U", "aEff"]
    for k in node_leaves:
        add(f"  const float {k} = {leaf(k)};")
    add(f"  float ko[{max(len(ko_keys), 1)}];")
    for j in range(len(ko_keys)):
        add(f"  ko[{j}] = s_l[{len(leaves) + j}][tx];")
    for s in range(nc):
        add(f"  const float mw_{s} = {leaf(f'mw_{s}')};")
    for name, _ in pm:
        add(f"  const float {name} = s_pm[{pmi[name]}][tx];")
    for s in range(nc):
        add(f"  const float c_raw{s} = yr[{s} * NZ + zn];")
        add(f"  const float c_cl{s} = clampe(c_raw{s});")
    if spec.iso_thermal:
        add("  const float T_dl = 0.0f;")
    else:
        add(f"  const float T_dl = yr[{nc} * NZ + zn];")
    add("  float co_re[NC_], mofri[NC_];".replace("NC_", str(nc)))
    for s in range(nc):
        add(f"  co_re[{s}] = c_cl{s} * Cmax;")
    add("  const float T_re = T_dl * T0 + T0;")
    add("  const float ctot = " + _chain("+", [f"co_re[{s}]" for s in range(nc)]) + ";")
    for s in range(nc):
        add(f"  mofri[{s}] = co_re[{s}] / ctot;")
    add("  const float mi_mo_we = " + _chain(
        "+", [f"(mofri[{s}] * mw_{s})" for s in range(nc)]) + f" * {h(1e-3)};")
    add("  const float eps = BeVoFr;")
    add(f"  const float rg_t = ({h(K.r_const)} / mi_mo_we) * T_re;")
    add(f"  const float a_co = 1.0f - (ergcd / rg_t) * {h(K.dz)};")
    add("  s_a[zn][tx] = a_co;")
    add("  __syncthreads();")
    add("  // pressure march: P_k = A_k (P0 + S_k), accumulated in node order")
    add("  float A = 1.0f, S = 0.0f;")
    add("  for (int k = 0; k < zn; ++k) {")
    add("    const float ak = s_a[k][tx];")
    add("    S = S + b_co / (A * ak);")
    add("    A = A * ak;")
    add("  }")
    add("  const float P_z = A * (P0 + S);")
    add("  const float ga_de_dl = (P_z / rg_t) / GaDe0;")
    add(f"  {rt} r[{nr}];")
    add("  rates(T_re, P_z, mofri, co_re, ko, r);")
    for s in range(nc):
        terms = []
        for m in range(nr):
            cmk = float(K.nu[m, s])
            if cmk == 0.0:
                continue
            terms.append(f"df_mul(r[{m}], {_dflit(cmk)})" if df32_mode
                         else f"(r[{m}] * {h(cmk)})")
        if not terms:
            add(f"  const float ri{s} = 0.0f;")
        elif df32_mode:
            add(f"  const df ri_df{s} = " + _chain_df(terms) + ";")
            add(f"  const float ri{s} = ri_df{s}.hi + ri_df{s}.lo;")
        else:
            add(f"  const float ri{s} = " + _chain("+", terms) + ";")
    for s in range(nc):
        add(f"  const float cp_i{s} = 0.5f * ({h(K.cp_ref[s])} + "
            f"{_cp_c(K.cp[s])});")
    add("  const float cp_mix = " + _chain(
        "+", [f"(mofri[{s}] * cp_i{s})" for s in range(nc)]) + ";")
    add("  const float cp_mix_dl = cp_mix / GaCpMeanMix0;")
    add("  const float cp_mix_eff_dl = cp_mix_dl * eps;")
    if not spec.iso_thermal:
        for e in range(len(K.cp_eq)):
            add(f"  const float cp_eq{e} = 0.5f * ({h(K.cp_eq_ref[e])} + "
                f"{_cp_c(K.cp_eq[e])});")
        add(f"  const float dT = T_re - {h(K.tref)};")
        ov_terms = []
        for m in range(nr):
            en = [f"({h(K.eq_nu[m, e])} * cp_eq{e})"
                  for e in range(len(K.cp_eq)) if float(K.eq_nu[m, e]) != 0.0]
            he = (f"(({_chain('+', en)}) * dT) + {h(K.dh25[m])}" if en
                  else h(K.dh25[m]))
            add(f"  const float he{m} = {he};")
            ov_terms.append(f"df_mul(r[{m}], df_f(he{m}))" if df32_mode
                            else f"(r[{m}] * he{m})")
        if df32_mode:
            add("  const df ov_df = " + _chain_df(ov_terms) + ";")
            add("  const float ov = ov_df.hi + ov_df.lo;")
        else:
            add("  const float ov = " + _chain("+", ov_terms) + ";")
        add("  const float qm = (Tm == 0.0f) ? 0.0f : (U * aEff) * (Tm - T_re);")
    add("  float* o = s_o + tx * PITCH;")
    add("  const int zu = zn > 0 ? zn - 1 : 0;  // the upwind node, in bounds")
    for s in range(nc):
        add(f"  const float c_back{s} = zn == 0 ? c_in{s} : "
            f"clampe(yr[{s} * NZ + zu]);")
        add(f"  const float dcdz{s} = (c_raw{s} - c_back{s}) * {h(K.inv_dz)};")
        add(f"  o[{s} * NZ + zn] = const_f1 * "
            f"(((-v_dl) * dcdz{s}) + (ri{s} * inv_gmc));")
    if not spec.iso_thermal:
        add(f"  const float t_back = zn == 0 ? 0.0f : yr[{nc} * NZ + zu];")
        add(f"  const float dtdz = (T_dl - t_back) * {h(K.inv_dz)};")
        add("  const float const_t2 = 1.0f / (((ga_de_dl * cp_mix_dl) * eps) * zf_vf);")
        add("  const float convective = (((-in_ga_ve_dl) * ga_de_dl) * cp_mix_eff_dl) * dtdz;")
        add(f"  o[{nc} * NZ + zn] = const_t2 * "
            "(convective + (((-ov) + qm) * inv_ghc));")
    add("  __syncthreads();")
    add("  // 4. the result tile to the caller's rows, row-major, the same map")
    add("  float* __restrict__ os = out + (long)mm0 * N;")
    add("  for (int q = tid; q < rows * PER_ROW; q += THREADS) {")
    add("    const int row = q / PER_ROW, col = (q - row * PER_ROW) * VEC;")
    add("    const float* src = s_o + row * PITCH + col;")
    add("    if constexpr (VEC == 4) {")
    add("      reinterpret_cast<float4*>(os)[q] = make_float4(src[0], src[1], src[2], src[3]);")
    add("    } else {")
    add("      os[q] = src[0];")
    add("    }")
    add("  }")
    add("}")
    add("")
    add("// vec: floats a copy, 4 (rows of a multiple of 16 bytes, 16-byte")
    add(f"// aligned operands) or 1; this chemistry's tile allows {geo.vec}")
    add('extern "C" int n2_rhs_launch(const float* y, const float* l1, '
        "const float* l2, float* out, int M, int B, int vec, void* stream) {")
    add("  const dim3 block(MT, NZ);")
    add("  const dim3 grid((M + MT - 1) / MT);")
    add("  cudaStream_t s = (cudaStream_t)stream;")
    if geo.vec == 4:
        add("  if (vec == 4) {")
        add("    n2_rhs_kernel<4><<<grid, block, 0, s>>>(y, l1, l2, out, M, B);")
        add("    return (int)cudaGetLastError();")
        add("  }")
    add("  if (vec != 1) return (int)cudaErrorInvalidValue;")
    add("  n2_rhs_kernel<1><<<grid, block, 0, s>>>(y, l1, l2, out, M, B);")
    add("  return (int)cudaGetLastError();")
    add("}")
    L.append(f"// {n1} scalar leaves per member: " + ", ".join(
        leaves + [f"ko[{j}]={k}" for j, k in enumerate(ko_keys)]))
    L.append(f"// tile: {geo}")
    L.append("\n".join(K_body))
    return "\n".join(L) + "\n"


def am_source() -> str:
    """ops/accurate_math's exp, log, log10 and pow as device functions:
    the same constants, the same Horner order and the same guards; each
    float32 operation rounds on its own under -fmad=false, so they equal
    the PyTorch functions bit for bit. The bit views are
    __float_as_int / __int_as_float, torch.round is rintf (half to even),
    and a guard that fails takes the native libm function, as the
    PyTorch where() does."""
    h = _hexf
    exp_horner = "\n".join(f"  p = p * r + {h(c)};"
                           for c in _am.EXP_COEFS[1:])
    log_horner = "\n".join(f"  p = p * s2 + {h(c)};"
                           for c in _am.LOG_COEFS[1:])
    return f"""\
__device__ __forceinline__ float am_pow2(int e) {{
  return __int_as_float((e + 127) << 23);
}}
__device__ __forceinline__ float am_ldexp2(float x, int k) {{
  const int k1 = min(max(k, -126), 127);
  const int k2 = min(max(k - k1, -126), 127);
  return (x * am_pow2(k1)) * am_pow2(k2);
}}
// exp(x + extra) for |x| < {_am.EXP_LIMIT}
template <bool EXTRA>
__device__ __forceinline__ float am_exp_kernel(float x, float extra) {{
  const float k = rintf(x * {h(_am.INV_LN2)});
  float r = (x - k * {h(_am.LN2_HI)}) - k * {h(_am.LN2_LO)};
  if (EXTRA) r = r + extra;
  float p = {h(_am.EXP_COEFS[0])};
{exp_horner}
  p = p * r + 1.0f;
  p = p * r + 1.0f;
  return am_ldexp2(p, (int)k);
}}
__device__ __forceinline__ float am_exp(float x) {{
  return fabsf(x) < {h(_am.EXP_LIMIT)} ? am_exp_kernel<false>(x, 0.0f)
                                        : expf(x);
}}
// log(x) = hi + lo for positive normal x
__device__ __forceinline__ void am_log_ext(float x, float& hi, float& lo) {{
  const int e = ((__float_as_int(x) >> 23) & 0xFF) - 126;
  float m = am_ldexp2(x, -e);
  const bool small = m < {h(_am.SQRT_HALF)};
  m = small ? m + m : m;
  const float ef = (float)(e - (small ? 1 : 0));
  const float s = (m - 1.0f) / (m + 1.0f);
  const float s2 = s * s;
  float p = {h(_am.LOG_COEFS[0])};
{log_horner}
  const float poly = (s * s2) * p;
  const float two_s = s + s;
  hi = ef * {h(_am.LN2_HI)} + two_s;
  lo = ((ef * {h(_am.LN2_HI)} - (hi - two_s)) + poly) + ef * {h(_am.LN2_LO)};
}}
__device__ __forceinline__ bool am_log_ok(float x) {{
  return x >= {h(_am.MIN_NORMAL)} && isfinite(x);
}}
__device__ __forceinline__ float am_log(float x) {{
  if (!am_log_ok(x)) return logf(x);
  float hi, lo;
  am_log_ext(x, hi, lo);
  return hi + lo;
}}
__device__ __forceinline__ float am_log10(float x) {{
  if (!am_log_ok(x)) return log10f(x);
  float hi, lo;
  am_log_ext(x, hi, lo);
  return (hi + lo) * {h(_am.INV_LN10)};
}}
__device__ __forceinline__ float am_split_hi(float a) {{
  const float c = {h(_am.SPLIT)} * a;
  return c - (c - a);
}}
// x ** y through the compensated log and a Dekker product of y and log(x)
__device__ __forceinline__ float am_pow(float x, float y) {{
  if (!(am_log_ok(x) && isfinite(y))) return powf(x, y);
  float hi, lo;
  am_log_ext(x, hi, lo);
  const float p = y * hi;
  const float a_hi = am_split_hi(y), a_lo = y - a_hi;
  const float b_hi = am_split_hi(hi), b_lo = hi - b_hi;
  const float err = (((a_hi * b_hi - p) + a_hi * b_lo) + a_lo * b_hi)
                    + a_lo * b_lo;
  const float p_lo = err + y * lo;
  return fabsf(p) < {h(_am.EXP_LIMIT)} ? am_exp_kernel<true>(p, p_lo)
                                        : expf(p);
}}"""


_SOURCE_NOTE = """\
// Replaces the TPU kernel rmt_tpu/ops/pallas_rhs.py::build_n2_fused (its
// pallas_call). One thread per (row, node), a block of MT rows x NZ nodes.
// What bounds it on an H100: instruction issue, not bytes. A row reads and
// writes 2 x N floats, but each (row, node) thread issues the whole rate
// chain: the DME kernel is 2,328 SASS instructions in plain mode and 7,440
// in df32 mode (cuobjdump, NVIDIA H100 80GB HBM3), most of them on every
// thread's path, which at M = 12,288 rows keeps the SMs' schedulers near
// their issue rate. So the design spends no instruction twice: the block
// reads the caller's row-major rows (one
// contiguous span, staged into shared memory with 16-byte loads at a pitch
// whose reads are free of bank conflicts) and writes its rows back the same
// way, so no transposing copy runs around the kernel; each member's leaves
// are loaded once per block, and the quantities that depend on the member
// alone (Ergun terms, inlet concentrations, reciprocals) are computed by
// one thread each and shared. Every operation of a node keeps the order of
// the plain-PyTorch twin (n2_core_ml), bit for bit under -fmad=false."""


def _chain(op, terms):
    """Left-to-right reduction ((t0 op t1) op t2) ..."""
    expr = terms[0]
    for t in terms[1:]:
        expr = f"({expr} {op} {t})"
    return expr


def _chain_df(terms):
    expr = terms[0]
    for t in terms[1:]:
        expr = f"df_add({expr}, {t})"
    return expr


def _cp_c(c):
    """cp polynomial at T_re as C, in _cp_poly's order."""
    c0, c1, c2, c3 = (_hexf(v) for v in c)
    return (f"((({c0} + ({c1} * T_re)) + (({c2} * T_re) * T_re)) + "
            f"((({c3} * T_re) * T_re) * T_re))")


# -- operation count ------------------------------------------------------------

# float32 operations of one double-float32 operation, counted from
# csrc/df32.cuh (two_sum 6, quick_two_sum 3, split 4, two_prod 17)
_DF_OPS = {"add": 11, "sub": 11, "mul": 24, "div": 41, "neg": 0,
           "call:exp": 125, "call:log": 90, "call:log10": 114,
           "call:sqrt": 42}


def _int_pow_muls(n):
    n = abs(int(n))
    return max(n.bit_length() + bin(n).count("1") - 2, 0)


# float32 operations of an accurate-math call, counted from am_source()
# (adds, multiplies, divides and rintf; bit operations and selects not)
_AM_OPS = {"call:exp": 24, "call:log": 27, "call:log10": 28,
           "call:pow": 70}


def _node_ops(op, args, kind, accurate=False):
    """float32 operations of one DAG node. A plain add, multiply, divide
    or libm call counts 1, an accurate-math call its operations; a pair
    operation counts its error-free transforms."""
    if op == "in":
        return 0
    if kind != "df":
        if accurate and op == "call:pow":
            y = args[1]
            if (_number(y) and float(y).is_integer()
                    and abs(y) <= _am.MAX_INT_POW):
                return _int_pow_muls(y) + (1 if float(y) < 0 else 0)
        if accurate and op in _AM_OPS:
            return _AM_OPS[op] + (_AM_OPS[op] + 1 if op == "call:log"
                                  and args[1] is not None else 0)
        return 0 if op == "neg" else 1
    if op == "pow" or op == "call:pow":
        x, y = args
        if _is_int(y):
            inv = _DF_OPS["div"] if float(y) < 0 else 0
            return _int_pow_muls(y) * _DF_OPS["mul"] + inv
        log = 0 if _number(x) else _DF_OPS["call:log"]
        return _DF_OPS["call:exp"] + _DF_OPS["mul"] + log
    if op == "call:log" and args[1] is not None:
        return 2 * _DF_OPS["call:log"] + _DF_OPS["div"]
    return _DF_OPS[op]


def operation_count(spec, accurate_rates=False, ko_keys=(),
                    accurate_math=False) -> int:
    """float32 operations one (row, node) of the fused RHS needs: the
    traced rate program node by node, plus the fixed part of n2_core_ml
    counted from its steps (the pressure march at its mean depth over the
    nodes). The roofline's operation bound is this times rows times
    nodes over the card's float32 rate."""
    df32_mode = accurate_rates == "df32"
    g, _ = trace_rates(spec, df32_mode, tuple(ko_keys))
    ops = sum(_node_ops(*node, accurate=accurate_math) for node in g.nodes)
    nc, nz, nr = spec.n_comp, spec.z_no, spec.stoich.n_rxn
    K = _Consts(spec)
    acc, mul = (_DF_OPS["add"], _DF_OPS["mul"]) if df32_mode else (1, 1)
    nnz = int(np.count_nonzero(K.nu))
    ops += 5 * nc + 2 * (nc - 1) + 3      # clamps, co_re, ctot, mofri, MW
    ops += 26                             # Ergun terms, rg_t, a_co, b_co
    ops += 3 * (nz - 1) // 2 + 4          # pressure march, P_z, density
    ops += nnz * mul + max(nnz - nc, 0) * acc + (nc if df32_mode else 0)
    ops += 13 * nc + 2 * nc + 1           # Cp polynomials, mixture Cp
    ops += 6 * nc + 7                     # convection rows and constants
    if not spec.iso_thermal:
        n_eq, nnz_eq = len(K.cp_eq), int(np.count_nonzero(K.eq_nu))
        ops += 13 * n_eq + 2 * nnz_eq + 2 * nr + 1    # heat of reaction
        ops += nr * mul + (nr - 1) * acc + (1 if df32_mode else 0)
        ops += 3 + 14                     # exchange, temperature row
    return int(ops)


# -- the wrapper ----------------------------------------------------------------

def build_n2_fused(spec, accurate_rates=False, ko_keys=()):
    """Fused-RHS builder. Returns ``rhs_f(y, leaves1, leaves2) -> (M, n)``
    where y is a contiguous (M, n) f32 tensor with M = s*B (stage-major
    stacking) and the leaves come from pack_leaves(p, d, ko_keys); the
    result is a new contiguous (M, n) tensor. A CUDA y launches the
    generated kernel (built at first call); a CPU y runs the twin.
    The DSL's accurate-f32 switch as it stands when rhs_f is made
    (kinetics/dsl.accurate_f32) fixes for this rhs_f whether the rate
    program's plain float32 exp/log/log10/pow are ops/accurate_math's, in
    the kernel and in its twin alike; the plain mode's accurate variant
    is the kernel n2_rhs_plain_am."""
    if accurate_rates not in (False, "df32"):
        raise ValueError("fused RHS supports accurate_rates False or 'df32'")
    df32_mode = accurate_rates == "df32"
    ko_keys = tuple(ko_keys)
    accurate_math = _dsl.accurate_f32()
    name = ("n2_rhs_df32" if df32_mode
            else "n2_rhs_plain_am" if accurate_math else "n2_rhs_plain")
    var_no, z_no = spec.var_no_n2, spec.z_no
    n = var_no * z_no
    state = {"lib": None}

    def source():
        return kernel_source(spec, accurate_rates, ko_keys, accurate_math)

    geo = spec_geometry(spec, accurate_rates, ko_keys)
    n_l1 = len(_P_1D) + len(_D_1D) + len(ko_keys)

    def lib():
        if state["lib"] is None:
            lib_ = _build.load(name, source())
            lib_.n2_rhs_launch.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib_.n2_rhs_launch.restype = ctypes.c_int
            state["lib"] = lib_
        return state["lib"]

    def rhs_f(y, leaves1, leaves2):
        if not y.is_cuda:
            return n2_rhs_twin(spec, df32_mode, ko_keys, y, leaves1, leaves2,
                               accurate_math)
        M = y.shape[0]
        B = leaves1.shape[1]
        if y.shape != (M, n) or M % B:
            raise ValueError(f"{name}: y shape {tuple(y.shape)} does not fit "
                             f"n={n}, B={B}")
        _build.check_operands(name, (y, leaves1, leaves2),
                              ((M, n), (n_l1, B), (2, spec.n_comp, B)))
        out = torch.empty((M, n), dtype=_f32, device=y.device)
        # 16-byte copies where the rows allow them and both operands are
        # 16-byte aligned (a view into a larger tensor may not be)
        vec = geo.vec if (y.data_ptr() | out.data_ptr()) % 16 == 0 else 1
        err = lib().n2_rhs_launch(
            y.data_ptr(), leaves1.data_ptr(), leaves2.data_ptr(),
            out.data_ptr(), M, B, vec, _build.stream(y))
        _build.check(err, name)
        LAUNCHES[name] += 1
        return out

    rhs_f.source = source
    rhs_f.geometry = geo
    rhs_f.kernel_name = name
    rhs_f.accurate_math = accurate_math
    rhs_f.twin = lambda y, l1, l2: n2_rhs_twin(
        spec, df32_mode, ko_keys, y, l1, l2, accurate_math)
    rhs_f.operations = lambda: operation_count(spec, accurate_rates, ko_keys,
                                               accurate_math)
    return rhs_f
