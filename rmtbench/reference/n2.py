"""The N2 dynamic packed-bed reactor in plain float64 NumPy: the benchmark's
reference for every N2 configuration.

A frozen copy of PyREMOT's modelEquationN2 (docs/pbHomoReactor.py:
3706-4134) in its dimensionless form: method of lines over z_no axial
nodes, backward-difference convection with the inlet as boundary, the
explicit axial pressure march of the Ergun equation (a forward recurrence
inside the right-hand side, as PyREMOT has it), ideal-gas properties,
Wilke's viscosity rule and the reactions' heat. The configuration's
chemistry (configs/<config>.py) gives the species data, the stoichiometry
and the rate law; its JSON file (configs/<config>.json) gives the
reactor, the feed and the grid. Nothing here imports the measured program.

Each member is integrated on its own by SciPy's Radau IIA (order 5,
its own step control and finite-difference Jacobian), output segment by
output segment, at a tolerance far below the program's.
"""

from __future__ import annotations

import math

import numpy as np

R_CONST = 8.314472          # J/(mol K), PyREMOT core/constants.py
EPS_CONST = 1e-30           # concentration floor of the dynamic models
T_REF = 273.15 + 25.0       # K

# the reference's own tolerance, bench_ref.npz's: the program integrates at
# rtol >= 6e-7 and its error reads about 1e-6, the reference's about 3e-10
# (it and bench_ref.npz's independent float64 Radau agree that far)
RTOL, ATOL = 1e-9, 1e-12


def _cp(coef, T):
    """Ideal-gas Cp [kJ/(kmol K)] of each species row of coef (S, 4) at the
    temperatures T (...,): shape T.shape + (S,)."""
    T = np.asarray(T, dtype=np.float64)[..., None]
    return coef[:, 0] + coef[:, 1] * T + coef[:, 2] * T ** 2 \
        + coef[:, 3] * T ** 3


def _cp_mean(coef, T):
    """Mean Cp between T_REF and T: the mean of the two end values."""
    return 0.5 * (_cp(coef, T_REF) + _cp(coef, T))


def _viscosity(chem, T):
    """Pure-species low-pressure viscosity [Pa s] at the scalar T."""
    out = np.empty(len(chem["mw"]))
    for i, (a, b, c, d) in enumerate(chem["visc"]):
        if chem["visc_eq2"][i]:
            out[i] = 2.68e-7 * T ** 0.3975 / (1.0 + 534.0 / T)
        else:
            out[i] = a * 1e-6 * T ** b / (1.0 + c / T + d / T ** 2)
    return out


def _wilke(visc, y, mw):
    """Wilke's mixture viscosity, with PyREMOT's lower triangle
    phi_ji = (mu_j / mu_i) (M_i / M_j) phi_ij."""
    n = len(visc)
    phi = np.eye(n)
    for i in range(n):
        for j in range(i + 1, n):
            phi[i, j] = (1.0 + math.sqrt(visc[i] / visc[j])
                         * (mw[j] / mw[i]) ** 0.25) ** 2 / math.sqrt(
                             8.0 * (1.0 + mw[i] / mw[j]))
    for i in range(n):
        for j in range(i):
            phi[i, j] = (visc[i] / visc[j]) * (mw[j] / mw[i]) * phi[j, i]
    return float(sum(visc[i] * y[i] / np.dot(y, phi[i]) for i in range(n)))


def member_params(config, t0):
    """One member's inputs: the configuration's reactor and feed at inlet
    temperature t0 [K]."""
    q = dict(config["operating"])
    q["T0"] = float(t0)
    q["SpCoi0"] = np.asarray(q["SpCoi0"], dtype=np.float64)
    return q


def feed_state(chem, q):
    """The inlet's reference scales (PyREMOT pbHomoReactor.py:2744-2833)."""
    mw = chem["mw"]
    area = math.pi * q["ReInDi"] ** 2 / 4.0
    c0 = q["SpCoi0"]
    ct0 = float(np.sum(c0))
    y0 = c0 / ct0
    cp0 = float(np.dot(y0, _cp_mean(chem["cp"], q["T0"])))
    mw0 = float(np.dot(y0, mw)) * 1e-3
    rho0 = mw0 * ct0
    vf = q["VoFlRa0"] / area
    zf = q["ReLe"]
    c_max = float(np.max(c0))
    return dict(
        SpCo0=ct0, SuGaVe0=vf, InGaVe0=q["VoFlRa0"] / (area * q["BeVoFr"]),
        GaMiVi=_wilke(_viscosity(chem, q["T0"]), y0, mw),
        GaCpMeanMix0=cp0, GaDe0=rho0, Cmax=c_max, vf=vf, zf=zf,
        # PyREMOT's "MAX" scale: every species is scaled by max(C_f)
        GaMaCoTe0=(vf / zf) * c_max,
        GaHeCoTe0=rho0 * vf * q["T0"] * (cp0 / mw0) / zf,
        # the exchange area is always 4 / ReInDi (pbHomoReactor.py:2778)
        aEff=4.0 / q["ReInDi"])


def initial_state(chem, q, d, z_no):
    """Feed concentrations over every node; theta = 0 (flat v * z_no + z)."""
    rows = np.repeat((q["SpCoi0"] / d["Cmax"])[:, None], z_no, axis=1)
    return np.concatenate([rows, np.zeros((1, z_no))]).reshape(-1)


def output_times(q, t_no):
    return q["opT"] * np.linspace(0.0, 1.0, t_no + 1)


def make_rhs(chem, q, z_no):
    """dy/dt of one member, y the flat (n_comp + 1) x z_no state:
    dimensionless concentrations C_i / max(C_f) and theta = (T - T0) / T0."""
    d = feed_state(chem, q)
    nc = len(chem["mw"])
    mw, nu = chem["mw"], chem["nu"]
    dz = 1.0 / (z_no - 1)
    eps = q["BeVoFr"]
    T0, P0 = q["T0"], q["P0"]
    su = d["SuGaVe0"]          # frozen superficial velocity
    v_dl = su / d["vf"]
    in_dl = (su / eps) / d["InGaVe0"]
    erg_a = 150.0 * d["GaMiVi"] * su / q["PaDi"] ** 2
    erg_b = (1.0 - eps) ** 2 / eps ** 3
    erg_c = 1.75 * su ** 2 / q["PaDi"]
    erg_d = (1.0 - eps) / eps ** 3
    c_in = q["SpCoi0"] / d["Cmax"]
    adiabatic = q["Tm"] == 0.0
    rate = chem["rates"]

    def rhs(t, y):
        # y (n,) or (n, k): k states at once, as SciPy's finite-difference
        # Jacobian asks for them (vectorized=True)
        Y = y.reshape((nc + 1, z_no) + y.shape[1:])
        c_raw = Y[:nc]
        c = np.maximum(c_raw, EPS_CONST)
        th = Y[nc]
        conc = c * d["Cmax"]                                # mol/m^3
        T = th * T0 + T0
        x = conc / np.sum(conc, axis=0)
        mw_mix = np.tensordot(mw, x, axes=1) * 1e-3         # kg/mol
        rg_t = (R_CONST / mw_mix) * T
        # the pressure march: P[0] = P0, P[k+1] = a[k] P[k] + b
        a = 1.0 - (erg_c * erg_d / rg_t) * dz
        b = -(erg_a * erg_b) * dz
        P = np.empty_like(T)
        P[0] = P0
        for k in range(z_no - 1):
            P[k + 1] = a[k] * P[k] + b
        rho_dl = (P / rg_t) / d["GaDe0"]
        r = rate(T, P, x, conc)                             # (n_rxn, z, ...)
        ri = np.tensordot(nu.T, r, axes=1)                  # (n_comp, z, ...)
        cp_mix = np.sum(np.moveaxis(x, 0, -1)
                        * _cp_mean(chem["cp"], T), axis=-1)
        cp_dl = cp_mix / d["GaCpMeanMix0"]
        dh = (_cp_mean(chem["eq_cp"], T) @ chem["eq_nu"].T) \
            * (T - T_REF)[..., None] + chem["dh25"]         # (z, ..., n_rxn)
        heat = np.sum(np.moveaxis(r, 0, -1) * dh, axis=-1)
        qm = 0.0 if adiabatic else q["U"] * d["aEff"] * (q["Tm"] - T)
        c_first = np.broadcast_to(
            c_in.reshape((nc, 1) + (1,) * (y.ndim - 1)),
            (nc, 1) + y.shape[1:])
        c_back = np.concatenate([c_first, c[:, :-1]], axis=1)
        dcdt = (1.0 / (eps * (d["zf"] / d["vf"]))) * (
            -v_dl * (c_raw - c_back) / dz + ri / d["GaMaCoTe0"])
        th_back = np.concatenate([np.zeros_like(th[:1]), th[:-1]])
        dtdt = (1.0 / (rho_dl * cp_dl * eps * (d["zf"] / d["vf"]))) * (
            -in_dl * rho_dl * cp_dl * eps * (th - th_back) / dz
            - heat / d["GaHeCoTe0"] + qm / d["GaHeCoTe0"])
        return np.concatenate([dcdt, dtdt[None]]).reshape(y.shape)

    return rhs, d


def integrate(chem, config, t0, rtol=RTOL, atol=ATOL):
    """One member's states at the configuration's output times,
    (t_no + 1, n), row 0 the initial state."""
    from scipy.integrate import solve_ivp

    z_no, t_no = config["z_no"], config["t_no"]
    q = member_params(config, t0)
    rhs, d = make_rhs(chem, q, z_no)
    ts = output_times(q, t_no)
    ys = [initial_state(chem, q, d, z_no)]
    for k in range(t_no):
        sol = solve_ivp(rhs, (ts[k], ts[k + 1]), ys[-1], method="Radau",
                        rtol=rtol, atol=atol, vectorized=True)
        if not sol.success:
            raise RuntimeError(f"reference integration failed at T0 = "
                               f"{t0}: {sol.message}")
        ys.append(sol.y[:, -1])
    return np.stack(ys)
