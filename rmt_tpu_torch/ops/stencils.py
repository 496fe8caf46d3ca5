# Axial finite-difference stencils of the axial-dispersion models (port
# of rmt_tpu/ops/stencils.py, the parts T3 and M14 run): the per-node
# 4-point weight rows of the reference's mesh-dependent stencils, their
# application to whole axial profiles, and the two-zone refined mesh.
#
# (reference: PyREMOT/solvers/solFiDi.py:574-695 for the pointwise stencil
# formulas, :698-836 for the mesh generator.) The weights and the mesh are
# numpy float64 tables built once per model, the same arithmetic as
# rmt_tpu's; apply_axial_weights moves them to the profile's device.

from __future__ import annotations

import numpy as np
import torch


def axial_stencil_weights(z_no: int, mesh=None):
    """Per-node 4-point weights [bb, b, c, f] for the reference's
    mesh-dependent axial stencils (BD first derivative, CD second
    derivative), reproducing the 5-branch node selection of
    modelEquationT1/M2/M7 (homoModels.py:1159-1256,
    pbHeterReactor.py:1857-2160):

      * node 0: BD over dzs[0] + non-uniform CD with the python-wrapped
        ratio dzs[0]/dzs[-1] (the reference indexes dzs[z-1] at z=0);
      * dense-section nodes 0 < z < zNoNo[0]: non-uniform BD with
        R_b = dzs[z-2]/dzs[z-1] (z=1 wraps to dzs[-1]/dzs[0]) and
        non-uniform CD with R_c = dzs[z]/dzs[z-1];
      * everything else (incl. the outlet): uniform weights on the
        normal-zone dz.

    mesh: a two_zone_mesh(...) result (plus key "n_dense" = zNoNo[0]) or
    None for the uniform grid. The b/f slots refer to the neighbor arrays
    INCLUDING the model's inlet ghost / outlet mirror; bb refers to
    roll(F, 2), which reproduces the reference's python negative indexing
    at z=1. Returns dict with W1, W2 (z_no, 4) and dz_bc1 (the spacing in
    the Danckwerts ghost constant, dzs[0] on a refined mesh)."""
    if mesh is None:
        dz_uni = 1.0 / (z_no - 1)
        dzs = np.full(z_no, dz_uni)
        n_dense = 0
    else:
        dzs = np.asarray(mesh["dzs"], dtype=np.float64)
        dz_uni = float(mesh["dz_uniform"])
        n_dense = int(mesh["n_dense"])
        assert mesh["n_nodes"] == z_no, (mesh["n_nodes"], z_no)

    W1 = np.zeros((z_no, 4))
    W2 = np.zeros((z_no, 4))
    for z in range(z_no):
        if z == 0:
            h = dzs[0]
            W1[z, 1], W1[z, 2] = -1.0 / h, 1.0 / h
            if mesh is None:
                W2[z, 1:] = np.array([1.0, -2.0, 1.0]) / h**2
            else:
                R = dzs[0] / dzs[-1]          # python dzs[z-1] wrap quirk
                c2 = 2.0 / (R * (R + 1) * h**2)
                W2[z, 1], W2[z, 2], W2[z, 3] = R * c2, -(R + 1) * c2, c2
        elif mesh is not None and 0 < z < n_dense:
            Rb = dzs[z - 2] / dzs[z - 1]      # z=1 wraps to dzs[-1]/dzs[0]
            c1 = 1.0 / (Rb * (Rb + 1) * dzs[z])
            W1[z, 0] = c1
            W1[z, 1] = -((1 + Rb) ** 2) * c1
            W1[z, 2] = Rb * (Rb + 2) * c1
            Rc = dzs[z] / dzs[z - 1]
            c2 = 2.0 / (Rc * (Rc + 1) * dzs[z] ** 2)
            W2[z, 1], W2[z, 2], W2[z, 3] = Rc * c2, -(Rc + 1) * c2, c2
        else:
            W1[z, 1], W1[z, 2] = -1.0 / dz_uni, 1.0 / dz_uni
            W2[z, 1:] = np.array([1.0, -2.0, 1.0]) / dz_uni**2
    return {"W1": W1, "W2": W2, "dz_bc1": float(dzs[0])}


def apply_axial_weights(W, F, ghost, mirror=None):
    """d(F)/dz (or d2) along the last axis from the 4-point weights.

    F: (..., zNo); ghost: inlet backward value (..., 1)-broadcastable;
    mirror: outlet forward value (defaults to F[..., -2], the reference's
    zero-gradient BC2). W: the (zNo, 4) numpy table or a tensor of it."""
    edge = F[..., :1].shape
    b = torch.cat([torch.as_tensor(ghost, dtype=F.dtype,
                                   device=F.device).expand(edge),
                   F[..., :-1]], dim=-1)
    if mirror is None:
        f = torch.cat([F[..., 1:], F[..., -2:-1]], dim=-1)
    else:
        f = torch.cat([F[..., 1:], torch.as_tensor(
            mirror, dtype=F.dtype, device=F.device).expand(edge)], dim=-1)
    bb = torch.roll(F, 2, dims=-1)
    Wt = torch.as_tensor(W, dtype=F.dtype, device=F.device)
    return Wt[:, 0] * bb + Wt[:, 1] * b + Wt[:, 2] * F + Wt[:, 3] * f


def two_zone_mesh(n_nodes, length, dense_fraction_pct, refine_exponent):
    """Two-zone 1-D mesh: a power-law refined dense section followed by a
    uniform section (reference FiDiMeshGenerator, solFiDi.py:698-836).

    n_nodes: (n_dense, n_normal); returns dict with node positions, element
    sizes, node count, backward-ratio list, uniform dz.
    """
    n_dense, n_normal = n_nodes
    dome = (dense_fraction_pct / 100.0) * length
    xs_dense = np.array([((i / (n_dense - 1)) ** refine_exponent) * dome for i in range(n_dense)])
    dz_dense = np.diff(xs_dense)
    xs_normal = np.linspace(dome, length, n_normal)
    dz_uniform = (length - dome) / (n_normal - 1)
    dzs = np.concatenate([dz_dense, np.repeat(dz_uniform, n_normal)])
    xs = np.concatenate([xs_dense, xs_normal[1:]])
    n_total = n_dense + n_normal - 1

    # backward ratio per element (reference :777-805)
    n_el_dense = n_dense - 1
    rs = np.zeros(n_total)
    for i in range(n_total):
        if 2 <= i <= n_el_dense:
            rs[i] = dzs[i - 2] / dzs[i - 1]
        elif i > n_el_dense:
            rs[i] = 1.0
    return {
        "xs": xs,
        "dzs": dzs[: n_total - 1 + 1],
        "n_nodes": n_total,
        "n_dense": n_dense,
        "rs": rs,
        "dz_uniform": dz_uniform,
    }


def solver_grid(model_input, default_z_no: int):
    """(mesh, zNo) of a steady axial-dispersion model's solver-config: the
    two-zone refined mesh (the reference's zMesh settings of solverSetting
    T1 and M9, solSetting.py:56-62) unless mesh is "normal", else (None,
    zNo uniform nodes, default default_z_no)."""
    sc = model_input.get("solver-config", {})
    if sc.get("mesh", "normal") != "normal":
        mesh = two_zone_mesh((15, 10), 1.0, 30, 1.001)
        return mesh, int(mesh["n_nodes"])
    return None, int(sc.get("zNo", default_z_no))
