# The dp mesh of the ensembles (port of make_mesh and shard_batch of
# rmt_tpu/parallel/ensemble.py) over a torch.distributed process group.
#
# JAX runs one controller: a jax.sharding.Mesh lays the members of a
# vmapped program across devices and XLA inserts the collectives. The
# PyTorch idiom is one process per device. Here the mesh is a process
# group over one "dp" axis: every rank integrates a contiguous block of
# the members on its own device, and wherever the JAX program reduces
# over the member axis the port reduces across ranks explicitly, with the
# three collectives below (the lockstep integrator's early-exit and
# rescue flags, the scalar counters, the estimation loss and gradient,
# the gathered results).
#
# Under gloo the collectives exchange CPU copies of the tensors (gloo
# reduces host memory); under NCCL they exchange the device tensors.

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .. import config


@dataclass(frozen=True)
class Mesh:
    """One dp axis over a process group: this process is ``rank`` of
    ``size`` and integrates its members on ``device`` (the counterpart
    of rmt_tpu's jax.sharding.Mesh)."""
    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = "dp"


def make_mesh(group=None, device=None, axis: str = "dp") -> Mesh:
    """The mesh of a process group (default: the default group, which
    the caller makes with torch.distributed.init_process_group and the
    backend of its choice). ``device`` defaults to this rank's card,
    cuda:(rank % device_count); without a card that raises, as every
    entry point does (pass device="cpu" for the CPU)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "torch.distributed.init_process_group(backend, init_method, "
            "world_size, rank) first")
    rank = dist.get_rank(group)
    if device is None:
        device = (f"cuda:{rank % torch.cuda.device_count()}"
                  if torch.cuda.is_available() else None)
    return Mesh(group, rank, dist.get_world_size(group),
                config.resolve_device(device), axis)


def device_for(mesh, device=None) -> torch.device:
    """The device an entry point works on: without a mesh ``device``
    (config.resolve_device: the card unless the caller names another),
    with one the mesh's (a device= naming another raises)."""
    if mesh is None:
        return config.resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), "
                        f"not {type(mesh).__name__}")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    return mesh.device


def member_slice(mesh: Mesh, b: int) -> slice:
    """This rank's contiguous block of a batch of b members. A b that the
    mesh size does not divide raises, as jax.device_put of a
    P("dp")-sharded batch does."""
    if b % mesh.size:
        raise ValueError(f"the ensemble size {b} is not divisible by the "
                         f"{mesh.axis} mesh size {mesh.size}")
    k = b // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_rows(mesh: Mesh, x) -> torch.Tensor:
    """This rank's members (leading axis) of x, on the mesh's device."""
    return torch.as_tensor(x)[member_slice(mesh, len(x))].to(mesh.device)


def shard_batch(mesh: Mesh, params, axes):
    """This rank's share of a sweep (params and in_dims axes from
    batch_params): every swept leaf (axes 0) cut to the rank's block of
    B / size members, every other leaf whole; all on the mesh's device."""
    sizes = {len(v) for k, v in params.items()
             if k != "kinetic_overrides" and axes[k] == 0}
    sizes |= {len(v) for k, v in params["kinetic_overrides"].items()
              if axes["kinetic_overrides"][k] == 0}
    if len(sizes) > 1:
        raise ValueError(f"swept leaves of different lengths {sorted(sizes)}")

    def place(leaf, ax):
        if ax == 0:
            return shard_rows(mesh, leaf)
        return leaf.to(mesh.device)

    return {k: ({kk: place(vv, axes[k][kk]) for kk, vv in v.items()}
                if k == "kinetic_overrides" else place(v, axes[k]))
            for k, v in params.items()}


def _nccl(mesh: Mesh) -> bool:
    """Whether the collectives exchange device tensors (NCCL) or CPU
    copies (gloo)."""
    return dist.get_backend(mesh.group) == "nccl"


def any_across(mesh: Mesh, flags: torch.Tensor) -> list[bool]:
    """Each entry of a small bool vector OR-ed over the ranks (MAX), in one
    exchange: the one host read of the reduced flags."""
    x = flags.to(device=flags.device if _nccl(mesh) else "cpu",
                 dtype=torch.int32, copy=True)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return [bool(v) for v in x.tolist()]


def sum_across(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """tensor summed over the ranks, on tensor's device."""
    x = tensor.detach().to("cpu" if not _nccl(mesh) else tensor.device,
                           copy=True)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x.to(tensor.device)


def gather_members(mesh: Mesh, tensor: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's block of members along ``dim`` joined in rank order:
    the whole batch, on every rank, on tensor's device (the counterpart of
    reading a dp-sharded global array)."""
    x = tensor.detach()
    flag = x.dtype == torch.bool         # gloo gathers no bool tensors
    x = (x.to(torch.uint8) if flag else x).contiguous()
    x = x if _nccl(mesh) else x.cpu()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts, dim=dim).to(tensor.device)
    return out.bool() if flag else out


def gather_tree(mesh: Mesh, tree, dim: int = 0):
    """gather_members over every tensor of a tuple or a NamedTuple (dim for
    each; nested ones too); other leaves (scalars equal on every rank)
    unchanged."""
    if isinstance(tree, tuple):
        vals = [gather_tree(mesh, v, dim) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return gather_members(mesh, tree, dim)
    return tree
