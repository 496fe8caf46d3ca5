# Global numeric configuration of the PyTorch port.
#
# The float policy mirrors rmt_tpu/config.py: float64 by default (the
# reference runs NumPy float64), float32 on request (RMT_TORCH_X64=0).
# Unlike JAX, PyTorch has no process-wide x64 switch, so the policy is a
# value that callers read (default_float) and every public function also
# takes an explicit dtype/device.
#
# TF32 stays OFF: reduced-precision f32 matmuls put ~1e-3 relative noise
# into the Radau stage construction and the eigen-transforms, which
# exceeds the Newton convergence floor and collapses the step controller
# (the same failure rmt_tpu/config.py:28-35 documents for bf16 passes).

import os

import torch


def setup() -> None:
    """Pin true-f32 matmuls and convolutions. Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def x64_enabled() -> bool:
    return os.environ.get("RMT_TORCH_X64", "1") != "0"


def default_float() -> torch.dtype:
    return torch.float64 if x64_enabled() else torch.float32


def default_device() -> torch.device:
    """The device of an entry point called without device=: the CUDA card.
    It is never the CPU; a caller who wants the CPU passes device="cpu"."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or default_device() when it is None.
    Raises when that names a CUDA card and the host has none, instead of
    running on the CPU."""
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"rmt_tpu_torch: device {dev} requested"
            + ("" if device is not None else " (the default)")
            + " but this host has no CUDA card; pass device='cpu' to run "
            "on the CPU")
    return dev
