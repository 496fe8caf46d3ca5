# Conversion of rmt_tpu parameter trees into the port's dicts of tensors,
# so one input can be fed to both packages (the parity tests do).

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from . import config


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype: torch.dtype = torch.float64) -> dict[str, Any]:
    """The port's parameter dict from an rmt_tpu parameter tree.

    tree is the dict of rmt_tpu.models.homo.build_params (with its
    kinetic_overrides sub-dict) or a batched variant of it; leaves are
    numpy arrays, or anything np.asarray reads (jax arrays included).
    Every leaf becomes a tensor of ``dtype`` on ``device`` (default: the
    CUDA card, as every other entry point; without a card a call that
    names no device raises, see config.resolve_device).
    """
    device = config.resolve_device(device)
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = params_from_jax(val, device, dtype)
        else:
            out[key] = torch.as_tensor(np.array(val, dtype=np.float64),
                                       dtype=dtype, device=device)
    return out
