# Constant numpy tables of a model (stoichiometry, stencil weights, ...)
# as tensors on the device a state lives on, made once per dtype and
# device instead of copied to the device at every call.

from __future__ import annotations

import numpy as np
import torch


class DeviceTables:
    """tables(like) -> {name: tensor} of the arrays given at construction,
    each of like's dtype on like's device (cached per dtype and
    device)."""

    def __init__(self, **arrays):
        self._arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._cache = {}

    def __call__(self, like: torch.Tensor) -> dict[str, torch.Tensor]:
        key = (like.dtype, like.device)
        if key not in self._cache:
            self._cache[key] = {
                k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                for k, v in self._arrays.items()}
        return self._cache[key]
