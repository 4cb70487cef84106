"""Batched math shared by the physics, the env and the controllers."""

from __future__ import annotations

import numpy as np
import torch

_CONST_CACHE: dict = {}


def const(a, device, dtype=torch.float32) -> torch.Tensor:
    """Device copy of a static host array (robot/asset tables, structure
    tensors), made once per (array, device, dtype) and reused.

    The cache holds a reference to `a`, so its `id` cannot be recycled while
    the entry lives; callers must not mutate a cached array."""
    key = (id(a), str(torch.device(device)), dtype)
    hit = _CONST_CACHE.get(key)
    if hit is not None and hit[0] is a:
        return hit[1]
    t = torch.as_tensor(np.asarray(a), device=device)
    if dtype is not None:
        t = t.to(dtype)
    _CONST_CACHE[key] = (a, t)
    return t
