"""Running mean/std normalizer state (PyTorch).

Port of `isaacgyminsertion_tpu/models/running_mean_std.py`: the state is an
explicit (mean, var, count) tuple, as the reference stores it in its
checkpoints; `rms_update` folds a batch in (Chan's parallel update),
`rms_normalize` standardizes and clips at ±5, `rms_unnormalize` inverts it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RMSState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # scalar


def rms_init(shape, device=None) -> RMSState:
    return RMSState(mean=torch.zeros(shape, device=device), var=torch.ones(shape, device=device),
                    count=torch.tensor(1e-4, device=device))


def rms_to(state: RMSState, device) -> RMSState:
    """An RMSState (numpy or torch fields) as float32 tensors on `device`."""
    return RMSState(*[torch.as_tensor(x, dtype=torch.float32, device=device) for x in state])


def rms_to_numpy(state: RMSState) -> RMSState:
    """An RMSState as float32 host arrays (copies), the layout of a checkpoint."""
    return RMSState(*[np.array(torch.as_tensor(x).detach().cpu(), np.float32) for x in state])


def rms_update(state: RMSState, batch: torch.Tensor) -> RMSState:
    """Parallel-variance (Chan et al.) update over all leading axes; the
    batch variance is the population variance, as `jnp.var` computes it."""
    dims = tuple(range(batch.ndim - state.mean.ndim))
    batch_mean = torch.mean(batch, dim=dims)
    batch_var = torch.var(batch, dim=dims, correction=0)
    return rms_fold(state, batch_mean, batch_var, float(np.prod(batch.shape[:len(dims)])))


def rms_fold(state: RMSState, batch_mean, batch_var, batch_count: float) -> RMSState:
    """Fold a batch's mean, population variance and count into the state
    (Chan et al.); `rms_update` on a batch, or on moments gathered over
    data-parallel ranks."""
    batch_count = torch.tensor(batch_count, dtype=state.count.dtype, device=state.count.device)
    delta = batch_mean - state.mean
    tot = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m_a = state.var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta**2 * state.count * batch_count / tot
    return RMSState(mean=new_mean, var=m2 / tot, count=tot)


def rms_normalize(state: RMSState, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    y = (x - state.mean) / torch.sqrt(state.var + 1e-5)
    return torch.clamp(y, -clip, clip)


def rms_unnormalize(state: RMSState, y: torch.Tensor) -> torch.Tensor:
    return y * torch.sqrt(state.var + 1e-5) + state.mean
