"""Domain-randomization noise engine (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/envs/dr.py`: per-parameter noise with
  - a white component resampled every application,
  - a *correlated* component sampled once per randomization window and held
    (state in EnvState, refreshed by the reset path),
  - linear/constant schedule scaling of the ranges by the global step count,
  - additive or scaling composition, gaussian or uniform distributions.

Random draws come from an explicit `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class NoiseSpec:
    """One randomization_params entry (observations / actions / gravity)."""

    range: tuple = (0.0, 0.0)             # (mu, var) gaussian | (lo, hi) uniform
    range_correlated: tuple = (0.0, 0.0)  # correlated component ranges
    operation: str = "additive"           # "additive" | "scaling"
    distribution: str = "gaussian"        # "gaussian" | "uniform"
    schedule: str | None = None           # None | "linear" | "constant"
    schedule_steps: int = 40_000


def schedule_scaling(spec: NoiseSpec, global_step: int) -> float:
    """Schedule scaling of the noise ranges (1.0 when no schedule)."""
    gs = float(global_step)
    if spec.schedule == "linear":
        return min(gs, float(spec.schedule_steps)) / float(spec.schedule_steps)
    if spec.schedule == "constant":
        return float(gs >= float(spec.schedule_steps))
    return 1.0


def _scheduled_params(spec: NoiseSpec, sched: float):
    """Scale (a, b, a_corr, b_corr) by the schedule: additive ranges scale
    toward zero noise; a scaling op's white component toward identity and its
    correlated component toward 0."""
    a, b = float(spec.range[0]), float(spec.range[1])
    ac, bc = float(spec.range_correlated[0]), float(spec.range_correlated[1])
    if spec.operation == "additive":
        return a * sched, b * sched, ac * sched, bc * sched
    if spec.distribution == "gaussian":
        return a * sched + (1.0 - sched), b * sched, ac * sched, bc * sched
    return (a * sched + (1.0 - sched), b * sched + (1.0 - sched), ac * sched, bc * sched)


def sample_correlated(spec: NoiseSpec, generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """The raw correlated sample held for a randomization window."""
    if spec.distribution == "uniform":
        return torch.rand(shape, generator=generator, device=device)
    return torch.randn(shape, generator=generator, device=device)


def apply_noise(spec: NoiseSpec, generator: torch.Generator, corr_raw: torch.Tensor,
                tensor: torch.Tensor, global_step: int) -> torch.Tensor:
    """Correlated + white noise applied to `tensor`."""
    a, b, ac, bc = _scheduled_params(spec, schedule_scaling(spec, global_step))
    if spec.distribution == "gaussian":
        corr = corr_raw * bc + ac
        white = torch.randn(tensor.shape, generator=generator, device=tensor.device) * b + a
    else:
        corr = corr_raw * (bc - ac) + ac
        white = torch.rand(tensor.shape, generator=generator, device=tensor.device) * (b - a) + a
    noise = corr + white
    if spec.operation == "additive":
        return tensor + noise
    return tensor * noise
