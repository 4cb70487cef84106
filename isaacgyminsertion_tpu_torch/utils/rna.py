"""RandomNetworkAdversary — random-net action perturbation DR.

Parity: utils/rna_util.py:37-163 (from DeXtreme): a frozen randomly
initialized MLP maps (obs, noise) → per-dim action perturbations, re-drawn
periodically. Port of `isaacgyminsertion_tpu/utils/rna.py` as an
`nn.Module` on flax's names (`Dense_0..2`) and flax's init (lecun-normal
kernels, zero biases), drawing from explicit `torch.Generator`s;
`load_jax_params` / `to_jax_params` move its weights to and from the flax
tree. Available but not wired into the insertion task (same status as the
reference).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import zoo

NOISE_DIM, HIDDEN = 8, 128


class RandomNetworkAdversary(nn.Module):
    """tanh(MLP(obs ⊕ z)) · scale added to the actions; built on the CPU
    (move it with `.to`)."""

    def __init__(self, obs_dim: int, num_actions: int = 6, scale: float = 0.05, seed: int = 0):
        super().__init__()
        self.obs_dim, self.scale = obs_dim, scale
        self.Dense_0 = nn.Linear(obs_dim + NOISE_DIM, HIDDEN)
        self.Dense_1 = nn.Linear(HIDDEN, HIDDEN)
        self.Dense_2 = nn.Linear(HIDDEN, num_actions)
        self.requires_grad_(False)
        self.refresh(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def refresh(self, generator: torch.Generator):
        """Re-draw the adversary weights (periodic re-randomization) from a
        CPU generator."""
        dev = self.Dense_0.weight.device
        zoo.init_like_flax(self.cpu(), generator)
        self.to(dev)

    def forward(self, obs, z):
        x = torch.cat([obs, z], dim=-1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return torch.tanh(self.Dense_2(x))

    @torch.no_grad()
    def perturb(self, generator: torch.Generator, obs, actions):
        """actions + scale · net(obs, z), z ~ N(0, 1) [..., 8] from
        `generator` (on the device of `obs`), clipped to [-1, 1]."""
        z = torch.randn(obs.shape[:-1] + (NOISE_DIM,), generator=generator, device=obs.device)
        return torch.clamp(actions + self.scale * self(obs, z), -1.0, 1.0)

    def load_jax_params(self, tree):
        """Weights from the flax variables of the reference's `_RNANet`."""
        return zoo.load_jax_params(self, tree)

    def to_jax_params(self) -> dict:
        """The weights as the flax variables tree `{"params": {...}}`."""
        return zoo.to_jax_params(self)
