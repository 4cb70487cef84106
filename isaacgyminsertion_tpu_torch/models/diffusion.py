"""Conditional diffusion policy over action chunks (PyTorch).

Port of `isaacgyminsertion_tpu/models/diffusion.py`: a 1-D UNet noise
predictor ε_θ(x_t, t, obs) over action sequences [B, T, A], FiLM-conditioned
on the diffusion step and the observation, trained by ε-prediction (DDPM)
with EMA weights and sampled by DDIM. Submodules carry the reference's flax
names, so `unet_from_jax_params` / `models.zoo.to_jax_params` carry weights
across. The random draws (the training step indices and noise, the sampler's
x_T) are arguments, or come from an explicit `torch.Generator`.
"""

from __future__ import annotations

import copy
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .student import NORM_EPS, SameConv1d
from .zoo import init_like_flax, load_jax_params


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] step indices → [B, dim] (cos ⊕ sin) sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class FiLMResBlock1D(nn.Module):
    """Two 3-wide convs with GroupNorm, the second half scaled and shifted by
    the condition; [B, C, T] in and out (channels-first inside the UNet)."""

    def __init__(self, in_ch: int, channels: int, cond_dim: int):
        super().__init__()
        groups = min(8, channels)
        self.Conv_0 = SameConv1d(in_ch, channels, 3)
        self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=NORM_EPS)
        self.Dense_0 = nn.Linear(cond_dim, 2 * channels)
        self.Conv_1 = SameConv1d(channels, channels, 3)
        self.GroupNorm_1 = nn.GroupNorm(groups, channels, eps=NORM_EPS)
        if in_ch != channels:
            self.Conv_2 = SameConv1d(in_ch, channels, 1)

    def forward(self, x, cond):
        h = self.GroupNorm_0(self.Conv_0(x))
        scale, shift = self.Dense_0(F.silu(cond))[:, :, None].chunk(2, dim=1)
        h = F.silu(h * (1.0 + scale) + shift)
        h = self.GroupNorm_1(self.Conv_1(h))
        res = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return F.silu(h) + res


class UNet1D(nn.Module):
    """Down/up 1-D UNet: (x [B, T, A], t [B], obs_cond [B, obs_dim]) → ε [B, T, A].
    The step embedding runs `Dense_1` then `Dense_0` (the reference builds
    the outer Dense first)."""

    def __init__(self, act_dim: int = 6, obs_dim: int = 15, base_channels: int = 64,
                 channel_mults: Sequence[int] = (1, 2), cond_dim: int = 128):
        super().__init__()
        self.cond_dim = cond_dim
        self.n_levels = len(channel_mults)
        self.Dense_0 = nn.Linear(cond_dim, cond_dim)
        self.Dense_1 = nn.Linear(cond_dim, cond_dim)
        self.Dense_2 = nn.Linear(obs_dim, cond_dim)
        self.Conv_0 = SameConv1d(act_dim, base_channels, 3)
        blocks, prev, skips = [], base_channels, []
        for mult in channel_mults:
            blocks.append((prev, base_channels * mult))
            prev = base_channels * mult
            skips.append(prev)
        blocks.append((prev, base_channels * channel_mults[-1]))
        prev = base_channels * channel_mults[-1]
        for mult in reversed(channel_mults):
            blocks.append((prev + skips.pop(), base_channels * mult))
            prev = base_channels * mult
        for i, (a, b) in enumerate(blocks):
            setattr(self, f"FiLMResBlock1D_{i}", FiLMResBlock1D(a, b, cond_dim))
        self.Conv_1 = SameConv1d(prev, act_dim, 3)

    def forward(self, x, t, obs_cond):
        temb = self.Dense_0(F.silu(self.Dense_1(timestep_embedding(t, self.cond_dim))))
        cond = temb + self.Dense_2(obs_cond)
        block = lambda i: getattr(self, f"FiLMResBlock1D_{i}")
        h = self.Conv_0(x.transpose(1, 2))
        hs = []
        for i in range(self.n_levels):
            h = block(i)(h, cond)
            hs.append(h)
            h = F.avg_pool1d(h, 2, 2)
        h = block(self.n_levels)(h, cond)
        for i in range(self.n_levels):
            h = torch.cat([h.repeat_interleave(2, dim=-1), hs.pop()], dim=1)   # nearest 2x
            h = block(self.n_levels + 1 + i)(h, cond)
        return self.Conv_1(h).transpose(1, 2)


def make_beta_schedule(num_steps: int = 100, beta_start: float = 1e-4, beta_end: float = 0.02,
                       device=None):
    """(betas, alphas, alpha_bar), float32 with a float32 running product."""
    betas = torch.linspace(beta_start, beta_end, num_steps, dtype=torch.float32, device=device)
    alphas = 1.0 - betas
    return betas, alphas, torch.cumprod(alphas, dim=0)


def ddim_steps(num_steps: int, num_inference_steps: int) -> list[int]:
    """The sampler's step indices: a float32 linspace from num_steps − 1 to 0,
    truncated (100 steps, 8 samples: [99, 84, 70, 56, 42, 28, 14, 0])."""
    return np.linspace(num_steps - 1, 0, num_inference_steps, dtype=np.float32).astype(np.int32).tolist()


class DiffusionPolicy:
    """DDPM training and DDIM sampling around a `UNet1D`, with EMA weights."""

    def __init__(self, act_dim: int = 6, chunk: int = 8, obs_dim: int = 15,
                 num_diffusion_steps: int = 100, ema_decay: float = 0.995, device=None):
        self.act_dim, self.chunk, self.obs_dim = act_dim, chunk, obs_dim
        self.num_steps = num_diffusion_steps
        self.ema_decay = ema_decay
        self.betas, self.alphas, self.alpha_bar = make_beta_schedule(num_diffusion_steps, device=device)

    def init(self, generator: torch.Generator, device=None) -> UNet1D:
        """A fresh noise predictor with flax's default initializers."""
        net = init_like_flax(UNet1D(act_dim=self.act_dim, obs_dim=self.obs_dim), generator)
        return net.to(device)

    def loss(self, net: UNet1D, actions, obs_cond, t=None, eps=None,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """ε-prediction MSE at the diffusion steps `t` [B] with noise `eps`
        (drawn uniformly and standard-normal from `generator` where not given)."""
        b = actions.shape[0]
        if t is None:
            t = torch.randint(0, self.num_steps, (b,), generator=generator, device=actions.device)
        if eps is None:
            eps = torch.randn(actions.shape, generator=generator, device=actions.device)
        ab = self.alpha_bar[t][:, None, None]
        x_t = torch.sqrt(ab) * actions + torch.sqrt(1.0 - ab) * eps
        return torch.mean(torch.square(net(x_t, t, obs_cond) - eps))

    @torch.no_grad()
    def ema_update(self, ema: UNet1D, net: UNet1D):
        """ema ← decay · ema + (1 − decay) · net, in place."""
        for e, p in zip(ema.parameters(), net.parameters()):
            e.copy_(self.ema_decay * e + (1.0 - self.ema_decay) * p)

    def ema_copy(self, net: UNet1D) -> UNet1D:
        return copy.deepcopy(net).requires_grad_(False)

    @torch.no_grad()
    def sample_ddim(self, net: UNet1D, obs_cond, num_inference_steps: int = 8, x=None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """Deterministic DDIM from x_T (`x`, or standard normal from
        `generator`) → action chunks [B, chunk, act_dim]; x₀ is clipped to
        [-1, 1] at every step and the last step lands on ᾱ = 1."""
        b = obs_cond.shape[0]
        if x is None:
            x = torch.randn((b, self.chunk, self.act_dim), generator=generator, device=obs_cond.device)
        steps = ddim_steps(self.num_steps, num_inference_steps)
        for i, t in enumerate(steps):
            ab_t = self.alpha_bar[t]
            ab_prev = self.alpha_bar[steps[i + 1]] if i + 1 < len(steps) else torch.ones_like(ab_t)
            eps = net(x, torch.full((b,), t, dtype=torch.long, device=x.device), obs_cond)
            x0 = torch.clamp((x - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t), -1.0, 1.0)
            x = torch.sqrt(ab_prev) * x0 + torch.sqrt(1.0 - ab_prev) * eps
        return x


def unet_from_jax_params(tree, act_dim: int = 6, obs_dim: int = 15, device=None) -> UNet1D:
    """A `UNet1D` (the reference's default widths) loaded from a flax tree."""
    return load_jax_params(UNet1D(act_dim=act_dim, obs_dim=obs_dim), tree).to(device)
