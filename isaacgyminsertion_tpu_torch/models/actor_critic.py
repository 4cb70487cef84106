"""Asymmetric actor-critic with a privileged-info encoder (PyTorch).

Port of `ActorCriticSplit` in `isaacgyminsertion_tpu/models/actor_critic.py`:
priv-MLP 64→[256,128,8] latent, actor/critic MLPs [512,256,128] over
obs ⊕ latent (ELU throughout), a linear mu head, a linear value head and a
state-independent learned log-std; with `use_contact_ae` an extrinsic-contact
autoencoder (`ContactAE`, 400 → 8 → 400) adds its code to the latent and its
reconstruction to the extras. `convert_jax_params` turns the reference's
flax parameter tree into this module's state dict and `to_jax_params` turns it
back; `init_like_flax` draws a fresh network with flax's default initializers.
The Gaussian policy helpers (`sample_actions`, `gaussian_neglogp`,
`policy_kl`) are those of the reference's PPO.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    def __init__(self, in_dim: int, units: Sequence[int], activate_last: bool = True):
        super().__init__()
        dims = [in_dim, *units]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activate_last = activate_last

    def forward(self, x):
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.activate_last or i < last:
                x = F.elu(x)
        return x


class ContactAE(nn.Module):
    """Extrinsic-contact autoencoder: contacts [B, contact_dim] → (code
    [B, latent_dim], sigmoid reconstruction [B, contact_dim])."""

    def __init__(self, latent_dim: int = 8, contact_dim: int = 400):
        super().__init__()
        self.enc = MLP(contact_dim, (128, 64, latent_dim), activate_last=False)
        self.dec_h = MLP(latent_dim, (64, 128))
        self.dec_out = nn.Linear(128, contact_dim)

    def encode(self, contacts):
        return self.enc(contacts)

    def decode(self, z):
        return torch.sigmoid(self.dec_out(self.dec_h(z)))

    def forward(self, contacts):
        z = self.encode(contacts)
        return z, self.decode(z)


class ActorCriticSplit(nn.Module):
    def __init__(self, num_actions: int = 6, obs_dim: int = 15, priv_dim: int = 64,
                 priv_units: Sequence[int] = (256, 128, 8), units: Sequence[int] = (512, 256, 128),
                 use_contact_ae: bool = False, contact_dim: int = 400):
        super().__init__()
        self.use_contact_ae = use_contact_ae
        in_dim = obs_dim + priv_units[-1] + (8 if use_contact_ae else 0)
        self.priv_mlp = MLP(priv_dim, priv_units)
        self.actor_mlp = MLP(in_dim, units)
        self.critic_mlp = MLP(in_dim, units)
        self.mu = nn.Linear(units[-1], num_actions)
        self.value = nn.Linear(units[-1], 1)
        self.log_std = nn.Parameter(torch.zeros(num_actions))
        if use_contact_ae:
            self.contact_ae = ContactAE(contact_dim=contact_dim)

    def forward(self, obs, priv_info, latent=None, contacts=None):
        """Returns (mu, log_std, value, latent_gt, extras); `latent` overrides
        the priv encoder output (student latent injection); with the contact
        autoencoder on and `contacts` given, its code joins the latent and
        `extras["contact_recon"]` holds its reconstruction."""
        latent_gt = self.priv_mlp(priv_info)
        z = latent_gt if latent is None else latent
        extras = {}
        if self.use_contact_ae and contacts is not None:
            cz, recon = self.contact_ae(contacts)
            z = torch.cat([z, cz], dim=-1)
            extras["contact_recon"] = recon
        x = torch.cat([obs, z], dim=-1)
        mu = self.mu(self.actor_mlp(x))
        value = self.value(self.critic_mlp(x))[..., 0]
        return mu, self.log_std, value, latent_gt, extras


def convert_jax_params(params) -> "OrderedDict[str, torch.Tensor]":
    """flax `ActorCriticSplit` params → `ActorCriticSplit.state_dict()`.

    A flax Dense `kernel` is [in, out]; a torch Linear `weight` is [out, in].
    Accepts the tree with or without its top-level "params" key; a
    `contact_ae` subtree maps onto the `ContactAE`."""
    p = params.get("params", params)
    t = lambda a: torch.as_tensor(np.array(a, np.float32))
    sd = OrderedDict()
    mlps = [(mlp, p[mlp]) for mlp in ("priv_mlp", "actor_mlp", "critic_mlp")]
    heads = [(head, p[head]) for head in ("mu", "value")]
    if "contact_ae" in p:
        mlps += [(f"contact_ae.{m}", p["contact_ae"][m]) for m in ("enc", "dec_h")]
        heads.append(("contact_ae.dec_out", p["contact_ae"]["dec_out"]))
    for mlp, node in mlps:
        dense = sorted(node, key=lambda k: int(k.split("_")[1]))
        for i, name in enumerate(dense):
            sd[f"{mlp}.layers.{i}.weight"] = t(node[name]["kernel"]).T.contiguous()
            sd[f"{mlp}.layers.{i}.bias"] = t(node[name]["bias"])
    for head, node in heads:
        sd[f"{head}.weight"] = t(node["kernel"]).T.contiguous()
        sd[f"{head}.bias"] = t(node["bias"])
    sd["log_std"] = t(p["log_std"])
    return sd


def to_jax_params(state_dict) -> dict:
    """`ActorCriticSplit.state_dict()` → the flax tree `{"params": {...}}` as
    float32 numpy arrays, kernels [in, out] (the inverse of
    `convert_jax_params`; the layout of the reference's checkpoints)."""
    a = lambda t: np.array(t.detach().cpu(), np.float32)   # a copy, never a view of a parameter
    dense = lambda key: {"kernel": a(state_dict[f"{key}.weight"]).T.copy(),
                         "bias": a(state_dict[f"{key}.bias"])}

    def mlp(key):
        n = sum(1 for k in state_dict if k.startswith(f"{key}.layers.") and k.endswith(".weight"))
        return {f"Dense_{i}": dense(f"{key}.layers.{i}") for i in range(n)}

    p = {m: mlp(m) for m in ("priv_mlp", "actor_mlp", "critic_mlp")}
    p.update({head: dense(head) for head in ("mu", "value")})
    p["log_std"] = a(state_dict["log_std"])
    if "contact_ae.dec_out.weight" in state_dict:
        p["contact_ae"] = {"enc": mlp("contact_ae.enc"), "dec_h": mlp("contact_ae.dec_h"),
                           "dec_out": dense("contact_ae.dec_out")}
    return {"params": p}


# flax's lecun_normal: a normal truncated at ±2 std, rescaled so that the
# truncated draw has variance 1 / fan_in (the std of a unit normal truncated
# at ±2 is 0.87962566103423978)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Linear of `net` as flax's `nn.Dense` defaults do
    (`lecun_normal` kernel, zero bias) and zero `log_std`, so training from
    scratch starts from the reference's statistics (`nn.Linear`'s own
    Kaiming-uniform init is another distribution)."""
    for m in net.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            nn.init.zeros_(m.bias)
    if hasattr(net, "log_std"):
        net.log_std.zero_()
    return net


def gaussian_neglogp(actions, mu, log_std):
    std = torch.exp(log_std)
    return (0.5 * torch.sum(torch.square((actions - mu) / std), dim=-1) + torch.sum(log_std)
            + 0.5 * actions.shape[-1] * math.log(2.0 * math.pi))


def sample_actions(mu, log_std, generator: torch.Generator | None = None, noise=None):
    """mu + exp(log_std) · ε → (actions, neglogp); ε is `noise` when given,
    else a standard normal drawn from `generator`."""
    eps = noise if noise is not None else torch.randn(mu.shape, generator=generator,
                                                      device=mu.device, dtype=mu.dtype)
    actions = mu + torch.exp(log_std) * eps
    return actions, gaussian_neglogp(actions, mu, log_std)


def policy_kl(mu0, sigma0, mu1, sigma1, reduce=torch.mean):
    """Analytic diagonal-Gaussian KL, averaged over the batch (`reduce` over
    the per-row KLs)."""
    c1 = torch.log(sigma1 / sigma0 + 1e-5)
    c2 = (sigma0**2 + (mu1 - mu0) ** 2) / (2.0 * sigma1**2 + 1e-5)
    return reduce(torch.sum(c1 + c2 - 0.5, dim=-1))


def actor_critic_from_jax_params(params, device=None) -> ActorCriticSplit:
    """An eval-mode `ActorCriticSplit` sized and loaded from a flax tree."""
    sd = convert_jax_params(params)
    units = lambda mlp: tuple(v.shape[0] for k, v in sd.items()
                              if k.startswith(f"{mlp}.layers.") and k.endswith(".weight"))
    priv_units = units("priv_mlp")
    use_ae = "contact_ae.dec_out.weight" in sd
    net = ActorCriticSplit(
        num_actions=sd["mu.weight"].shape[0],
        obs_dim=sd["actor_mlp.layers.0.weight"].shape[1] - priv_units[-1] - (8 if use_ae else 0),
        priv_dim=sd["priv_mlp.layers.0.weight"].shape[1],
        priv_units=priv_units,
        units=units("actor_mlp"),
        use_contact_ae=use_ae,
        contact_dim=sd["contact_ae.dec_out.weight"].shape[0] if use_ae else 400,
    )
    net.load_state_dict(sd)
    return net.to(device).eval()
