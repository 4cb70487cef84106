"""`ActorCriticSplit`: a privileged MLP → latent; actor and critic ELU MLPs
over obs ⊕ latent; linear mu and value heads; a state-independent log-std."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from . import dense, mlp, mlp_ops, mlp_shapes


def shapes(p: dict) -> list:
    """fan_in 0 marks a zero-initialized leaf."""
    trunk = p["obs_dim"] + p["priv_units"][-1]
    h = p["units"][-1]
    return (mlp_shapes("priv_mlp", p["priv_dim"], p["priv_units"])
            + mlp_shapes("actor_mlp", trunk, p["units"]) + mlp_shapes("critic_mlp", trunk, p["units"])
            + [("mu.weight", (p["num_actions"], h), h), ("mu.bias", (p["num_actions"],), 0),
               ("value.weight", (1, h), h), ("value.bias", (1,), 0), ("log_std", (p["num_actions"],), 0)])


def ops(p: dict, cfg: dict | None = None) -> list:
    """The priv MLP is fed with data; the actor's and critic's first layers
    need an input gradient through the latent."""
    trunk = p["obs_dim"] + p["priv_units"][-1]
    return (mlp_ops(p["priv_dim"], p["priv_units"], False) + mlp_ops(trunk, p["units"], True)
            + mlp_ops(trunk, p["units"], True)
            + [(p["units"][-1] * p["num_actions"], True, True), (p["units"][-1], True, True)])


def injected_ops(p: dict) -> list:
    """The frozen network driven by an injected latent (`forward` on a
    placeholder priv input, the latent replacing the priv MLP's): every
    matmul runs forward; a backward reaches only the actor and mu, for the
    latent's gradient, and no weight."""
    trunk = p["obs_dim"] + p["priv_units"][-1]
    forward_only = lambda ops: [(macs, False, False) for macs, _, _ in ops]
    return (forward_only(mlp_ops(p["priv_dim"], p["priv_units"], False))
            + mlp_ops(trunk, p["units"], True, grad_w=False)
            + forward_only(mlp_ops(trunk, p["units"], False))
            + [(p["units"][-1] * p["num_actions"], True, False), (p["units"][-1], False, False)])


def latent(w: dict, p: dict, priv):
    return mlp(w, "priv_mlp", priv, len(p["priv_units"]), F.elu)


def actor(w: dict, p: dict, obs, z):
    """mu over obs ⊕ z."""
    return dense(w, "mu", mlp(w, "actor_mlp", torch.cat([obs, z], dim=-1), len(p["units"]), F.elu))


def critic(w: dict, p: dict, obs, z):
    return dense(w, "value", mlp(w, "critic_mlp", torch.cat([obs, z], dim=-1), len(p["units"]), F.elu))[..., 0]


def forward(w: dict, p: dict, inputs: dict):
    """(mu, log_std, value, latent) of normalized `obs` and `priv`."""
    z = latent(w, p, inputs["priv"])
    return actor(w, p, inputs["obs"], z), w["log_std"], critic(w, p, inputs["obs"], z), z


def act(out, p: dict, inject=None):
    """The deterministic action: mu clipped to [-1, 1]."""
    return torch.clamp(out[0], -1.0, 1.0)
