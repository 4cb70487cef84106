"""The flagship forward step and its example arguments.

Port of `__graft_entry__.entry`: the teacher `ActorCriticSplit` of the
default `TaskConfig`, drawn with flax's default initializers (seed 0), on a
full env batch of 128 zero observation and privileged-info rows.

    fn, args = entry()          # on CUDA; entry("cpu") on the CPU
    mu, value = fn(*args)

The data-parallel dry run, the other half of `__graft_entry__`, is
`parallel/dryrun.py`.
"""

from __future__ import annotations

import torch

from . import resolve_device
from .envs.config import default_task_config
from .models.actor_critic import ActorCriticSplit, init_like_flax

ROWS = 128


def entry(device=None):
    """→ (fn, (net, obs, priv)), where fn(net, obs, priv) → (mu, value)."""
    dev = resolve_device(device)
    cfg = default_task_config()
    obs_dim = cfg.env.num_obs_hist * cfg.env.num_observations
    net = ActorCriticSplit(num_actions=cfg.env.num_actions, obs_dim=obs_dim, priv_dim=cfg.env.num_states)
    net = init_like_flax(net, torch.Generator().manual_seed(0)).to(dev).eval()
    obs = torch.zeros((ROWS, obs_dim), dtype=torch.float32, device=dev)
    priv = torch.zeros((ROWS, cfg.env.num_states), dtype=torch.float32, device=dev)

    def fn(net, obs, priv):
        mu, log_std, value, latent, _ = net(obs, priv)
        return mu, value

    return fn, (net, obs, priv)
