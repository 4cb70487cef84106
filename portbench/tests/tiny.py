"""A cell cut to a size the CPU runs in seconds, for the tests."""

import copy

import torch

from portbench import run


def cell(name: str, envs: int = 4, horizon: int = 4, mini_epochs: int = 4):
    bench, spec, cfg, mix = run.cell_spec(name)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    mix["envs"] = envs
    h = cfg.get("ppo") or cfg.get("dagger")
    h["horizon"], h["mini_epochs"] = horizon, mini_epochs
    if "dagger" in cfg:
        h["replay_size"] = 64
    return bench, spec, cfg, mix


CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
