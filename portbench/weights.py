"""Weights made by the benchmark: a fresh network drawn on the card from the
seed in one call, and the banked teacher read from its checkpoint. Both are
handed, as the same tensors, to the program and to the reference."""

from __future__ import annotations

import math
import pickle
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from .reference import nets

# the std of a unit normal truncated at ±2 (flax's lecun_normal rescales by it)
_TRUNC_STD = 0.87962566103423978


class RMS(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def layout(block: dict) -> list:
    """(name, shape, fan_in) of a network block's weights in draw order, from
    its kind (`reference/nets/<kind>.py`); fan_in 0 marks a zero leaf, -1 a
    unit LayerNorm scale, -2 the positional embedding (0.02 std)."""
    return nets.kind(block).shapes(block)


def make(shapes: list, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """Every leaf from one normal draw on `device`, seeded by `seed`:
    kernels lecun-normal clipped at 2 std, biases zero, LayerNorm scales one."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in shapes]
    z = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = OrderedDict(), 0
    for (name, shape, fan_in), size in zip(shapes, sizes):
        part = z[at:at + size].view(shape)
        at += size
        if fan_in > 0:
            out[name] = part * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        elif fan_in == -1:
            out[name] = torch.ones(shape, device=device)
        elif fan_in == -2:
            out[name] = part * 0.02
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


class _Unpickler(pickle.Unpickler):
    """Numpy arrays and the normalizer tuples of a checkpoint; nothing else."""

    def find_class(self, module, name):
        if name == "RMSState" and module.endswith("models.running_mean_std"):
            return RMS
        if module.startswith("numpy") and (name in ("ndarray", "dtype", "_reconstruct", "scalar")
                                           or name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to an unexpected global {module}.{name}")


def load_teacher(path: str, device):
    """The banked actor-critic → (state dict in the port's layout, obs RMS, priv RMS)."""
    with open(path, "rb") as f:
        tree = _Unpickler(f).load()
    p = tree["params"].get("params", tree["params"])
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    sd = OrderedDict()
    for mlp in ("priv_mlp", "actor_mlp", "critic_mlp"):
        for i, key in enumerate(sorted(p[mlp], key=lambda k: int(k.split("_")[1]))):
            sd[f"{mlp}.layers.{i}.weight"] = t(p[mlp][key]["kernel"]).T.contiguous()
            sd[f"{mlp}.layers.{i}.bias"] = t(p[mlp][key]["bias"])
    for head in ("mu", "value"):
        sd[f"{head}.weight"] = t(p[head]["kernel"]).T.contiguous()
        sd[f"{head}.bias"] = t(p[head]["bias"])
    sd["log_std"] = t(p["log_std"])
    rms = lambda r: RMS(*[t(x) for x in r])
    return sd, rms(tree["obs_rms"]), rms(tree["priv_rms"])
