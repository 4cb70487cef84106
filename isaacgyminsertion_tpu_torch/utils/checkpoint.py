"""Checkpoints: the reference package's layout, read without importing it.

A checkpoint is a pickle of numpy arrays, dicts and `RMSState` namedtuples:
flax-layout `params` (kernels [in, out]), `obs_rms`, `priv_rms`, `value_rms`,
`epoch` and `agent_steps`. The unpickler maps the reference's `RMSState` (and
admits the port's own) onto the port's class and admits numpy's
array-reconstruction globals; any other global is refused. `Checkpointer`
writes such files: `last` with `last_step.json`, and the best-reward and
best-success snapshots that replace the previous best.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any

import numpy as np
import torch

from ..models.running_mean_std import RMSState

_RMS_MODULES = ("isaacgyminsertion_tpu.models.running_mean_std", RMSState.__module__)
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _RMS_MODULES and name == "RMSState":
            return RMSState
        if (module, name) in _NUMPY_GLOBALS or (module.startswith("numpy") and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to an unexpected global {module}.{name}")


def restore_path(path: str):
    """Restore a checkpoint from a path (with or without the .ckpt suffix)."""
    if not path.endswith(".ckpt"):
        path = path + ".ckpt"
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def tree_map(fn, tree: Any) -> Any:
    """`fn` applied to every tensor of a tree of dicts, lists, tuples and
    namedtuples; any other leaf stays as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _to_host(tree: Any) -> Any:
    """Tensors → numpy arrays, through dicts, lists and namedtuples."""
    return tree_map(lambda t: np.asarray(t.detach().cpu()), tree)


class Checkpointer:
    def __init__(self, out_dir: str):
        self.out_dir = os.path.abspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.best_reward = float("-inf")
        self.best_success = float("-inf")

    def save(self, name: str, tree: Any):
        path = os.path.join(self.out_dir, name + ".ckpt")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(_to_host(tree), f)
        os.replace(path + ".tmp", path)  # atomic: a reader never sees a partial file

    def save_last(self, tree: Any, step: int):
        self.save("last", tree)
        with open(os.path.join(self.out_dir, "last_step.json"), "w") as f:
            json.dump({"step": int(step)}, f)

    def maybe_save_best(self, tree: Any, reward: float, success: float) -> list:
        """Best-reward / best-success rotation → the names written."""
        saved = []
        if reward > self.best_reward:
            self.best_reward = reward
            self.save("best_reward", tree)
            saved.append("best_reward")
        if success > self.best_success:
            self.best_success = success
            self.save("best_success", tree)
            saved.append("best_success")
        return saved

    def dump_config(self, cfg: Any, name: str = "config.json"):
        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return str(o)

        with open(os.path.join(self.out_dir, name), "w") as f:
            json.dump(cfg, f, default=enc, indent=2)
