"""The system under test, one `System` class per kind of configuration,
found by the configuration's `algo` in `kinds/<algo>.py`: the port's training
epoch built through its own entry (`algo.ppo.build`, `algo.ext_adapt.build`),
its weights replaced by the benchmark's, and called as users call it: every
random draw (action noise, permutations, mix coins, reservoir slots and rows)
comes from the program's own generators, which its `build` seeds from
`--seed`.

Each class gives the harness:
  - `epoch()`: one `TrainEpoch.__call__` → its metrics;
  - `capture_epoch()`: the same call, with what the reference needs recorded
    at the epoch's method boundaries (the env state before every followed
    control step, the generators' states before it, the rollout's outputs,
    the draws of the update, the first three Adam steps' losses, the first
    gradient and the parameters after the third) and moved to the host; the
    recording is taken off afterwards;
  - `profile_parts()`: the callables of the traced slice (a few control
    steps, then one update phase);
  - the counts per epoch: agent steps, control steps, Adam steps, and the
    networks' matmul FLOPs (`work.models`);
  - `free()`: drops the program's state.
Its `counts(cfg, mix)` gives those counts from the configuration alone.
This module holds what the kinds share.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from . import tree

N_CHECKED_ADAM_STEPS = 3


def task_config(default, mix: dict):
    """The default `TaskConfig` with the traffic mix's env and task settings."""
    return default.replace(env=dataclasses.replace(default.env, **mix["env"]), **mix["task"])


def settings(cls, *blocks: dict):
    """An instance of the program's config dataclass `cls` with every field
    that the configuration's `blocks` set."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for block in blocks for k, v in block.items() if k in fields})


class Recorder:
    """Instance-attribute wrappers on the program's objects, taken off by `close`."""

    def __init__(self):
        self._undo = []

    def wrap(self, obj, name: str, make):
        original, own = getattr(obj, name), vars(obj).get(name)
        setattr(obj, name, make(original))
        self._undo.append((obj, name, own))

    def close(self):
        for obj, name, own in reversed(self._undo):
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        self._undo = []


def new_capture(weights: dict) -> dict:
    return {"states": {}, "gen": {}, "train_gen": {}, "traj": [], "weights": weights}


def state_recorder(cap: dict, steps: list, env_gen, train_gen):
    """→ record(env_state), called before each control step: keeps the state
    before the first step and before and after each followed one, and the
    env's and the policy's generator states before each followed one (on
    the host)."""
    keep = {0} | set(steps) | {t + 1 for t in steps}
    follow = set(steps)
    t = [0]

    def record(env_state):
        if t[0] in keep:
            cap["states"][t[0]] = tree.to_data(env_state)
        if t[0] in follow:
            cap["gen"][t[0]] = env_gen.get_state()
            cap["train_gen"][t[0]] = train_gen.get_state()
        t[0] += 1

    return record


class Base:
    """What the kinds share: the task, the robot and the subassemblies."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
        from isaacgyminsertion_tpu_torch.envs.config import default_task_config
        from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, int(seed), torch.device(device)
        self.n_envs = int(mix["envs"])
        self.task = task_config(default_task_config(), mix)
        self.model, self.subs = build_kuka_openhand(), build_subassembly_set()
        vars(self).update(self.counts(cfg, mix))

    def epoch(self):
        self.state, metrics = self.te(self.state)
        return metrics

    def _record_adam(self, rec: Recorder, optimizer, params: dict, cap: dict):
        """The first gradient as Adam holds it after one step (m / (1 − β1)) and
        the parameters after the third step, by the parameter's name."""
        names = {id(p): n for n, p in params.items()}
        beta1 = optimizer.param_groups[0]["betas"][0]
        calls = [0]

        def make(step):
            def wrapped(*a, **kw):
                out = step(*a, **kw)
                calls[0] += 1
                if calls[0] == 1:
                    # a step that left no moment behind holds no gradient: NaN
                    cap["grad1"] = {names[id(p)]: (optimizer.state[p]["exp_avg"] / (1.0 - beta1)).cpu()
                                    if "exp_avg" in optimizer.state.get(p, {}) else torch.full_like(p, float("nan")).cpu()
                                    for g in optimizer.param_groups for p in g["params"]}
                if calls[0] == N_CHECKED_ADAM_STEPS:
                    cap["params3"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
                return out
            return wrapped

        rec.wrap(optimizer, "step", make)

    def _record_losses(self, rec: Recorder, te, cap: dict):
        cap["losses"] = []

        def make(loss_fn):
            def wrapped(*a, **kw):
                loss, aux = loss_fn(*a, **kw)
                if len(cap["losses"]) < N_CHECKED_ADAM_STEPS:
                    cap["losses"].append(loss.detach().cpu())
                return loss, aux
            return wrapped

        rec.wrap(te, "loss", make)


def kind(cfg: dict):
    """The module of the configuration's `algo` (`kinds/<algo>.py`)."""
    return importlib.import_module(f"{__package__}.kinds.{cfg['algo']}")


def build(cfg: dict, mix: dict, seed: int, device, root: str):
    return kind(cfg).System(cfg, mix, seed, device, root)
