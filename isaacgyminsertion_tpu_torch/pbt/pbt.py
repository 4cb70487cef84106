"""Population-based training — filesystem-exchange PBT (parity: pbt/pbt.py).

Port of `isaacgyminsertion_tpu/pbt/pbt.py`. The decisions are the
reference's, drawn from Python's global `random`, so one seed gives both
packages the same outcomes. A member's `weights` hold numpy trees in the
`Checkpointer` layout (`params` in flax layout, `obs_rms`, `priv_rms`,
`value_rms`). The port reads its own `.pbt` files only: a file the JAX driver
wrote pickles `jax.Array`s (and the reference's `PbtMember`), which cannot be
read without importing jax, so `load_population` skips it as it skips a
corrupt one.

Reproduces the reference's exact replacement algorithm (SURVEY.md §8.1,
pbt/pbt.py:269-490): per interval each policy checkpoints
{true_objective, params, weights} into a shared workspace, loads the
population, and — if it sits in the bottom `replace_fraction_worst`, has
trained long enough, and the gap to a random top policy exceeds both the
std-based and absolute thresholds — copies that policy's weights and mutates
hyperparameters (coin-flip between own and candidate's params before
mutation). Unlike the reference it does NOT exec-restart the process
(pbt.py:123-178): jitted training takes new weights as data, so replacement
is a tree swap — same semantics, no process churn. A process-per-policy
launcher (scripts/run_pbt.py pattern) still works through the same workspace
for multi-host sweeps.
"""

from __future__ import annotations

import glob
import os
import pickle
import random
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..utils.checkpoint import _Unpickler
from .mutation import mutate


@dataclass
class PbtParams:
    """pbt/pbt.py:83-121 parity."""

    policy_idx: int = 0
    num_policies: int = 8
    workspace: str = "pbt_workspace"
    interval_steps: float = 1.0e7
    start_after_steps: float = 1.0e7
    initial_delay_steps: float = 2.0e7
    replace_fraction_best: float = 0.3
    replace_fraction_worst: float = 0.3
    replace_threshold_frac_std: float = 0.5
    replace_threshold_frac_absolute: float = 0.05
    mutation_rate: float = 0.15
    change_min: float = 1.1
    change_max: float = 1.5


@dataclass
class PbtMember:
    policy_idx: int
    iteration: int
    true_objective: float
    hparams: dict
    weights: Any  # {params, obs_rms, priv_rms, value_rms} as numpy


class _PbtUnpickler(_Unpickler):
    """The checkpoint unpickler, admitting the port's `PbtMember` too."""

    def find_class(self, module, name):
        if module == __name__ and name == "PbtMember":
            return PbtMember
        return super().find_class(module, name)


def _load_member(path: str):
    with open(path, "rb") as f:
        return _PbtUnpickler(f).load()


def _ckpt_path(workspace: str, policy_idx: int, iteration: int) -> str:
    return os.path.join(workspace, f"p{policy_idx:03d}_iter{iteration:06d}.pbt")


def save_pbt_checkpoint(p: PbtParams, member: PbtMember):
    """_save_pbt_checkpoint parity (pbt.py:505); atomic write."""
    os.makedirs(p.workspace, exist_ok=True)
    path = _ckpt_path(p.workspace, member.policy_idx, member.iteration)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(member, f)
    os.replace(path + ".tmp", path)


def load_population(p: PbtParams) -> dict[int, PbtMember]:
    """Latest checkpoint per policy; tolerates missing/corrupt files
    (pbt.py:530-562 retry semantics) and skips the JAX package's."""
    latest: dict[int, PbtMember] = {}
    for path in sorted(glob.glob(os.path.join(p.workspace, "p*.pbt"))):
        try:
            m = _load_member(path)
        except Exception:   # corrupt, partial, or written by the JAX package
            continue
        cur = latest.get(m.policy_idx)
        if cur is None or m.iteration > cur.iteration:
            latest[m.policy_idx] = m
    return latest


def _objective_std(objectives: list[float]) -> float:
    """std with the 20% worst outliers removed (pbt.py:396-428)."""
    if len(objectives) < 2:
        return 0.0
    srt = sorted(objectives)
    keep = srt[int(0.2 * len(srt)):]
    return float(np.std(keep)) if len(keep) > 1 else 0.0


def pbt_update(
    p: PbtParams,
    my: PbtMember,
    steps_since_restart: float,
    total_steps: float,
) -> tuple[dict, Any, bool]:
    """One PBT decision for policy `my` (pbt.py:269-490 semantics).

    Returns (new_hparams, new_weights_or_None, replaced).
    """
    save_pbt_checkpoint(p, my)
    pop = load_population(p)
    if len(pop) < max(p.num_policies // 2, 1):  # ≥ half reported (pbt.py:387-389)
        return my.hparams, None, False

    members = sorted(pop.values(), key=lambda m: m.true_objective, reverse=True)
    objectives = [m.true_objective for m in members]
    n = len(members)
    n_best = max(int(p.replace_fraction_best * n), 1)
    n_worst = max(int(p.replace_fraction_worst * n), 1)
    ranks = {m.policy_idx: i for i, m in enumerate(members)}

    # save global best (pbt.py:330-343) — only when it IMPROVES on the saved
    # one (reference _maybe_save_best_policy keeps the all-time best; an
    # unconditional overwrite would track the current population's top even
    # as the whole population declines)
    best = members[0]
    best_path = os.path.join(p.workspace, "best.pbt")
    prev_obj = float("-inf")
    if os.path.exists(best_path):
        try:
            prev_obj = _load_member(best_path).true_objective
        except Exception:
            pass
    if best.true_objective > prev_obj:
        with open(best_path, "wb") as f:
            pickle.dump(best, f)

    my_rank = ranks.get(my.policy_idx, n - 1)
    in_worst = my_rank >= n - n_worst
    trained_enough = (
        steps_since_restart >= p.start_after_steps
        and total_steps >= p.initial_delay_steps
    )  # pbt.py:353-363
    if not (in_worst and trained_enough):
        return my.hparams, None, False
    # current-iteration objective already beats a top policy ⇒ keep training
    if my.true_objective >= members[n_best - 1].true_objective:  # pbt.py:378-385
        return my.hparams, None, False

    candidate = random.choice(members[:n_best])
    delta = candidate.true_objective - my.true_objective
    std_thresh = p.replace_threshold_frac_std * _objective_std(objectives)
    abs_thresh = p.replace_threshold_frac_absolute * abs(candidate.true_objective)
    copy_weights = delta > std_thresh and delta > abs_thresh  # pbt.py:396-428

    base = candidate.hparams if random.random() < 0.5 else my.hparams  # pbt.py:435-438
    new_hparams = mutate(base, p.mutation_rate, p.change_min, p.change_max)
    return new_hparams, (candidate.weights if copy_weights else None), copy_weights
