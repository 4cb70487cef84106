"""PBT hyperparameter mutation (parity: pbt/mutation.py:33-60+).

Port of `isaacgyminsertion_tpu/pbt/mutation.py`, unchanged: it draws from
Python's global `random`, so one `random.seed` gives both packages the same
mutations.

Multiplicative float mutation within [change_min, change_max] with
probability `mutation_rate` per key; specialized mutators keep eps-clip and
mini-epochs in their valid ranges.
"""

from __future__ import annotations

import random


def mutate_float(x: float, change_min: float = 1.1, change_max: float = 1.5) -> float:
    amount = random.uniform(change_min, change_max)
    return x * amount if random.random() < 0.5 else x / amount


def mutate_eps_clip(x: float, change_min: float = 1.1, change_max: float = 1.5) -> float:
    return min(max(mutate_float(x, change_min, change_max), 0.01), 0.3)


def mutate_mini_epochs(x: int, *_args) -> int:
    new = x + 1 if random.random() < 0.5 else x - 1
    return min(max(new, 1), 16)


SPECIAL = {
    "e_clip": mutate_eps_clip,
    "mini_epochs": mutate_mini_epochs,
}


def mutate(params: dict, mutation_rate: float = 0.15, change_min: float = 1.1,
           change_max: float = 1.5) -> dict:
    """Mutate each numeric key with prob `mutation_rate` (pbt/mutation.py:33-60)."""
    out = dict(params)
    for k, v in params.items():
        if random.random() > mutation_rate:
            continue
        fn = SPECIAL.get(k)
        if fn is not None:
            out[k] = fn(v, change_min, change_max)
        elif isinstance(v, float):
            out[k] = mutate_float(v, change_min, change_max)
        elif isinstance(v, int):
            out[k] = max(int(round(mutate_float(float(v), change_min, change_max))), 1)
    return out
