"""The reference's side of each algorithm, one module per `algo` of a
configuration (`kinds/<algo>.py`), found by that name. Each gives

  - `roll(cap, cfg, mix, env, dev, steps)`: the followed control steps from
    the program's recorded states → {"post": {t: env state after step t},
    "policy": {t: outputs}, ...} plus what its `update` reads;
  - `update(cap, cfg, mix, dev, roll, n)`: the first `n` Adam steps' inputs
    → {"params", "loss_of", "lr", "grad_norm", "minibatches"};
  - `policy_outputs(cap, t)`: the program's recorded policy outputs of step
    `t`, under the names `roll` gives its own;
  - `tiny(cfg, horizon, mini_epochs)`: the configuration cut in place to a
    size the CPU tests run in seconds.
"""

from __future__ import annotations

import importlib


def of(cfg: dict):
    """The module of a configuration's algorithm."""
    return importlib.import_module(f"{__name__}.{cfg['algo']}")
