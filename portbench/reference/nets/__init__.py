"""The networks, one module per kind: the `kind` of a configuration's network
block (`policy`, `teacher`, `student`) names `nets/<kind>.py`, which gives

  - `shapes(block)`: the weight layout `weights.make` draws, (name, shape,
    fan_in) in draw order (the port's names: Linear weights [out, in]);
  - `ops(block, cfg)`: the matmuls of one sample, as `work.models` counts them;
  - `forward(w, block, inputs)`: the plain forward on a dict of weights and a
    dict of normalized inputs, written out from the layer equations;
  - `act(out, block, inject)`: how that output becomes the action the rollout
    takes (`inject(latent)`: the teacher's actor driven by a student latent).

This module holds the parts every kind composes: dense layers and MLPs, their
weight layouts and their matmul counts. A new network kind is a new module
here that composes these and the parts the other kinds expose.
"""

from __future__ import annotations

import importlib


def kind(block: dict):
    """The module of a network block's kind."""
    return importlib.import_module(f"{__name__}.{block['kind']}")


def dense(w: dict, name: str, x):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def mlp(w: dict, prefix: str, x, n: int, act, layer="layers.{i}"):
    for i in range(n):
        x = act(dense(w, f"{prefix}.{layer.format(i=i)}", x))
    return x


def mlp_shapes(prefix: str, in_dim: int, units, layer="layers.{i}") -> list:
    """(name, shape, fan_in) of a dense stack; fan_in 0 marks a zero leaf."""
    dims = [in_dim, *units]
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"{prefix}.{layer.format(i=i)}.weight", (b, a), a), (f"{prefix}.{layer.format(i=i)}.bias", (b,), 0)]
    return out


def mlp_ops(in_dim: int, units, grad_in: bool, rows: int = 1, grad_w: bool = True) -> list:
    """The matmuls of a dense stack over `rows` vectors of one sample, in the
    form `work.models` reads: (macs, input needs a gradient, weights need a
    gradient); the first layer's input needs one only with `grad_in`."""
    dims = [in_dim, *units]
    return [(rows * a * b, grad_in or i > 0, grad_w) for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
