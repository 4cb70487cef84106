"""Matmul FLOPs of the networks, counted from their published widths.

A network is a list of matmuls per sample: `(macs, grad_a)` where `macs` is
the multiply-adds of one sample and `grad_a` says whether the left operand
needs a gradient (it does not for a first layer fed with data). A forward
pass costs 2 · macs; its backward costs 2 · macs for the gradient of the
weights (or of the right operand) and 2 · macs more where the left operand
needs a gradient. The rollout's passes are forward only.
"""

from __future__ import annotations


def _mlp(in_dim: int, units, grad_in: bool, rows: int = 1):
    dims = [in_dim, *units]
    return [(rows * a * b, grad_in or i > 0) for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def actor_critic(p: dict) -> list:
    """`ActorCriticSplit`: priv MLP → latent; actor and critic MLPs over
    obs ⊕ latent (the concatenation needs a gradient through the latent);
    mu and value heads."""
    latent = p["priv_units"][-1]
    trunk = p["obs_dim"] + latent
    return (_mlp(p["priv_dim"], p["priv_units"], False) + _mlp(trunk, p["units"], True)
            + _mlp(trunk, p["units"], True)
            + [(p["units"][-1] * p["num_actions"], True), (p["units"][-1], True)])


def student(s: dict) -> list:
    """`MultiModalModel` with an obs token and a point-cloud token (one
    PointNet per object, then a compressor): a self-attention decoder over
    the tokens, its MLP head and the output head."""
    e, t = s["embed_dim"], s["num_tokens"]
    ops = []
    if s["use_obs"]:
        ops += _mlp(s["obs_dim"], s["obs_units"] + [e], False)
    if s["use_pcl"]:
        for count in s["pcl_points"]:
            ops += _mlp(3, s["pointnet_units"] + [e], False, rows=count)
        ops.append((len(s["pcl_points"]) * e * e, True))
    for _ in range(s["decoder_layers"]):
        ops += [(t * e * e, True)] * 3             # query, key, value projections
        ops += [(t * t * e, True)] * 2             # scores and the weighted sum
        ops.append((t * e * e, True))              # output projection
        ops += [(t * e * 4 * e, True), (t * 4 * e * e, True)]   # feed-forward
    ops += _mlp(t * e, s["head_units"], True)
    ops.append((s["head_units"][-1] * s["out_dim"], True))
    return ops


def forward_flops(ops: list) -> int:
    return sum(2 * macs for macs, _ in ops)


def train_flops(ops: list) -> int:
    """Forward and backward of one sample."""
    return sum(2 * macs + 2 * macs + (2 * macs if grad_a else 0) for macs, grad_a in ops)
