"""Matmul FLOPs of the networks, counted from their published widths.

A network kind (`reference/nets/<kind>.py`) lists its matmuls per sample:
`(macs, grad_a, grad_w)` where `macs` is the multiply-adds of one sample,
`grad_a` says whether the left operand needs a gradient (it does not for a
first layer fed with data) and `grad_w` whether the right operand (the
weights) does (not in a frozen network). A forward pass costs 2 · macs; its
backward costs 2 · macs for each gradient it needs. The rollout's passes are
forward only.
"""

from __future__ import annotations

from ..reference import nets


def ops(block: dict, cfg: dict) -> list:
    """The matmuls of one sample of a network block of the configuration `cfg`."""
    return nets.kind(block).ops(block, cfg)


def forward_flops(ops: list) -> int:
    return sum(2 * macs for macs, _, _ in ops)


def train_flops(ops: list) -> int:
    """Forward and backward of one sample."""
    return sum(2 * macs + (2 * macs if grad_w else 0) + (2 * macs if grad_a else 0) for macs, grad_a, grad_w in ops)
