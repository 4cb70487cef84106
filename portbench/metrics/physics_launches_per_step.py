"""Kernel launches per rollout control step inside the physics in the
traced slice: the host's `cudaLaunchKernel`-family calls that start inside
one of the program's `physics` ranges ÷ the slice's control steps."""

from ..program import launches_inside


def read(ctx):
    inside = launches_inside(ctx.parts.get("steps"), "physics")
    return inside / ctx.n_steps if inside is not None and ctx.n_steps else None
