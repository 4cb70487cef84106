"""Kernel launches per rollout control step in the traced slice: the host's
`cudaLaunchKernel`-family calls ÷ the slice's control steps."""


def read(ctx):
    part = ctx.parts.get("steps")
    return part["launches"] / ctx.n_steps if part and part["launches"] and ctx.n_steps else None
