"""Agent steps of the window's whole epochs over the window's wall time,
from a synchronize before the first epoch to one after the last."""


def read(ctx):
    return ctx.system.agent_steps * len(ctx.epochs) / ctx.window_s if ctx.epochs and ctx.window_s > 0 else None
