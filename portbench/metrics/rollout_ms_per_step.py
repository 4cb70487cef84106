"""Host ms per rollout control step (policy + env step) over the window:
Σ `time/rollout_s` of its epochs ÷ their control steps."""


def read(ctx):
    steps = len(ctx.epochs) * ctx.system.control_steps
    return sum(m["time/rollout_s"] for m in ctx.epochs) / steps * 1e3 if steps else None
