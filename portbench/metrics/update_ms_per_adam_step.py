"""Host ms per Adam step of the update phase over the window (forward,
backward, clip and Adam on one minibatch): Σ `time/update_s` ÷ Adam steps."""


def read(ctx):
    steps = len(ctx.epochs) * ctx.system.adam_steps
    return sum(m["time/update_s"] for m in ctx.epochs) / steps * 1e3 if steps else None
