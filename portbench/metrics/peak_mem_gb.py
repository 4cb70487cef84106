"""Peak device memory allocated during the window (`max_memory_allocated`
after a reset at its start), in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
