"""Seconds from the process's start to the window's: imports, the kernels'
`.so` files, build and reset, the benchmark's weights and the first epoch."""


def read(ctx):
    return ctx.setup_s
