"""The card's memory that training holds at its peak: device memory
allocated during the window (`max_memory_allocated` after a reset at its
start, read by the benchmark, not the program), in GB. With the env count
it decides how many envs, or runs, one card holds."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
