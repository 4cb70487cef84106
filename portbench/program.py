"""What the per-layer readers take from the program's own recorder
(`isaacgyminsertion_tpu_torch.utils.profiling`): its spans' host seconds,
which each epoch's metrics carry as `time/<span>_s`, and its spans on the
traced slice's timeline, where a recording profiler sees them as host
ranges. A program without a span reads as nothing to read (None)."""

import bisect

from . import trace


def span_ms_per_step(ctx, name: str):
    """Host ms per rollout control step in the span `name` over the window:
    Σ `time/<name>_s` of its epochs ÷ their control steps."""
    key = f"time/{name}_s"
    steps = len(ctx.epochs) * ctx.system.control_steps
    if not steps or any(key not in m for m in ctx.epochs):
        return None
    return sum(m[key] for m in ctx.epochs) / steps * 1e3


def launches_inside(part, name: str):
    """The `cudaLaunchKernel`-family host calls of a traced part that start
    inside a host range named `name`, or None where the part has no such
    range or no launch at all."""
    if not part or not part["launches"]:
        return None
    ranges = sorted((a, b) for n, a, b in part["host_ops"] if n == name)
    if not ranges:
        return None
    starts = [a for a, _ in ranges]
    inside = 0
    for n, a, _ in part["host_ops"]:
        if n in trace.LAUNCH_CALLS:
            i = bisect.bisect_right(starts, a) - 1
            inside += i >= 0 and a <= ranges[i][1]
    return inside
