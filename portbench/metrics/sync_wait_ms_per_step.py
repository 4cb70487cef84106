"""Host ms per rollout control step at the env step's one device → host
sync, where the host waits for the device to reach `reset_buf.any()` (the
program's `env.sync` span) over the window: Σ `time/env.sync_s` of its
epochs ÷ their control steps."""

from ..program import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "env.sync")
