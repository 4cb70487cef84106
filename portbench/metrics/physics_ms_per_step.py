"""Host ms per rollout control step in the physics (the program's `physics`
span: `engine.step`, its substeps' dynamics, contact generation and solve)
over the window: Σ `time/physics_s` of its epochs ÷ their control steps."""

from ..program import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "physics")
