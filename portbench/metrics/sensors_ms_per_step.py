"""Host ms per rollout control step in the sensor step (the program's
`sensors` span: the render selection, both renderers, the point cloud and
the queues) over the window: Σ `time/sensors_s` of its epochs ÷ their
control steps."""

from ..program import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "sensors")
