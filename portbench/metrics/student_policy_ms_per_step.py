"""Host ms per rollout control step in DAgger's student forward (the
program's `rollout.policy.student` span: the student's inputs, its encoders,
decoder and head, and the latent through the frozen teacher's actor) over
the window: Σ `time/rollout.policy.student_s` of its epochs ÷ their control
steps."""

from ..program import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "rollout.policy.student")
