"""Host ms per rollout control step in the policy's forwards (the program's
`rollout.policy` span: PPO's normalize, actor-critic, sampling and value;
DAgger's teacher and student) over the window: Σ `time/rollout.policy_s`
of its epochs ÷ their control steps."""

from ..program import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "rollout.policy")
