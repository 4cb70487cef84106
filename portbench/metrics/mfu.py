"""The whole step's share of the H100's dense float32 peak: the networks'
matmul FLOPs of the window's epochs (`work.models`: rollout forwards, the
update's forwards and backwards) over the window's seconds × 67 TFLOP/s."""

from ..work import PEAK_F32_FLOPS


def read(ctx):
    if not ctx.epochs or ctx.window_s <= 0:
        return None
    return ctx.system.flops * len(ctx.epochs) / (ctx.window_s * PEAK_F32_FLOPS) * 100.0
