"""The share of rendered rows whose fresh frame a consumer takes, over the
traced slice's profiled control steps: Σ `sensors.rows_consumed` ÷ Σ
`sensors.rows_rendered`, the program's counters, in %. `install` switches
the program's device counts on for the slice and clears both counters after
its first, unprofiled step; the consumed rows are reduced once the profiler
has stopped."""

NAMES = ("sensors.rows_rendered", "sensors.rows_consumed")


class _Counters:
    """The two counters, as a record the harness clears after the slice's
    first step."""

    def __init__(self, profiling):
        self.profiling = profiling

    def clear(self):
        for name in NAMES:
            self.profiling.clear_counters(name)


def install(ctx):
    from isaacgyminsertion_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return None
    was = profiling.tracing(True)
    ctx.records["render_useful_share"] = _Counters(profiling)
    ctx.records["render_useful_share"].clear()
    return lambda: profiling.tracing(was)


def read(ctx):
    rec = ctx.records.get("render_useful_share")
    if rec is None:
        return None
    counts = rec.profiling.counters()
    rendered, consumed = (counts.get(name, 0) for name in NAMES)
    return consumed / rendered * 100.0 if rendered else None
