"""The readers of the program's spans and counters: on synthetic slices and
epochs, on a program without them (nothing to read), and on a tiny traced
CPU run of `teacher_ppo.state_4096`."""

import math
import types

import pytest
import torch

import tiny
from portbench import run
from portbench.trace import LAUNCH_CALLS

SPAN_READERS = {"policy_ms_per_step": "rollout.policy", "physics_ms_per_step": "physics",
                "sensors_ms_per_step": "sensors", "sync_wait_ms_per_step": "env.sync"}


def _ctx(epochs, parts=None, control_steps=4, n_steps=2):
    return types.SimpleNamespace(system=types.SimpleNamespace(control_steps=control_steps), epochs=epochs,
                                 parts=parts or {}, n_steps=n_steps, records={})


@pytest.mark.parametrize("metric, span", sorted(SPAN_READERS.items()))
def test_span_readers_divide_the_epochs_seconds_by_their_steps(metric, span):
    key = f"time/{span}_s"
    ctx = _ctx([{key: 0.010, "time/rollout_s": 0.1}, {key: 0.030, "time/rollout_s": 0.1}])
    for name in (metric, metric + ".mem"):
        assert run.metric_module(name).read(ctx) == pytest.approx(0.040 / 8 * 1e3)
    # a program without the span, or a run without epochs: nothing to read
    assert run.metric_module(metric).read(_ctx([{"time/rollout_s": 0.1}])) is None
    assert run.metric_module(metric).read(_ctx([])) is None


def test_physics_launches_count_the_launches_inside_the_physics_ranges():
    launch = LAUNCH_CALLS[0]
    host = [("physics", 10.0, 20.0), (launch, 11.0, 11.5), ("physics.contacts", 12.0, 14.0),
            (launch, 13.0, 13.2), (launch, 21.0, 21.1), ("physics", 30.0, 40.0), (launch, 40.0, 40.5),
            ("aten::mul", 5.0, 6.0), (launch, 5.5, 5.6)]
    part = {"launches": 5, "host_ops": host, "device_ops": [], "busy_s": 0.0, "wall_s": 1.0}
    read = run.metric_module("physics_launches_per_step").read
    assert read(_ctx([], {"steps": part}, n_steps=2)) == 1.5        # 3 of the 5 launches, over 2 steps
    assert run.metric_module("physics_launches_per_step.mem").read(_ctx([], {"steps": part}, n_steps=2)) == 1.5
    no_range = {**part, "host_ops": [h for h in host if h[0] != "physics"]}
    assert read(_ctx([], {"steps": no_range})) is None               # a program without the span
    assert read(_ctx([], {"steps": {**part, "launches": 0}})) is None  # no device: no launch
    assert read(_ctx([], {})) is None


def test_render_useful_share_counts_only_the_profiled_steps():
    from isaacgyminsertion_tpu_torch.utils import profiling

    reader = run.metric_module("render_useful_share")
    ctx = _ctx([])
    undo = reader.install(ctx)
    try:
        profiling.count("sensors.rows_rendered", 8)                 # the slice's first step ...
        profiling.count("sensors.rows_consumed", torch.ones(8, dtype=torch.bool))
        for rec in ctx.records.values():                             # ... cleared by the harness
            rec.clear()
        for consumed in (torch.tensor([True, False, True, True]), torch.tensor([False, False, True, False])):
            profiling.count("sensors.rows_rendered", 4)
            profiling.count("sensors.rows_consumed", lambda c=consumed: c)
    finally:
        undo()
    profiling.count("sensors.rows_consumed", torch.ones(4, dtype=torch.bool))   # tracing off: not kept
    assert reader.read(ctx) == pytest.approx(4 / 8 * 100.0)
    assert run.metric_module("render_useful_share.mem").read(ctx) == pytest.approx(50.0)
    assert reader.read(_ctx([])) is None                             # not installed: nothing to read


def test_tiny_traced_run_reports_the_span_metrics():
    bench, cell, cfg, mix = tiny.cell("teacher_ppo.state_4096")
    result, _ = run.run(bench, cell, cfg, mix, tiny.SEED, 0.1, True, tiny.CPU)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    parts = [m[f"{q}.mem"] for q in ("policy_ms_per_step", "physics_ms_per_step", "sync_wait_ms_per_step")]
    assert all(math.isfinite(x) and x > 0 for x in parts)
    assert sum(parts) <= m["rollout_ms_per_step.mem"]
    # the CPU launches no kernel: the launch counts have nothing to read
    assert "physics_launches_per_step.mem" not in m and "launches_per_step.mem" not in m


def test_idle_gaps_take_the_innermost_program_span():
    """A gap with no host op over its middle reads `host (no op)`; with the
    program's ranges on the timeline it takes the innermost one."""
    from portbench import trace

    dev = [("k1", 0.0, 1.0), ("k2", 5.0, 6.0), ("k3", 9.0, 10.0)]
    host = [(LAUNCH_CALLS[0], 2.5, 3.5), ("aten::mul", 7.0, 8.0)]
    part = {"device_ops": dev, "host_ops": host}
    assert [g[0] for g in trace.idle_gaps([part])] == ["host (no op)", "aten::mul"]
    spans = [("rollout", -1.0, 11.0), ("physics", 0.5, 11.0), ("physics.contacts", 2.0, 4.0)]
    part = {"device_ops": dev, "host_ops": host + spans}
    assert [g[0] for g in trace.idle_gaps([part])] == ["physics.contacts", "aten::mul"]
