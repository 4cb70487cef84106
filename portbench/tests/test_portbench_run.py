"""A whole run on the CPU at a tiny size: the result line's keys, with and
without the traced slice, and the refusal without a card."""

import json

import pytest
import torch

import tiny
from portbench import run


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    bench, cell, cfg, mix = tiny.cell("teacher_ppo.state_4096")
    result, checks = run.run(bench, cell, cfg, mix, tiny.SEED, 0.1, traced, tiny.CPU)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) <= {m["name"] for m in run.cell_metrics(bench, cell["name"])}
        assert "rollout_ms_per_step.mem" in result["metrics"] and "mfu.mem" in result["metrics"]
    else:
        # the CPU holds no device memory, so its reader finds nothing to read
        end_to_end = {m["name"] for m in run.cell_metrics(bench, cell["name"], "end_to_end")}
        assert end_to_end == {"device_mem_peak_gb", "setup_s"}
        assert set(result["metrics"]) == end_to_end - {"device_mem_peak_gb"}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(checks) == list(run.limits(cfg, mix))
    json.dumps(result, allow_nan=False)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "teacher_ppo.state_4096", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    assert "isaacgyminsertion_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "isaacgyminsertion_tpu", types.ModuleType("isaacgyminsertion_tpu"))
    assert run.forbidden_modules() == ["isaacgyminsertion_tpu"]


def test_end_to_end_readers():
    """The end-to-end readers read the window's rate, the set-up and the
    window's device-memory peak, and find nothing where there is none."""
    import types

    system = types.SimpleNamespace(agent_steps=1000)
    ctx = types.SimpleNamespace(system=system, epochs=[{}, {}, {}], window_s=2.0, peak_bytes=3_000_000_000,
                                setup_s=41.5)
    assert run.metric_module("env_steps_per_s").read(ctx) == 1500.0
    assert run.metric_module("env_steps_per_s.mem").read(ctx) == 1500.0
    assert run.metric_module("setup_s").read(ctx) == 41.5
    assert run.metric_module("device_mem_peak_gb").read(ctx) == 3.0
    ctx.peak_bytes, ctx.epochs = 0, []
    assert run.metric_module("device_mem_peak_gb").read(ctx) is None
    assert run.metric_module("env_steps_per_s").read(ctx) is None
