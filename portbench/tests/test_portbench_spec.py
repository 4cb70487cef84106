"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name; a new traffic mix is a new file plus a new entry."""

import json
import os
import re
import shutil

import pytest

from portbench import run, systems
from portbench.reference import kinds, nets

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_its_files(w):
    bench, cell, cfg, mix = run.cell_spec(w["name"])
    assert cfg["name"] == w["config"] and mix["envs"] > 0
    assert set(run.limits(cfg, mix)) == {"reset_gap", "env_step_gap", "frame_gap", "policy_gap", "loss_gap", "grad_gap",
                                          "update_gap"}
    wanted = run.cell_metrics(bench, w["name"])
    assert wanted, "every cell reports a per-layer metric"
    end_to_end = {m["name"] for m in run.cell_metrics(bench, w["name"], "end_to_end")}
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    for m in wanted + run.cell_metrics(bench, w["name"], "end_to_end"):
        assert callable(run.metric_module(m["name"]).read)
    for m in wanted:
        assert m["moves"] in end_to_end, "a per-layer metric moves an end-to-end metric its cell reports"
    assert w["chips"] == 1 and len(w["why"]) <= 200
    # the configuration's algorithm and network kinds are found by name
    assert callable(systems.kind(cfg).System) and callable(kinds.of(cfg).roll)
    for block in (v for v in cfg.values() if isinstance(v, dict) and "kind" in v):
        assert callable(nets.kind(block).forward)


def test_names_units_and_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    end_to_end = {m["name"] for m in BENCH["end_to_end"]}
    assert end_to_end == {"env_steps_per_s", "device_mem_peak_gb", "setup_s"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in end_to_end and set(m["workloads"]) <= cells
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")


def test_a_new_mix_is_a_file_and_an_entry(tmp_path):
    """A throwaway traffic mix: added as a file and a workload entry, it
    resolves and runs its metrics' readers without any other edit."""
    shutil.copytree(os.path.join(ROOT, "portbench", "configs"), tmp_path / "portbench" / "configs")
    shutil.copytree(os.path.join(ROOT, "portbench", "traffic"), tmp_path / "portbench" / "traffic")
    mix = {"envs": 64, "env": {}, "task": {"reset_at_fails": True}, "check_steps": 64, "why": "throwaway"}
    (tmp_path / "portbench" / "traffic" / "throwaway_64.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "teacher_ppo.throwaway_64", "config": "teacher_ppo",
                               "traffic": "throwaway_64", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    got_bench, cell, cfg, got_mix = run.cell_spec("teacher_ppo.throwaway_64", root=str(tmp_path))
    assert got_mix == mix and cfg["algo"] == "ppo"
    # metrics without a `workloads` key are reported in every cell, new ones too
    assert run.cell_metrics({"per_layer": [{"name": "mfu"}]}, cell["name"]) == [{"name": "mfu"}]
