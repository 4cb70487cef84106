"""The port's bench, `make` and `entry` against the JAX package's.

The orchestrator: the root `bench.py` and the port's `bench` run `main` with
the same stub in place of `run_worker` and the same fake clock, and print the
same lines key by key (apart from the elapsed seconds and the card's name) in
three scenarios. One real worker runs the point-cloud epoch at 4 envs on the
CPU. `make` builds what `vec_env.make` builds; `entry`'s forward matches the
JAX `entry()` on the same parameters at 1e-5."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import isaacgyminsertion_tpu
import isaacgyminsertion_tpu_torch
from isaacgyminsertion_tpu_torch import bench
from isaacgyminsertion_tpu_torch.entry import entry
from isaacgyminsertion_tpu_torch.envs import vec_env
from isaacgyminsertion_tpu_torch.models.actor_critic import actor_critic_from_jax_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT_PARTIAL = bench.PARTIAL_PATH     # before any test points it elsewhere


def _root_module(name):
    """A root-level script of the repo, imported by path."""
    spec = importlib.util.spec_from_file_location(f"{name}_reference", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# worker → (seconds it takes on the fake clock, its rate, or None where it fails)
SCENARIOS = {
    "all phases land": {("sensors", 8192): (300, 21000.0), ("pcl", 8192): (320, 19000.0),
                        ("state", 1024): (200, 6000.0)},
    "sensors@8192 fails and 4096 lands": {("sensors", 8192): (120, None), ("sensors", 4096): (250, 15000.0),
                                          ("pcl", 4096): (260, 14000.0), ("state", 1024): (200, 6000.0)},
    "the budget runs out before state": {("sensors", 8192): (500, 21000.0), ("pcl", 8192): (300, 19000.0),
                                         ("state", 1024): (200, 6000.0)},
}


def _run_main(module, monkeypatch, tmp_path, capsys, scenario):
    """module.main() with the stub worker and a fake clock → (its JSON lines,
    the stub's calls, the partial file's line)."""
    clock, calls = [0.0], []

    def run_worker(mode, n, horizon, timeout):
        calls.append((mode, n, horizon, timeout))
        secs, rate = scenario[(mode, n)]
        clock[0] += secs
        if rate is None:
            return None, f"{mode}@{n}: rc=1: torch.OutOfMemoryError: CUDA out of memory."
        return {"rate": rate, "mfu": rate * 1e-8, "device_kind": f"{module.__name__} card"}, None

    partial = tmp_path / f"{module.__name__}_partial.json"
    monkeypatch.setattr(module, "run_worker", run_worker)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    monkeypatch.setattr(module, "PARTIAL_PATH", str(partial))
    monkeypatch.setattr(module, "TOTAL_BUDGET_S", 1000)
    monkeypatch.setattr(module, "WORKER_TIMEOUT_S", 600)
    capsys.readouterr()
    module.main()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return lines, calls, json.loads(partial.read_text())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_orchestrator_prints_the_jax_bench_lines(name, monkeypatch, tmp_path, capsys):
    scenario = SCENARIOS[name]
    ref_lines, ref_calls, ref_partial = _run_main(_root_module("bench"), monkeypatch, tmp_path, capsys, scenario)
    lines, calls, partial = _run_main(bench, monkeypatch, tmp_path, capsys, scenario)
    strip = lambda d: {k: v for k, v in d.items() if k not in ("elapsed_s", "device_kind")}
    assert calls == ref_calls
    assert len(lines) == len(ref_lines) == 3
    for line, ref in zip(lines, ref_lines):
        assert list(line) == list(ref)
        assert strip(line) == strip(ref)
    assert strip(partial) == strip(ref_partial) == strip(ref_lines[-1])
    last = lines[-1]
    assert "partial" not in last and all("partial" in x for x in lines[:2])
    if name == "sensors@8192 fails and 4096 lands":
        assert last["metric"] == "ppo_env_steps_per_sec_sensors_on_4096" and "out of memory" in last["error"]
    if name == "the budget runs out before state":
        assert last["state_only_1024"] is None and "state@1024: skipped (total budget" in last["error"]
    assert os.path.basename(PORT_PARTIAL) == "BENCH_torch_partial.json"
    assert os.path.samefile(os.path.dirname(PORT_PARTIAL), ROOT)
    assert "BENCH_torch_partial.json" in open(os.path.join(ROOT, ".gitignore")).read().split()


def test_pcl_worker_prints_its_line_on_the_cpu(monkeypatch):
    """The point-cloud epoch at 4 envs, horizon 2 (8 rows: the minibatch of
    B // mini_epochs needs at least 8), in the subprocess run_worker spawns."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res, err = bench.run_worker("pcl", 4, 2, 300, device="cpu")
    assert err is None, err
    assert {"rate", "mfu", "device_kind", "peak_memory_gb", "flops", "flops_counted", "launches",
            "steps_with_rows"} <= set(res)
    assert np.isfinite(res["rate"]) and res["rate"] > 0 and res["flops"] > 0
    assert res["device_kind"] == "cpu" and res["mfu"] is None and res["peak_memory_gb"] is None
    assert "hand-written kernels" in res["flops_counted"]
    # on the CPU the wrappers take their plain versions, which count no launch
    assert res["launches"] == {"contact_solver": 0, "contact_gen": 0, "tactile_render": 0, "camera_render": 0}
    assert 0 < res["steps_with_rows"]["tactile_render"] <= 3 * 2
    assert np.isfinite(res["loss"]) and np.isfinite(res["kl"])


def test_peak_flops_by_card_name():
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert bench.peak_flops("NVIDIA H100 PCIe") == 51e12
    assert bench.peak_flops("Some Other Card") is None
    with pytest.raises(ValueError, match="unknown mode"):
        bench.task_config("sensor")
    env = bench.task_config("pcl").env
    assert env.tactile and env.depth_cam and env.seg_cam and env.pcl_cam and env.render_capacity == 0.75
    assert not bench.task_config("sensors").env.pcl_cam and not bench.task_config("state").env.tactile


def test_make_builds_what_vec_env_make_builds():
    assert isaacgyminsertion_tpu_torch.__version__ == isaacgyminsertion_tpu.__version__ == "0.1.0"
    env = isaacgyminsertion_tpu_torch.make("FactoryTaskInsertionTactile", num_envs=2, device="cpu")
    ref = vec_env.make("FactoryTaskInsertionTactile", num_envs=2, device="cpu")
    assert type(env) is type(ref) is vec_env.InsertionVecEnv
    assert env.device == torch.device("cpu") and env.num_envs == 2
    obs, ref_obs = env.reset(), ref.reset()
    assert obs.keys() == ref_obs.keys()
    for k in obs:
        assert torch.equal(obs[k], ref_obs[k]), k
    with pytest.raises(KeyError):
        isaacgyminsertion_tpu_torch.make("NoSuchTask")


def test_entry_matches_the_jax_entry():
    ref_fn, (params, ref_obs, ref_priv) = _root_module("__graft_entry__").entry()
    fn, (net, obs, priv) = entry("cpu")
    assert tuple(obs.shape) == tuple(ref_obs.shape) == (128, obs.shape[1])
    assert tuple(priv.shape) == tuple(ref_priv.shape) and not obs.any() and not priv.any()
    carried = actor_critic_from_jax_params(params, "cpu")
    assert {k: v.shape for k, v in net.state_dict().items()} == {k: v.shape for k, v in carried.state_dict().items()}
    # flax's default init: zero biases and log-std, lecun-normal kernels
    for k, v in net.state_dict().items():
        if k.endswith(".bias") or k == "log_std":
            assert not v.any(), k
        else:
            assert abs(float(v.std()) * np.sqrt(v.shape[1]) - 1.0) < 0.15, k
    rng = np.random.default_rng(0)
    rows = [(ref_obs, ref_priv), (rng.standard_normal(ref_obs.shape, np.float32),
                                  rng.standard_normal(ref_priv.shape, np.float32))]
    for o, p in rows:
        mu_ref, value_ref = (np.asarray(x) for x in ref_fn(params, o, p))
        with torch.no_grad():
            mu, value = fn(carried, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(p)))
        np.testing.assert_allclose(mu.numpy(), mu_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(value.numpy().reshape(value_ref.shape), value_ref, rtol=0, atol=1e-5)
    # on its own zero rows the outputs are the zero biases, as the JAX entry's are
    mu, value = fn(net, obs, priv)
    assert not mu.any() and not value.any()
