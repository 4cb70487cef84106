"""The port's PPO trainer on the CPU: what training writes, the checkpoint
round trip (and the teacher eval reading it), the eval-gated anneal ladder,
and the CLI's training branch with `device=cpu`."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu_torch import cli
from isaacgyminsertion_tpu_torch.algo import ppo
from isaacgyminsertion_tpu_torch.algo.trainer import PPOTrainer
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import vec_env
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

N = 4


@pytest.fixture(scope="module")
def world():
    return default_task_config(), build_kuka_openhand(), build_subassembly_set()


def _params(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def test_train_writes_its_files_and_restore_round_trips(world, tmp_path, capsys):
    """2 epochs of 4 steps in episodes of 6 (timeouts, bootstrap and resets
    inside the run) with an eval after the second."""
    cfg, model, subs = world
    cfg = cfg.replace(rl=dataclasses.replace(cfg.rl, max_episode_length=6))
    out = tmp_path / "run"
    tr = PPOTrainer(cfg, ppo.PPOConfig(horizon=4, mini_epochs=2), model, subs, N, str(out), seed=3,
                    eval_freq_steps=32, eval_envs=2, device="cpu")
    start = _params(tr.net)
    tr.train(max_epochs=2)
    assert tr.state.epoch == 2 and tr.state.agent_steps == 2 * 4 * N
    assert {"last.ckpt", "last_step.json", "config.json", "metrics.jsonl"} <= set(os.listdir(out))
    assert json.load(open(out / "last_step.json")) == {"step": 2 * 4 * N}
    assert json.load(open(out / "config.json"))["ppo"]["horizon"] == 4
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    epochs = [r for r in rows if "loss" in r]
    assert [r["step"] for r in epochs] == [16, 32]
    for r in epochs:
        for k in ("loss", "a_loss", "c_loss", "kl", "info/param_norm", "performance/EnvStepFPS",
                  "time/rollout_s", "time/update_s"):
            assert np.isfinite(r[k]), k
        for k in ("rollout.policy", "env", "env.sync", "physics", "physics.dynamics", "physics.contacts",
                  "sensors", "update.adam_step"):
            assert np.isfinite(r[f"time/{k}_s"]) and r[f"time/{k}_s"] > 0, k
        # each span's children take at most its own time
        t = {k[len("time/"):-len("_s")]: v for k, v in r.items() if k.startswith("time/")}
        assert t["rollout.policy"] + t["env"] <= t["rollout"] and t["update.adam_step"] <= t["update"]
        assert t["env.sync"] + t.get("env.reset", 0.0) + t["physics"] + t["sensors"] <= t["env"]
        assert t["physics.dynamics"] + t["physics.contacts"] <= t["physics"]
    assert any("time/env.reset_s" in r for r in epochs)              # the resets inside the run
    assert sum("eval/success_rate" in r for r in rows) == 1
    assert sum(r["episode/dones"] for r in epochs) > 0            # episodes ended inside the run
    assert any(not torch.equal(start[k], v) for k, v in _params(tr.net).items())

    # the checkpoint: the reference's layout, read back into a fresh trainer
    tree = restore_path(str(out / "last"))
    assert set(tree) == {"params", "obs_rms", "priv_rms", "value_rms", "epoch", "agent_steps"}
    assert tree["params"]["params"]["actor_mlp"]["Dense_0"]["kernel"].shape == (23, 512)
    assert int(tree["agent_steps"]) == 32 and int(tree["epoch"]) == 2
    other = PPOTrainer(cfg, ppo.PPOConfig(horizon=4, mini_epochs=2, anchor_coef=1.0), model, subs, N,
                       str(tmp_path / "other"), seed=4, device="cpu")
    other.restore(str(out / "last"))
    for k, v in _params(tr.net).items():
        assert torch.equal(other.net.state_dict()[k], v), k
        assert torch.equal(other.state.anchor.state_dict()[k], v), k      # the anchor follows
    for name in ("obs_rms", "priv_rms", "value_rms"):
        for a, b in zip(getattr(tr.state, name), getattr(other.state, name)):
            assert torch.equal(a, b), name
    # the teacher eval CLI reads it as it reads a banked checkpoint
    sr = cli.main(["train.algo=PPO", "test=True", f"checkpoint={out}/last", "num_envs=2", "device=cpu",
                   "task.rl.max_episode_length=10"])
    assert 0.0 <= sr <= 1.0 and "Success Rate:" in capsys.readouterr().out


def test_anneal_ladder_restores_best_and_decays_lr(world, tmp_path):
    """After `patience` declining evals the trainer restores the best-eval
    params and multiplies the LR by `anneal_decay`, with fresh Adam moments."""
    cfg, model, subs = world
    c = ppo.PPOConfig(horizon=4, mini_epochs=2, learning_rate=1e-3, anneal_ladder=True,
                      anneal_patience=2, anneal_decay=0.5)
    tr = PPOTrainer(cfg, c, model, subs, N, str(tmp_path), device="cpu")
    lr = lambda: tr.state.optimizer.param_groups[0]["lr"]
    tr._anneal_step(0.5)                       # first eval: becomes the banked best
    best = _params(tr.net)
    tr.state, _ = tr.train_epoch(tr.state)     # params move
    assert any(not torch.equal(best[k], v) for k, v in _params(tr.net).items())
    tr._anneal_step(0.4)                       # decline 1: no restore yet
    assert lr() == pytest.approx(1e-3)
    tr._anneal_step(0.3)                       # decline 2 == patience: restore + decay
    for k, v in _params(tr.net).items():
        assert torch.equal(best[k], v), k
    assert lr() == pytest.approx(5e-4) and not tr.state.optimizer.state   # fresh moments
    tr._anneal_step(0.6)                       # a new best re-banks ...
    tr._anneal_step(0.55)                      # ... and one decline does not restore
    assert lr() == pytest.approx(5e-4)


def test_cli_trains_one_epoch_on_the_cpu(tmp_path):
    out = tmp_path / "cli"
    argv = ["train.algo=PPO", "test=False", "num_envs=2", "train.ppo.horizon_length=4",
            "train.ppo.mini_epochs=2", "ppo.lr_schedule=kl", "train.ppo.truncate_grads=False",
            "max_epochs=1", "seed=0", f"output={out}", "eval_freq_steps=1e12", "device=cpu"]
    args = cli.parse_args(argv)
    assert args["ppo"].horizon == 4 and args["ppo"].grad_norm == float("inf")
    assert args["max_epochs"] == 1 and args["eval_freq_steps"] == 1e12 and args["seed"] == 0
    tr = cli.main(argv)
    assert tr.state.epoch == 1 and tr.state.agent_steps == 8
    row = json.loads(open(out / "metrics.jsonl").readline())
    assert np.isfinite(row["loss"]) and "info/lr" in row


def test_vec_env_object_api(world):
    env = vec_env.make("FactoryTaskInsertionTactile", num_envs=2, device="cpu")
    obs = env.reset()
    assert tuple(obs["obs"].shape) == (2, env.num_observations)
    assert tuple(obs["priv_info"].shape) == (2, env.num_states)
    obs, rew, reset, extras = env.step(np.zeros((2, env.num_actions), np.float32))
    assert tuple(rew.shape) == (2,) and bool(torch.isfinite(obs["obs"]).all())
    assert "time_outs" in extras and "successes" in extras
    assert isinstance(vec_env.make("FactoryTaskOptimizeTactile", device="cpu"), vec_env.SysIdTask)
    assert isinstance(vec_env.make("FactoryTaskGraspTactile", num_envs=2, device="cpu"), vec_env.GraspGenTask)
    with pytest.raises(KeyError):
        vec_env.make("NoSuchTask")
