"""The port's PBT (`pbt/`) against the reference on the CPU: the mutations and
the replacement decisions are the reference's under the same `random.seed`
(the cases of tests/test_pbt.py); the driver at 3 members × 4 envs × horizon
4 replaces, mutates and logs as the reference's does; the exported
`best_success.ckpt` is read by both packages. No JAX env step or PPO epoch is
compiled."""

import ast
import glob
import json
import os
import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu import pbt as j_pbt
from isaacgyminsertion_tpu.pbt import pbt as j_pbt_mod
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch import cli, pbt
from isaacgyminsertion_tpu_torch.algo.ppo import PPOConfig
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.pbt import pbt as pbt_mod
from isaacgyminsertion_tpu_torch.pbt import run as pbt_run
from isaacgyminsertion_tpu_torch.pbt.driver import run_pbt_population
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TEACHER = os.path.join(ROOT, "checkpoints", "teacher_r2b", "best_success")
LOG_KEYS = {"interval", "policy", "objective", "hparams", "replaced", "agent_steps",
            "train_success_mean", "secs"}


@pytest.mark.parametrize("seed,rate", [(0, 1.0), (1, 0.15), (7, 0.5)])
def test_mutate_matches_the_reference(seed, rate):
    hp = {"learning_rate": 1e-3, "e_clip": 0.2, "mini_epochs": 8, "grad_norm": 1.0, "horizon": 64}
    outs = []
    for mod in (j_pbt, pbt):
        random.seed(seed)
        outs.append([mod.mutate(hp, mutation_rate=rate) for _ in range(20)])
    assert outs[0] == outs[1]
    for out in outs[1]:
        assert 0.01 <= out["e_clip"] <= 0.3 and 1 <= out["mini_epochs"] <= 16 and out["learning_rate"] > 0


# (objectives of policies 0..2 already in the workspace, this policy's, the
# PbtParams overrides, the steps since restart and in all, replaced?)
CASES = {
    "replace": ([10.0, 9.0, 8.0], 0.1, {}, 1e9, True),
    "top_kept": ([1.0, 2.0, 3.0], 5.0, {}, 1e9, False),
    "before_start_steps": ([10.0, 9.0, 8.0], 0.1, {"start_after_steps": 1e6, "initial_delay_steps": 1e6},
                           10, False),
    "threshold_blocks": ([1.001, 1.0005, 1.0002], 1.0, {"replace_threshold_frac_absolute": 10.0}, 1e9, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pbt_update_matches_the_reference(case, tmp_path):
    objs, mine, over, steps, replaced = CASES[case]
    results = []
    for mod, ws in ((j_pbt_mod, tmp_path / "jax"), (pbt_mod, tmp_path / "port")):
        kw = {"start_after_steps": 0, "initial_delay_steps": 0, **over}
        p = mod.PbtParams(workspace=str(ws), num_policies=4, **kw)
        member = lambda i, o: mod.PbtMember(policy_idx=i, iteration=1, true_objective=o,
                                            hparams={"learning_rate": 1e-3, "e_clip": 0.2},
                                            weights={"w": np.ones(3) * i})
        for i, o in enumerate(objs):
            mod.save_pbt_checkpoint(p, member(i, o))
        random.seed(11)
        results.append(mod.pbt_update(p, member(3, mine), steps_since_restart=steps, total_steps=steps))
        results[-1] += (mod.load_population(p)[0].true_objective, random.random())
    (j_hp, j_w, j_rep, j_obj0, j_next), (hp, w, rep, obj0, nxt) = results
    assert (hp, rep, obj0, nxt) == (j_hp, j_rep, j_obj0, j_next) and rep == replaced
    assert (w is None) == (j_w is None) and (w is None or np.array_equal(w["w"], j_w["w"]))
    if replaced:
        assert float(w["w"][0]) == 0.0       # the top policy's weights


def test_population_skips_the_jax_package_files(tmp_path):
    """A .pbt the JAX driver wrote pickles jax.Arrays and the reference's
    PbtMember: the port skips it as it skips a corrupt file."""
    p = pbt.PbtParams(workspace=str(tmp_path), num_policies=4)
    pbt_mod.save_pbt_checkpoint(p, pbt.PbtMember(0, 1, 1.0, {"learning_rate": 1e-3}, {"w": np.ones(2)}))
    j_pbt_mod.save_pbt_checkpoint(p, j_pbt.PbtMember(1, 1, 2.0, {"learning_rate": 1e-3},
                                                     {"w": jnp.ones(2)}))
    (tmp_path / "p002_iter000001.pbt").write_bytes(b"not a pickle")
    assert set(pbt_mod.load_population(p)) == {0}
    assert set(j_pbt_mod.load_population(p)) == {0, 1}   # the reference reads both


@pytest.fixture(scope="module")
def world():
    return default_task_config(), build_kuka_openhand(), build_subassembly_set()


@pytest.mark.parametrize("mutable", [("learning_rate",), ("learning_rate", "e_clip")],
                         ids=["lr_only", "lr_and_e_clip"])
def test_driver_replaces_mutates_and_logs(world, tmp_path, mutable):
    """3 members, a fixed objective per member (0 best): members 1 and 2 take
    member 0's tensors; with every key mutated, a learning-rate change keeps
    the Adam moments and an e_clip change starts them afresh."""
    cfg, model, subs = world
    obj = {0: 1.0, 1: 0.5, 2: 0.0}
    seen = []

    def eval_fn(net, obs_rms, priv_rms, seed):
        idx = seed % 1000
        seen.append((idx, {k: v.clone() for k, v in net.state_dict().items()}, obs_rms.mean.clone()))
        return obj[idx]

    random.seed(0)
    members = run_pbt_population(
        cfg, PPOConfig(horizon=4, mini_epochs=2), model, subs, n_envs=4,
        pbt_params=pbt.PbtParams(num_policies=3, workspace=str(tmp_path), start_after_steps=0,
                                 initial_delay_steps=0, mutation_rate=1.0),
        epochs_per_interval=1, intervals=1, eval_fn=eval_fn, mutable_hparams=mutable,
        lr_spread=[1e-4, 5e-5, 2.5e-5], device="cpu")
    assert [s[0] for s in seen] == [0, 1, 2]
    top = seen[0][1]
    for m in members[1:]:                       # replaced by member 0's weights
        sd = m["state"].net.state_dict()
        assert all(torch.equal(sd[k], top[k]) for k in top)
        assert torch.equal(m["state"].obs_rms.mean, seen[0][2])
    rows = [json.loads(x) for x in open(tmp_path / "pbt_log.jsonl")]
    assert [r["policy"] for r in rows] == [0, 1, 2] and all(set(r) == LOG_KEYS for r in rows)
    assert [r["replaced"] for r in rows] == [False, True, True]
    assert [r["objective"] for r in rows] == [1.0, 0.5, 0.0]
    for m in members[1:]:
        opt, hp = m["state"].optimizer, m["hparams"]
        assert set(hp) == set(mutable) and opt.param_groups[0]["lr"] == hp["learning_rate"]
        assert m["cfg"].learning_rate == hp["learning_rate"]
        if mutable == ("learning_rate",):
            # the moments of the member's own epoch (2 mini-epochs x 2 minibatches) are kept
            assert all(int(opt.state[p]["step"]) == 4 for p in m["state"].net.parameters())
        else:
            assert not opt.state                                    # Adam starts afresh
            assert m["train_epoch"].ppo_cfg.e_clip == hp["e_clip"] != 0.2
    assert len(glob.glob(str(tmp_path / "p*.pbt"))) == 3 and os.path.exists(tmp_path / "best.pbt")


def test_log_keys_are_the_reference_ones():
    src = open(os.path.join(ROOT, "isaacgyminsertion_tpu", "pbt", "driver.py")).read()
    dumps = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "train_success_mean" for k in n.keys)]
    assert len(dumps) == 1 and {k.value for k in dumps[0].keys} == LOG_KEYS


def test_run_exports_a_checkpoint_both_packages_read(world, tmp_path, capsys):
    """`pbt.run` with the fine-tune recipe's variables, cut to 2 members x 4
    envs x horizon 4, one interval: best.pbt exported as best_success.ckpt."""
    cfg, model, subs = world
    env = {"RESTORE": TEACHER + ".ckpt", "LR_SPREAD": "1e-4,5e-5", "POLICIES": "2", "NUM_ENVS": "4",
           "HORIZON": "4", "EPOCHS_PER_INTERVAL": "1", "INTERVALS": "1", "START_AFTER": "0",
           "INITIAL_DELAY": "0", "WORKSPACE": str(tmp_path), "DEVICE": "cpu"}
    members = pbt_run.main(env)
    assert len(members) == 2 and all(np.isfinite(m["objective"]) for m in members)
    assert all(m["history"][0]["env_steps_per_s"] > 0 for m in members)
    out = capsys.readouterr().out
    assert "pbt global best: policy" in out
    path = str(tmp_path / "best_success")
    tree, ref = j_restore(path + ".ckpt"), j_restore(TEACHER + ".ckpt")
    assert set(tree) == {"params", "obs_rms", "priv_rms", "value_rms"}
    flat = lambda t, pre="": ({pre: np.shape(t)} if not isinstance(t, dict)
                              else {k2: v2 for k, v in t.items() for k2, v2 in flat(v, f"{pre}/{k}").items()})
    assert flat(tree["params"]) == flat(ref["params"])
    assert np.asarray(tree["obs_rms"].mean).shape == np.asarray(ref["obs_rms"].mean).shape
    with open(tmp_path / "best.pbt", "rb") as f:
        assert pickle.load(f).weights.keys() == tree.keys()
    sr = cli.main(["train.algo=PPO", "test=True", f"checkpoint={path}", "num_envs=2", "device=cpu",
                   "task.rl.max_episode_length=10"])                # the port's teacher-eval CLI
    assert 0.0 <= sr <= 1.0 and "Success Rate:" in capsys.readouterr().out
