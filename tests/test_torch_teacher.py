"""The banked r2b teacher through the port's own loader and eval at 16 CPU
envs: the same floor as tests/test_teacher_quality.py (success ≥ 0.5). The
port draws its own random numbers, so this holds the MDP's statistics, not
a trajectory."""

import os

import pytest
import torch

from isaacgyminsertion_tpu_torch.algo.trainer import make_eval_fn
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.models.actor_critic import actor_critic_from_jax_params
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
from isaacgyminsertion_tpu_torch.utils import profiling
from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "teacher_r2b", "best_success")


def test_banked_teacher_inserts_on_the_port():
    cfg = default_task_config()
    tree = restore_path(CKPT)
    net = actor_critic_from_jax_params(tree["params"], "cpu")
    evaluate = make_eval_fn(cfg, build_kuka_openhand(), build_subassembly_set(), net, n_envs=16,
                            device="cpu")
    launches = profiling.launches()["contact_solver"]
    sr = evaluate(tree["obs_rms"], tree["priv_rms"], seed=7)
    assert profiling.launches()["contact_solver"] == launches    # CPU tensors take the plain version
    # the reference's 1024-env success is 0.8428; 16 envs is a generous floor
    # against eval variance, not physics drift
    assert sr >= 0.5, f"banked teacher success {sr:.3f} < 0.5 on the port"
