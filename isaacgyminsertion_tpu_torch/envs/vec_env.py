"""Gym-style vectorized env wrapper and task registry.

Port of `isaacgyminsertion_tpu/envs/vec_env.py`: the object API of the
reference's VecTask (`reset()` / `step(actions)` → (obs_dict, rew, reset,
extras), obs_dict keys obs/priv_info/student_obs/tactile/img/seg/pcl/contacts)
over the functional env, the grasp-generation task and the sys-id task. The
in-repo trainers call the functional step directly.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..assets import build_subassembly_set
from ..physics.robot import build_kuka_openhand
from . import insertion
from .config import TaskConfig, default_task_config


class InsertionVecEnv:
    """The insertion task's object API (one batch of envs per instance), on
    CUDA unless `device="cpu"` is given; `grasp_data` makes its resets replay
    a grasp-dataset table."""

    def __init__(self, cfg: TaskConfig | None = None, num_envs: int = 128, seed: int = 0,
                 device=None, grasp_data=None):
        self.cfg = cfg or default_task_config()
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.model = build_kuka_openhand()
        self.subs = build_subassembly_set()
        self.grasp_data = grasp_data
        self.generator = insertion.make_generator(seed, self.device)
        with torch.no_grad():
            self.state = insertion.reset_all(self.cfg, self.model, self.subs, self.generator, num_envs,
                                             grasp_data=grasp_data)

    @property
    def num_observations(self) -> int:
        return self.cfg.env.num_observations * self.cfg.env.num_obs_hist

    @property
    def num_actions(self) -> int:
        return self.cfg.env.num_actions

    @property
    def num_states(self) -> int:
        return self.cfg.env.num_states

    def reset(self) -> dict:
        with torch.no_grad():
            self.state = insertion.reset_all(self.cfg, self.model, self.subs, self.generator,
                                             self.num_envs, grasp_data=self.grasp_data)
            priv = insertion.priv_info_of(self.cfg, self.model, self.state)
        s = self.state
        return {"obs": s.obs_queue, "priv_info": priv, "student_obs": s.obs_stud_queue,
                "tactile": s.tactile_queue, "img": s.img_queue, "seg": s.seg_queue,
                "pcl": s.pcl_queue, "contacts": s.contact_queue}

    def step(self, actions) -> tuple[dict, torch.Tensor, torch.Tensor, dict]:
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            self.state, out = insertion.step(self.cfg, self.model, self.subs, self.state, actions,
                                             self.generator, grasp_data=self.grasp_data)
        obs_dict = {"obs": out.obs, "priv_info": out.priv_info, "student_obs": out.student_obs,
                    "tactile": out.tactile, "img": out.img, "seg": out.seg, "pcl": out.pcl,
                    "contacts": out.contacts}
        return obs_dict, out.rew, out.reset, {"time_outs": out.timeout, **out.extras}


def _make_insertion(cfg=None, num_envs=128, **kw):
    return InsertionVecEnv(cfg=cfg, num_envs=num_envs, **kw)


class GraspGenTask:
    """FactoryTaskGraspTactile: writes a grasp dataset (`envs/grasp_gen.py`)
    from `num_envs` envs a round, on CUDA unless `device="cpu"` is given."""

    def __init__(self, cfg=None, num_envs=128, device=None):
        self.cfg = cfg or default_task_config()
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.model = build_kuka_openhand()
        self.subs = build_subassembly_set()

    def run(self, n_rounds: int, out_path: str, **kw) -> int:
        from .grasp_gen import generate_grasp_dataset

        return generate_grasp_dataset(self.cfg, self.model, self.subs, self.num_envs, n_rounds, out_path,
                                      device=self.device, **kw)


class SysIdTask:
    """FactoryTaskOptimizeTactile: TPE over the sim parameters against a
    recorded trajectory (`sysid.py`), on CUDA unless `device="cpu"` is given."""

    def __init__(self, cfg=None, num_envs=1, device=None):
        self.cfg = cfg or default_task_config()
        self.device = resolve_device(device)
        self.model = build_kuka_openhand()
        self.subs = build_subassembly_set()

    def run(self, recorded: dict, n_trials: int = 50, **kw):
        from ..sysid import optimize_sim_params

        return optimize_sim_params(self.cfg, self.model, self.subs, recorded, n_trials=n_trials,
                                   device=self.device, **kw)


task_map = {
    "FactoryTaskInsertionTactile": _make_insertion,
    "FactoryTaskGraspTactile": GraspGenTask,
    "FactoryTaskOptimizeTactile": SysIdTask,
}


def make(task_name: str, **kwargs):
    """The task by its reference name (isaacgyminsertion.make)."""
    if task_name not in task_map:
        raise KeyError(f"unknown task {task_name}; available: {list(task_map)}")
    return task_map[task_name](**kwargs)
