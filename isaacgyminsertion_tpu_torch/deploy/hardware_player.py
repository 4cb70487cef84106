"""Real-robot deployment mirror (parity: algo/deploy/deploy_s2.py).

Port of `isaacgyminsertion_tpu/deploy/hardware_player.py`. `HardwarePlayer`
rebuilds the exact sim-side model stack (teacher actor + RMS + student with
modality flags) from the same checkpoints that trained it, written by either
package, and runs the action loop against a `HardwareInterface`. The
ROS/MoveIt transport of the reference (algo/deploy/env/*) is out of scope:
the interface protocol is the seam where it plugs in (`transport.py` carries
it over TCP, `devices.py` implements it for a robot). `SimInterface` backs
the same loop with the simulator at one env, so the deploy path runs end to
end without hardware.

Deploy-specific action scales (deploy_s2.py:72-78) override the train-time
pos/rot scales. The players and `SimInterface` run on CUDA unless
`device="cpu"` is given. The teacher and student players' `deploy` takes an
optional logger (`data.logger.DataLoggerReal`) that records each step.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from .. import resolve_device
from ..envs import insertion
from ..envs.config import TaskConfig, default_task_config
from ..models.actor_critic import actor_critic_from_jax_params
from ..models.running_mean_std import rms_normalize, rms_to
from ..utils.checkpoint import restore_path


class HardwareInterface(Protocol):
    """Hardware seam: implement with ROS/MoveIt drivers on the robot host."""

    def get_observation(self) -> dict:
        """→ {'eef_pos', 'eef_quat', 'actions_prev', ...} numpy arrays."""
        ...

    def apply_action(self, delta_pos: np.ndarray, delta_rot: np.ndarray) -> None:
        ...

    def reset(self) -> None:
        ...


class SimInterface:
    """Simulator-backed HardwareInterface: the port's env at one env. Its
    resets and DR draw from one generator seeded `seed`."""

    def __init__(self, cfg: TaskConfig, seed: int = 0, device=None):
        from ..assets import build_subassembly_set
        from ..physics.robot import build_kuka_openhand

        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_kuka_openhand()
        self.subs = build_subassembly_set()
        self.generator = insertion.make_generator(seed, self.device)
        self.reset()

    def reset(self):
        with torch.no_grad():
            self.state = insertion.reset_all(self.cfg, self.model, self.subs, self.generator, 1)

    def get_observation(self) -> dict:
        s = self.state
        # copies: on the CPU a tensor's numpy view would follow the env's state
        d = {"obs": s.obs_queue[0].cpu().numpy().copy(), "student_obs": s.obs_stud_queue[0].cpu().numpy().copy()}
        # sensor modalities (populated after the first step; zero-sized when
        # the modality is off — same contract as StepOutput), as float32
        for k, q in (("tactile", s.tactile_queue), ("img", s.img_queue), ("seg", s.seg_queue),
                     ("pcl", s.pcl_queue)):
            d[k] = q[0].float().cpu().numpy().copy()
        # the end-effector pose at the observation, the logger schema's eef_pos / eef_quat
        d["eef_pos"], d["eef_quat"] = self.eef_pose
        return d

    def apply_action(self, delta_pos, delta_rot):
        # deploy commands are metric deltas (deploy_s2.py pos/rot_action_scale
        # applied by the player); the sim env consumes normalized [-1, 1]
        # actions and applies its own rl.*_action_scale — invert it here
        act = np.concatenate([
            np.asarray(delta_pos) / np.asarray(self.cfg.rl.pos_action_scale),
            np.asarray(delta_rot) / np.asarray(self.cfg.rl.rot_action_scale),
        ])
        act = torch.as_tensor(np.clip(act, -1.0, 1.0)[None], dtype=torch.float32, device=self.device)
        with torch.no_grad():
            self.state, _ = insertion.step(self.cfg, self.model, self.subs, self.state, act, self.generator)

    @property
    def success(self) -> bool:
        return bool(self.state.success_reset_buf[0])

    @property
    def eef_pose(self) -> tuple[np.ndarray, np.ndarray]:
        """(pos [3], quat [4]) of the fingertip-centered eef frame — the
        hardware-side pose the calibration loop compares against."""
        from ..physics.kinematics import forward_kinematics, site_pose
        from ..physics.robot import SITE_FINGERTIP_CENTERED

        with torch.no_grad():
            fk = forward_kinematics(self.model, self.state.phys.q)
            q, t = site_pose(self.model, fk, SITE_FINGERTIP_CENTERED)
        return t[0].cpu().numpy().copy(), q[0].cpu().numpy().copy()


class HardwarePlayer:
    """deploy_s2.HardwarePlayer.deploy() mirror."""

    def __init__(self, teacher_ckpt: str, cfg: TaskConfig | None = None,
                 pos_action_scale=(0.002, 0.002, 0.002),
                 rot_action_scale=(0.01, 0.01, 0.01), device=None):
        self.cfg = cfg or default_task_config()
        self.device = resolve_device(device)
        tree = restore_path(teacher_ckpt)
        self.net = actor_critic_from_jax_params(tree["params"], self.device)
        self.obs_rms = rms_to(tree["obs_rms"], self.device)
        self.priv_rms = rms_to(tree["priv_rms"], self.device)
        self.pos_action_scale = np.asarray(pos_action_scale)
        self.rot_action_scale = np.asarray(rot_action_scale)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)[None], device=self.device)

    @torch.no_grad()
    def _actor(self, obs, latent=None) -> torch.Tensor:
        """The actor's clamped mean on a zero privileged state: hardware has
        none, so the actor runs on the zero latent unless a student latent is
        injected (student deploy)."""
        o = rms_normalize(self.obs_rms, obs)
        zeros_priv = torch.zeros(obs.shape[:-1] + (self.cfg.env.num_states,), device=obs.device)
        mu = self.net(o, rms_normalize(self.priv_rms, zeros_priv), latent=latent)[0]
        return torch.clamp(mu, -1.0, 1.0)

    def act(self, ob: dict) -> np.ndarray:
        """The normalized 6-dim action for one observation dict."""
        return self._actor(self._tensor(ob["obs"]))[0].cpu().numpy()

    def deploy(self, hw: HardwareInterface, num_steps: int = 500, logger=None) -> int:
        """Run the 60 Hz action loop; returns executed steps. `logger` is an
        optional data.logger.DataLoggerReal recording the rollout."""
        hw.reset()
        for t in range(num_steps):
            ob = hw.get_observation()
            act = self.act(ob)
            hw.apply_action(act[:3] * self.pos_action_scale, act[3:] * self.rot_action_scale)
            done = bool(getattr(hw, "success", False)) or t == num_steps - 1
            if logger is not None:
                logger.add_step(ob, act, done=done)
            if done and t < num_steps - 1:
                return t + 1
        return num_steps


class StudentHardwarePlayer(HardwarePlayer):
    """Student deploy (deploy_s2.py:54-167 mirror): the student predicts the
    extrinsics latent (or, in only-BC mode, the action directly) from onboard
    modalities; the latent is injected into the frozen teacher actor
    (act_inference with student latent, models_split.py:154-199)."""

    def __init__(self, teacher_ckpt: str, student_ckpt: str, da_cfg,
                 cfg: TaskConfig | None = None,
                 pos_action_scale=(0.002, 0.002, 0.002),
                 rot_action_scale=(0.01, 0.01, 0.01), device=None):
        super().__init__(teacher_ckpt, cfg, pos_action_scale, rot_action_scale, device)
        from ..models.student import student_from_jax_params

        self.da_cfg = da_cfg
        tree = restore_path(student_ckpt)
        self.student = student_from_jax_params(tree["student_params"], da_cfg, self.cfg.env, self.device)
        self.stud_obs_rms = rms_to(tree["stud_obs_rms"], self.device)
        self.pcl_rms = rms_to(tree["pcl_rms"], self.device)

    def _inputs_of(self, ob: dict) -> dict:
        from ..algo.ext_adapt import _seg_masks

        inp = {}
        if self.da_cfg.use_obs:
            inp["obs"] = rms_normalize(self.stud_obs_rms, self._tensor(ob["student_obs"]))
        if self.da_cfg.use_tactile:
            inp["tactile"] = self._tensor(ob["tactile"])
        if self.da_cfg.use_img:
            inp["img"] = self._tensor(ob["img"])
        if self.da_cfg.use_seg:
            inp["seg"] = _seg_masks(self._tensor(ob["seg"])[:, -1])[:, None]
        if self.da_cfg.use_pcl:
            p = self._tensor(ob["pcl"])
            inp["pcl"] = rms_normalize(self.pcl_rms, p[:, -1] if p.ndim == 4 else p)
        return inp

    @torch.no_grad()
    def act(self, ob: dict) -> np.ndarray:
        lat = self.student(**self._inputs_of(ob))
        if self.da_cfg.only_bc:
            return lat[0].cpu().numpy()  # 6-dim tanh action directly (only-BC mode)
        return self._actor(self._tensor(ob["obs"]), latent=lat)[0].cpu().numpy()


class PosPredHardwarePlayer:
    """Position-prediction deploy (deploy_pos_pred.py mirror): a trained
    tactile→pose regressor (algo/tactile_runner.py) estimates the plug-in-hand
    pose from the fingertip tactile frames; the loop servos the predicted plug
    toward a target pose with a P-controller in action space."""

    def __init__(self, tactile_ckpt: str, cfg: TaskConfig | None = None,
                 pos_action_scale=(0.002, 0.002, 0.002),
                 rot_action_scale=(0.01, 0.01, 0.01),
                 target_pos=(0.5, 0.0, 0.0), gain: float = 1.0, device=None):
        from ..models.student import tactile_head_from_jax_params

        self.cfg = cfg or default_task_config()
        self.device = resolve_device(device)
        self.net = tactile_head_from_jax_params(restore_path(tactile_ckpt)["params"], self.device).eval()
        self.pos_action_scale = np.asarray(pos_action_scale)
        self.rot_action_scale = np.asarray(rot_action_scale)
        self.target_pos = np.asarray(target_pos)
        self.gain = gain

    @torch.no_grad()
    def predict(self, tactile: np.ndarray) -> np.ndarray:
        """[B, F, H, W, C] frames → [B, 7] plug pose (pos 3, quat 4)."""
        return self.net(torch.as_tensor(np.asarray(tactile, np.float32), device=self.device)).cpu().numpy()

    def deploy(self, hw: HardwareInterface, num_steps: int = 100) -> int:
        hw.reset()
        for t in range(num_steps):
            ob = hw.get_observation()
            tact = ob.get("tactile")
            if tact is None or tact.size == 0:
                break  # tactile modality off — nothing to predict from
            pred = self.predict(tact[None, -1])[0]  # [pos 3, quat 4]
            err = self.target_pos - pred[:3]
            act = np.clip(self.gain * err / self.pos_action_scale, -1.0, 1.0)
            hw.apply_action(act * self.pos_action_scale, np.zeros(3))
            if getattr(hw, "success", False):
                return t + 1
        return num_steps


class DiffusionHardwarePlayer:
    """Diffusion-policy deploy (deploy_diffusion.py mirror): DDIM-samples an
    action chunk conditioned on the current student obs and executes it
    open-loop before re-planning. x_T comes from a generator seeded `seed`."""

    def __init__(self, ckpt: str, cfg: TaskConfig | None = None,
                 pos_action_scale=(0.002, 0.002, 0.002),
                 rot_action_scale=(0.01, 0.01, 0.01),
                 execute_horizon: int = 4, seed: int = 0, device=None):
        from ..models.diffusion import DiffusionPolicy, unet_from_jax_params

        self.cfg = cfg or default_task_config()
        self.device = resolve_device(device)
        tree = restore_path(ckpt)
        e = self.cfg.env
        obs_dim = e.num_obs_stud_hist * e.num_obs_student
        self.net = unet_from_jax_params(tree.get("ema_params", tree.get("params")), e.num_actions, obs_dim,
                                        self.device).eval()
        self.policy = DiffusionPolicy(act_dim=e.num_actions, obs_dim=obs_dim, device=self.device)
        self.execute_horizon = execute_horizon
        self.pos_action_scale = np.asarray(pos_action_scale)
        self.rot_action_scale = np.asarray(rot_action_scale)
        self.generator = insertion.make_generator(seed, self.device)

    def plan(self, ob: dict) -> np.ndarray:
        """One DDIM action chunk [chunk, act_dim] for an observation dict."""
        obs = torch.as_tensor(np.asarray(ob["student_obs"], np.float32)[None], device=self.device)
        return self.policy.sample_ddim(self.net, obs, generator=self.generator)[0].cpu().numpy()

    def deploy(self, hw: HardwareInterface, num_steps: int = 500) -> int:
        hw.reset()
        t = 0
        while t < num_steps:
            ob = hw.get_observation()
            for act in np.clip(self.plan(ob)[: self.execute_horizon], -1.0, 1.0):
                hw.apply_action(act[:3] * self.pos_action_scale,
                                act[3:] * self.rot_action_scale)
                t += 1
                if getattr(hw, "success", False):
                    return t
                if t >= num_steps:
                    break
        return num_steps
