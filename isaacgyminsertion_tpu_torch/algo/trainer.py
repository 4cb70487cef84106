"""Teacher and student evaluation: full-episode deterministic eval of a
trained policy.

Port of the eval half of `isaacgyminsertion_tpu/algo/trainer.py`:
`make_eval_fn` and `PPOTrainer.test` (the teacher), `make_student_eval_fn` and
`DAggerTrainer.test` / `test_log` (the student driving the sensors-on env).
PPO and DAgger training are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import resolve_device
from ..envs import insertion
from ..models.actor_critic import actor_critic_from_jax_params
from ..models.running_mean_std import rms_normalize, rms_to
from ..models.student import student_from_jax_params
from ..utils.checkpoint import restore_path
from . import ext_adapt as ea


def make_eval_fn(cfg_task, model, subs, net, n_envs: int, chunk: int = 50, device=None):
    """Full-episode deterministic evaluation → success rate. Resets are
    whatever `cfg_task` says; success is counted when an episode ends inserted
    (`extras["successes"]`) or when an env is inserted at a chunk boundary."""
    device = resolve_device(device)

    def evaluate(obs_rms, priv_rms, seed: int) -> float:
        gen = insertion.make_generator(seed, device)
        obs_rms_d, priv_rms_d = rms_to(obs_rms, device), rms_to(priv_rms, device)
        with torch.no_grad():
            env_state = insertion.reset_all(cfg_task, model, subs, gen, n_envs)
            ever_success = torch.zeros((n_envs,), device=device)
            for _ in range(max(cfg_task.rl.max_episode_length // chunk, 1)):
                for _ in range(chunk):
                    priv = insertion.priv_info_of(cfg_task, model, env_state)
                    mu = net(rms_normalize(obs_rms_d, env_state.obs_queue),
                             rms_normalize(priv_rms_d, priv))[0]
                    env_state, out = insertion.step(cfg_task, model, subs, env_state,
                                                    torch.clamp(mu, -1.0, 1.0), gen)
                    ever_success = torch.maximum(ever_success, out.extras["successes"])
                # also count being inserted at any point during the episode
                ever_success = torch.maximum(ever_success, env_state.success_reset_buf.float())
        return float(torch.mean(ever_success))

    return evaluate


def eval_task_config(cfg_task):
    """The config evals run: the true clearance distribution, single episode
    (no failure or success resets), as the reference's trainer evaluates."""
    return cfg_task.replace(
        reset_at_fails=False, reset_at_success=False,
        randomize=dataclasses.replace(cfg_task.randomize, clearance_curriculum_extra=0.0))


class TeacherEvaluator:
    """Eval-only teacher runner: what the reference's `PPOTrainer.test` does,
    for a checkpoint written by the reference trainer."""

    def __init__(self, cfg_task, model, subs, n_envs: int, checkpoint: str, device=None):
        self.device = resolve_device(device)
        tree = restore_path(checkpoint)
        self.net = actor_critic_from_jax_params(tree["params"], self.device)
        self.obs_rms, self.priv_rms = tree["obs_rms"], tree["priv_rms"]
        self.eval_fn = make_eval_fn(eval_task_config(cfg_task), model, subs, self.net, n_envs,
                                    device=self.device)

    def test(self, n_episodes: int = 1, seed: int = 1234) -> float:
        """Deterministic evaluation; prints and returns the success rate."""
        rates = [self.eval_fn(self.obs_rms, self.priv_rms, seed + i) for i in range(n_episodes)]
        sr = float(np.mean(rates))
        print(f"Success Rate: {sr:.4f}")
        return sr


def make_student_eval_fn(cfg_task, da_cfg, model, subs, teacher: ea.TeacherBundle, n_envs: int,
                         chunk: int = 50, device=None):
    """Full-episode student-driven evaluation → success rate (β = 0,
    deterministic student actions).

    First-episode success only: once an env resets, for any reason, it stops
    counting, so episodes that restart inside the window do not inflate the
    rate. An episode still running at the horizon counts its current success.
    The window is ceil(max_episode_length / chunk) chunks of `chunk` steps."""
    device = resolve_device(device)
    student_act = ea.make_student_act(cfg_task, da_cfg, teacher)

    def evaluate(student: ea.StudentBundle, seed: int, pcl_noise_std: float = 0.0) -> float:
        gen = insertion.make_generator(seed, device)
        with torch.no_grad():
            env_state = insertion.reset_all(cfg_task, model, subs, gen, n_envs)
            ever = torch.zeros((n_envs,), device=device)
            alive = torch.ones((n_envs,), device=device)
            steps = max(-(-cfg_task.rl.max_episode_length // chunk), 1) * chunk
            for _ in range(steps):
                prev_out = ea._prev_out_of(env_state, cfg_task)
                if da_cfg.use_priv:
                    prev_out = prev_out._replace(
                        priv_info=insertion.priv_info_of(cfg_task, model, env_state))
                # test-time point-cloud perturbation of the robustness study
                if prev_out.pcl.numel():
                    noise = torch.randn(prev_out.pcl.shape, generator=gen, device=device)
                    prev_out = prev_out._replace(pcl=prev_out.pcl + pcl_noise_std * noise)
                acts, _ = student_act(student, env_state.obs_stud_queue, prev_out)
                env_state, out = insertion.step(cfg_task, model, subs, env_state, acts, gen)
                ever = torch.maximum(ever, out.extras["successes"] * alive)
                alive = alive * (1.0 - out.reset.float())
            ever = torch.maximum(ever, env_state.success_reset_buf.float() * alive)
        return float(torch.mean(ever))

    return evaluate


class StudentEvaluator:
    """Eval-only student runner: what the reference's `DAggerTrainer.test` and
    `test_log` do, for a teacher and a student checkpoint written by the
    reference trainers. Evals use the reference convention: the true clearance
    distribution and no failure or success resets, so the env may recover from
    a degrasp inside the 500-step window."""

    def __init__(self, cfg_task, da_cfg, model, subs, n_envs: int, teacher_checkpoint: str,
                 student_checkpoint: str, out_dir: str | None = None, device=None):
        self.device = resolve_device(device)
        self.out_dir = out_dir
        tree = restore_path(teacher_checkpoint)
        self.teacher = ea.TeacherBundle(
            net=actor_critic_from_jax_params(tree["params"], self.device),
            obs_rms=rms_to(tree["obs_rms"], self.device),
            priv_rms=rms_to(tree["priv_rms"], self.device))
        stree = restore_path(student_checkpoint)
        self.student = ea.StudentBundle(
            net=student_from_jax_params(stree["student_params"], da_cfg, cfg_task.env, self.device),
            stud_obs_rms=rms_to(stree["stud_obs_rms"], self.device),
            pcl_rms=rms_to(stree["pcl_rms"], self.device))
        self.eval_fn = make_student_eval_fn(eval_task_config(cfg_task), da_cfg, model, subs,
                                            self.teacher, n_envs, device=self.device)

    def test(self, n_episodes: int = 1, seed: int = 1234) -> float:
        """Deterministic student-driven evaluation; prints and returns the success rate."""
        rates = [self.eval_fn(self.student, seed + i) for i in range(n_episodes)]
        sr = float(np.mean(rates))
        print(f"Success Rate: {sr:.4f}")
        return sr

    def test_log(self, noise_levels=(0.0, 0.00111, 0.00222, 0.00333, 0.00444, 0.00556, 0.00667,
                                     0.00778, 0.00889, 0.01), trials: int = 10) -> dict:
        """Robustness study: first-episode success under test-time point-cloud
        noise σ ∈ noise_levels, mean ± std over trials. With `out_dir` set it
        writes `noise_study.jsonl` and, where matplotlib is installed,
        `noise_study.png`."""
        results = {}
        for noise in noise_levels:
            succ = [self.eval_fn(self.student, 1234 + t, pcl_noise_std=noise) for t in range(trials)]
            results[noise] = (float(np.mean(succ)), float(np.std(succ)))
            print(f"noise_study σ={noise}: {results[noise][0]:.4f} ± {results[noise][1]:.4f}")
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, "noise_study.jsonl"), "w") as f:
                for noise, (mean, std) in results.items():
                    f.write(json.dumps({"noise": noise, "success_mean": mean, "success_std": std}) + "\n")
            try:
                import matplotlib
            except ImportError:
                return results
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            xs = np.asarray(list(results.keys()))
            means = np.asarray([m for m, _ in results.values()])
            stds = np.asarray([s for _, s in results.values()])
            fig, ax = plt.subplots(figsize=(7, 4))
            ax.errorbar(xs, means, yerr=stds, marker="o", capsize=3, lw=1.2)
            ax.set_xlabel("test-time pcl noise σ (m)")
            ax.set_ylabel(f"success rate (mean±std, {trials} trials)")
            ax.set_ylim(0.0, 1.0)
            ax.grid(alpha=0.3)
            fig.tight_layout()
            fig.savefig(os.path.join(self.out_dir, "noise_study.png"), dpi=110)
            plt.close(fig)
        return results
