"""Training and evaluation loops: the PPO teacher's and the DAgger
student's epoch loops with their telemetry, periodic evals and checkpoint
rotation (and the teacher's anneal ladder), and the full-episode
deterministic evals of a trained teacher or student.

Port of `isaacgyminsertion_tpu/algo/trainer.py`: `make_eval_fn`,
`PPOTrainer` (training), the eval-only `TeacherEvaluator` in place of the
reference's `PPOTrainer.test` (it evaluates a checkpoint without building a
training state); `make_student_eval_fn`, `StudentEvaluator` (what the
reference's `DAggerTrainer.test` / `test_log` do, for banked checkpoints),
and `DAggerTrainer` (student training; its `test` / `test_log` run
`StudentEvaluator`'s code on the student in training).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..envs import insertion
from ..models.actor_critic import actor_critic_from_jax_params, convert_jax_params, to_jax_params
from ..models.running_mean_std import rms_normalize, rms_to, rms_to_numpy
from ..models.student import convert_flax_params, student_from_jax_params, student_to_jax_params
from ..models.zoo import generator_from_jax_params
from ..utils.checkpoint import Checkpointer, restore_path
from ..utils.metrics import AverageScalarMeter, MetricsWriter
from . import ext_adapt as ea
from . import ppo as ppo_mod


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


class PPOTrainer:
    """Stage-1 teacher trainer: epochs of `algo/ppo.py`, FPS metering,
    checkpoint rotation, periodic full-episode evals and the eval-gated
    anneal ladder (`PPOConfig.anneal_ladder`)."""

    def __init__(self, cfg_task, ppo_cfg, model, subs, n_envs, out_dir, seed: int = 0,
                 eval_envs: int | None = None, eval_freq_steps: float = 10.0e6, device=None,
                 grasp_data=None):
        self.device = resolve_device(device)
        self.cfg_task, self.ppo_cfg = cfg_task, ppo_cfg
        self.model, self.subs, self.n_envs = model, subs, n_envs
        # grasp-dataset resets drive the training env only: the evals reset
        # analytically, as the reference's do
        self.net, _, self.state, self.train_epoch = ppo_mod.build(
            cfg_task, ppo_cfg, model, subs, n_envs, seed, device=self.device, grasp_data=grasp_data)
        self.ckpt = Checkpointer(out_dir)
        self.writer = MetricsWriter(out_dir)
        self.episode_rewards = AverageScalarMeter()
        self.episode_success = AverageScalarMeter()
        # evals run the true clearance distribution, single episode
        self.eval_fn = make_eval_fn(eval_task_config(cfg_task), model, subs, self.net,
                                    eval_envs or min(n_envs, 64), device=self.device)
        self.eval_freq_steps = eval_freq_steps
        self._next_eval = eval_freq_steps
        self._best_eval = float("-inf")
        self._best_tree = None
        self._decline = 0
        self._cur_lr = ppo_cfg.learning_rate
        # once the LR sits at anneal_min_lr and patience trips again, the
        # ladder has nothing left: training stops
        self._anneal_exhausted = False
        self.ckpt.dump_config({"task": cfg_task, "ppo": ppo_cfg, "num_envs": n_envs})

    def _ckpt_tree(self) -> dict:
        """The checkpoint in the reference's layout (flax params as numpy)."""
        s = self.state
        return {"params": to_jax_params(self.net.state_dict()), "obs_rms": rms_to_numpy(s.obs_rms),
                "priv_rms": rms_to_numpy(s.priv_rms), "value_rms": rms_to_numpy(s.value_rms),
                "epoch": np.asarray(s.epoch, np.int32), "agent_steps": np.asarray(s.agent_steps, np.int64)}

    def _load_tree(self, tree):
        """Params and normalizers from a checkpoint tree, in place."""
        sd = convert_jax_params(tree["params"])
        self.net.load_state_dict(sd)
        self.state = self.state._replace(
            obs_rms=rms_to(tree["obs_rms"], self.device), priv_rms=rms_to(tree["priv_rms"], self.device),
            value_rms=rms_to(tree["value_rms"], self.device))
        if self.state.anchor is not None:
            self.state.anchor.load_state_dict(sd)

    def restore(self, path: str):
        """Params and normalizers from a checkpoint; with the anchor on, the
        anchor follows the restored policy."""
        self._load_tree(restore_path(path))

    def train(self, max_epochs: int | None = None, save_freq: int = 100, log_freq: int = 1):
        steps_per_epoch = self.ppo_cfg.horizon * self.n_envs
        max_epochs = max_epochs or int(self.ppo_cfg.max_agent_steps // steps_per_epoch)
        cuda = self.device.type == "cuda"
        t_start = time.perf_counter()
        for _ in range(max_epochs):
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.perf_counter()
            self.state, metrics = self.train_epoch(self.state)
            dt = time.perf_counter() - t0
            epoch, agent_steps = self.state.epoch, self.state.agent_steps
            self.episode_rewards.update(metrics["episode/reward"])
            self.episode_success.update(metrics["episode/success"])

            if epoch % log_freq == 0:
                metrics["performance/EnvStepFPS"] = steps_per_epoch / dt
                metrics["performance/RLTrainFPS"] = agent_steps / (time.perf_counter() - t_start)
                with torch.no_grad():
                    metrics["info/param_norm"] = float(torch.sqrt(
                        sum(torch.sum(p * p) for p in self.net.parameters())))
                if cuda:
                    metrics["performance/peak_memory_gb"] = \
                        torch.cuda.max_memory_allocated(self.device) / 1e9
                self.writer.write(agent_steps, metrics)
            if epoch % save_freq == 0:
                self.ckpt.save_last(self._ckpt_tree(), agent_steps)
                self.ckpt.maybe_save_best(self._ckpt_tree(), self.episode_rewards.current_mean,
                                          self.episode_success.current_mean)
            if agent_steps >= self._next_eval:
                self._next_eval += self.eval_freq_steps
                sr = self.eval_fn(self.state.obs_rms, self.state.priv_rms, epoch)
                self.writer.write(agent_steps, {"eval/success_rate": sr})
                self.ckpt.maybe_save_best(self._ckpt_tree(), float("-inf"), sr)
                self._anneal_step(sr)
                if self._anneal_exhausted:
                    print(f"[anneal] exhausted at lr={self._cur_lr:.2e}; "
                          f"stopping at best eval {self._best_eval:.3f}", flush=True)
                    break
            if agent_steps >= self.ppo_cfg.max_agent_steps:
                break
        self.ckpt.save_last(self._ckpt_tree(), self.state.agent_steps)
        return self.state

    def _set_lr(self, lr: float):
        ppo_mod.set_lr(self.state.optimizer, lr)

    def _anneal_step(self, sr: float):
        """One rung of the eval-gated anneal ladder."""
        c = self.ppo_cfg
        if not c.anneal_ladder:
            return
        if sr > self._best_eval:
            self._best_eval = sr
            self._best_tree = self._ckpt_tree()
            self._decline = 0
            if self.state.anchor is not None:
                # the anchor tracks the best-eval policy, not the start
                self.state.anchor.load_state_dict(self.net.state_dict())
            return
        if sr >= self._best_eval - c.anneal_margin:
            return  # within eval noise of the best: not a decline
        self._decline += 1
        if self._decline < c.anneal_patience or self._best_tree is None:
            return
        if self._cur_lr <= c.anneal_min_lr:
            # at the LR floor and declining again: restore the best once so
            # the saved `last` equals it, then stop
            self._anneal_exhausted = True
        # best params and normalizers, fresh Adam moments, decayed LR; the
        # env keeps rolling
        self._load_tree(self._best_tree)
        self.state = self.state._replace(
            optimizer=ppo_mod.make_optimizer(self.net.parameters(), c.learning_rate))
        self._cur_lr = max(self._cur_lr * c.anneal_decay, c.anneal_min_lr)
        self._set_lr(self._cur_lr)
        self._decline = 0
        self.writer.write(self.state.agent_steps, {"info/anneal_restore_best": self._best_eval,
                                                   "info/anneal_lr": self._cur_lr})
        print(f"[anneal] restored best eval {self._best_eval:.3f}, lr -> {self._cur_lr:.2e}",
              flush=True)

    def policy_act_fn(self):
        """env_state → the current policy's clamped deterministic actions."""
        act = ppo_mod.make_act_fn(self.cfg_task, self.net)

        def act_fn(env_state):
            priv = insertion.priv_info_of(self.cfg_task, self.model, env_state)
            return act(self.state.obs_rms, self.state.priv_rms, env_state.obs_queue, priv)

        return act_fn

    def record_video(self, n_steps: int = 150, seed: int = 0):
        """Rollout video + action/force traces of one env under the current
        deterministic policy (frozen_ppo.py:791-851 mp4/plot logging parity)
        → the paths of `videos/rollout.gif` and `videos/traces.png`."""
        from ..utils.video import record_eval_video

        return record_eval_video(self.cfg_task, self.model, self.subs, self.policy_act_fn(), n_steps=n_steps,
                                 out_dir=os.path.join(self.ckpt.out_dir, "videos"), seed=seed,
                                 device=self.device)


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

    @classmethod
    def of(cls, student: ea.StudentBundle, teacher: ea.TeacherBundle, eval_fn, device,
           out_dir: str | None = None) -> "StudentEvaluator":
        """An evaluator of a student and a teacher already in memory, with
        their eval function: the same attributes as from the checkpoints."""
        runner = cls.__new__(cls)
        runner.device, runner.out_dir, runner.teacher = device, out_dir, teacher
        runner.student, runner.eval_fn = student, eval_fn
        return runner

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


class DAggerTrainer:
    """Stage-2 student trainer: epochs of `algo/ext_adapt.py`'s DAgger, FPS
    metering, checkpoint rotation and eval-gated `best_success` banking
    (a student-driven full-episode eval every `eval_freq_steps` agent steps
    and once at the end).

    Checkpoints hold `{"student_params", "stud_obs_rms", "pcl_rms"}` in the
    reference's layout, so `StudentEvaluator` and the reference load them.
    `gan_ckpt_path`, a CycleGAN checkpoint of either package, puts its
    sim → real generator on the training rollout's tactile frames."""

    def __init__(self, cfg_task, da_cfg, model, subs, n_envs, out_dir, teacher_ckpt_path: str,
                 seed: int = 0, phase3: bool = False, student_ckpt_path: str = "",
                 gan_ckpt_path: str = "", eval_envs: int | None = None,
                 eval_freq_steps: float = 2.0e6, device=None):
        self.device = resolve_device(device)
        self.cfg_task, self.da_cfg, self.model, self.subs, self.n_envs = cfg_task, da_cfg, model, subs, n_envs
        tree = restore_path(teacher_ckpt_path)
        self.teacher = ea.TeacherBundle(
            net=actor_critic_from_jax_params(tree["params"], self.device).requires_grad_(False),
            obs_rms=rms_to(tree["obs_rms"], self.device), priv_rms=rms_to(tree["priv_rms"], self.device))
        # tactile sim→real: the training rollout's rendered frames pass through
        # the CycleGAN generator `g_ab`; the student evals render without it,
        # as the reference's do
        gan = (generator_from_jax_params(restore_path(gan_ckpt_path)["params"]["g_ab"], self.device)
               if gan_ckpt_path else None)
        self.state, self.train_epoch = ea.build(cfg_task, da_cfg, model, subs, n_envs, self.teacher, seed,
                                                phase3=phase3, device=self.device, gan=gan)
        if student_ckpt_path:
            # phase-2/3 restore: continue from a previous student
            stree = restore_path(student_ckpt_path)
            self.state.net.load_state_dict(convert_flax_params(stree["student_params"]))
            self.state = self.state._replace(
                stud_obs_rms=rms_to(stree.get("stud_obs_rms", self.state.stud_obs_rms), self.device),
                pcl_rms=rms_to(stree.get("pcl_rms", self.state.pcl_rms), self.device))
        self.ckpt = Checkpointer(out_dir)
        self.writer = MetricsWriter(out_dir)
        self._eval_envs = eval_envs
        self.eval_freq_steps = eval_freq_steps
        self._next_eval = eval_freq_steps
        self._eval_fn = None
        self._best_eval = float("-inf")
        self.ckpt.dump_config({"task": cfg_task, "dagger": da_cfg, "num_envs": n_envs, "phase3": phase3})

    def _ckpt_tree(self) -> dict:
        s = self.state
        return {"student_params": student_to_jax_params(s.net.state_dict()),
                "stud_obs_rms": rms_to_numpy(s.stud_obs_rms), "pcl_rms": rms_to_numpy(s.pcl_rms)}

    def _run_eval(self, agent_steps: int) -> float:
        if self._eval_fn is None:
            self._eval_fn = self._make_eval_fn(self._eval_envs)
        sr = self._eval_fn(self.state.student(), int(agent_steps) % (2**31))
        self.writer.write(agent_steps, {"eval/success_rate": sr})
        if sr > self._best_eval:
            self._best_eval = sr
            self.ckpt.maybe_save_best(self._ckpt_tree(), float("-inf"), sr)
        print(f"[dagger eval] steps={int(agent_steps)} success={sr:.4f} (best {self._best_eval:.4f})",
              flush=True)
        return sr

    def train(self, max_epochs: int = 1000, save_freq: int = 50):
        steps_per_epoch = self.da_cfg.horizon * self.n_envs
        cuda = self.device.type == "cuda"
        t_start = time.perf_counter()
        bad_epochs = 0
        for _ in range(max_epochs):
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.perf_counter()
            self.state, metrics = self.train_epoch(self.state)
            metrics["performance/EnvStepFPS"] = steps_per_epoch / (time.perf_counter() - t0)
            # a non-finite loss never recovers: abort instead of burning card time
            if not np.isfinite(metrics["loss"]):
                bad_epochs += 1
                if bad_epochs >= 3:
                    raise RuntimeError(
                        f"[dagger] loss non-finite for {bad_epochs} consecutive epochs (epoch "
                        f"{self.state.epoch}): {metrics}; check the sensor inputs and the teacher")
            else:
                bad_epochs = 0
            epoch, agent_steps = self.state.epoch, self.state.agent_steps
            metrics["performance/RLTrainFPS"] = agent_steps / (time.perf_counter() - t_start)
            with torch.no_grad():
                metrics["info/param_norm"] = float(torch.sqrt(
                    sum(torch.sum(p * p) for p in self.state.net.parameters())))
            if cuda:
                metrics["performance/peak_memory_gb"] = torch.cuda.max_memory_allocated(self.device) / 1e9
            self.writer.write(agent_steps, metrics)
            if epoch % save_freq == 0:
                self.ckpt.save_last(self._ckpt_tree(), agent_steps)
            if agent_steps >= self._next_eval:
                self._next_eval += self.eval_freq_steps
                self._run_eval(agent_steps)
        self.ckpt.save_last(self._ckpt_tree(), self.state.agent_steps)
        # the final eval, so that a short run still banks an eval-gated best
        self._run_eval(self.state.agent_steps)
        return self.state

    def _make_eval_fn(self, eval_envs: int | None):
        """Student evals on `eval_envs or min(n_envs, 64)` envs, under the
        reference's eval convention (`eval_task_config`)."""
        return make_student_eval_fn(eval_task_config(self.cfg_task), self.da_cfg, self.model, self.subs,
                                    self.teacher, eval_envs or min(self.n_envs, 64), device=self.device)

    def _evaluator(self, eval_envs: int | None) -> StudentEvaluator:
        return StudentEvaluator.of(self.state.student(), self.teacher, self._make_eval_fn(eval_envs),
                                   self.device, self.ckpt.out_dir)

    def test(self, n_episodes: int = 1, seed: int = 1234, eval_envs: int | None = None) -> float:
        """`StudentEvaluator.test` on the student in training."""
        return self._evaluator(eval_envs).test(n_episodes, seed)

    def test_log(self, eval_envs: int | None = None, **kw) -> dict:
        """`StudentEvaluator.test_log` (the point-cloud noise study) on the student in training."""
        return self._evaluator(eval_envs).test_log(**kw)
