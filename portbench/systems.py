"""The system under test, one class per kind of configuration (`algo` in the
configuration's file): the port's training epoch built through its own entry
(`algo.ppo.build`, `algo.ext_adapt.build`), its weights replaced by the
benchmark's, and called as users call it: every random draw (action noise,
permutations, mix coins, reservoir slots and rows) comes from the program's
own generators, which its `build` seeds from `--seed`.

Each class gives the harness:
  - `epoch()`: one `TrainEpoch.__call__` → its metrics;
  - `capture_epoch()`: the same call, with what the reference needs recorded
    at the epoch's method boundaries (the env state before every followed
    control step, the generators' states before it, the rollout's outputs,
    the draws of the update, the first three Adam steps' losses, the first
    gradient and the parameters after the third) and moved to the host; the
    recording is taken off afterwards;
  - `profile_parts()`: the callables of the traced slice (a few control
    steps, then one update phase);
  - the counts per epoch: agent steps, control steps, Adam steps, and the
    networks' matmul FLOPs (`work.models`);
  - `free()`: drops the program's state.
"""

from __future__ import annotations

import dataclasses

import torch

from . import tree, weights
from .work import models as work_models

PPO_KEYS = ("horizon", "mini_epochs", "learning_rate", "grad_norm", "e_clip", "gamma", "tau",
            "critic_coef", "entropy_coef", "bounds_loss_coef")
DAGGER_KEYS = ("horizon", "mini_epochs", "learning_rate", "grad_norm", "action_z_weight",
               "teacher_only_steps", "beta_anneal_steps", "replay_size", "replay_stratify",
               "replay_freeze_beta")
N_CHECKED_ADAM_STEPS = 3


def task_config(default, mix: dict):
    """The default `TaskConfig` with the traffic mix's env and task settings."""
    return default.replace(env=dataclasses.replace(default.env, **mix["env"]), **mix["task"])


class _Recorder:
    """Instance-attribute wrappers on the program's objects, taken off by `close`."""

    def __init__(self):
        self._undo = []

    def wrap(self, obj, name: str, make):
        original, own = getattr(obj, name), vars(obj).get(name)
        setattr(obj, name, make(original))
        self._undo.append((obj, name, own))

    def close(self):
        for obj, name, own in reversed(self._undo):
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        self._undo = []


def _new_capture(weights: dict) -> dict:
    return {"states": {}, "gen": {}, "train_gen": {}, "traj": [], "weights": weights}


def _state_recorder(cap: dict, steps: list, env_gen, train_gen):
    """→ record(env_state), called before each control step: keeps the state
    before the first step and before and after each followed one, and the
    env's and the policy's generator states before each followed one (on
    the host)."""
    keep = {0} | set(steps) | {t + 1 for t in steps}
    follow = set(steps)
    t = [0]

    def record(env_state):
        if t[0] in keep:
            cap["states"][t[0]] = tree.to_data(env_state)
        if t[0] in follow:
            cap["gen"][t[0]] = env_gen.get_state()
            cap["train_gen"][t[0]] = train_gen.get_state()
        t[0] += 1

    return record


class _Base:
    """What the two kinds share: the task, the robot and the subassemblies."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
        from isaacgyminsertion_tpu_torch.envs.config import default_task_config
        from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, int(seed), torch.device(device)
        self.n_envs = int(mix["envs"])
        self.task = task_config(default_task_config(), mix)
        self.model, self.subs = build_kuka_openhand(), build_subassembly_set()

    def _record_adam(self, rec: _Recorder, optimizer, params: dict, cap: dict):
        """The first gradient as Adam holds it after one step (m / (1 − β1)) and
        the parameters after the third step, by the parameter's name."""
        names = {id(p): n for n, p in params.items()}
        beta1 = optimizer.param_groups[0]["betas"][0]
        calls = [0]

        def make(step):
            def wrapped(*a, **kw):
                out = step(*a, **kw)
                calls[0] += 1
                if calls[0] == 1:
                    # a step that left no moment behind holds no gradient: NaN
                    cap["grad1"] = {names[id(p)]: (optimizer.state[p]["exp_avg"] / (1.0 - beta1)).cpu()
                                    if "exp_avg" in optimizer.state.get(p, {}) else torch.full_like(p, float("nan")).cpu()
                                    for g in optimizer.param_groups for p in g["params"]}
                if calls[0] == N_CHECKED_ADAM_STEPS:
                    cap["params3"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
                return out
            return wrapped

        rec.wrap(optimizer, "step", make)

    def _record_losses(self, rec: _Recorder, te, cap: dict):
        cap["losses"] = []

        def make(loss_fn):
            def wrapped(*a, **kw):
                loss, aux = loss_fn(*a, **kw)
                if len(cap["losses"]) < N_CHECKED_ADAM_STEPS:
                    cap["losses"].append(loss.detach().cpu())
                return loss, aux
            return wrapped

        rec.wrap(te, "loss", make)


class PPOSystem(_Base):
    """`teacher_ppo`: PPO on a fresh `ActorCriticSplit` (`algo.ppo`)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        super().__init__(cfg, mix, seed, device)
        from isaacgyminsertion_tpu_torch.algo import ppo

        h = cfg["ppo"]
        self.ppo_cfg = ppo.PPOConfig(**{k: h[k] for k in PPO_KEYS})
        self.net, _, self.state, self.te = ppo.build(self.task, self.ppo_cfg, self.model, self.subs,
                                                     self.n_envs, self.seed, device=self.dev)
        self.weights = weights.make(weights.actor_critic_shapes(cfg["policy"]), self.seed, self.dev)
        with torch.no_grad():
            self.net.load_state_dict(self.weights, strict=True)
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        c = self.ppo_cfg
        self.batch_rows = c.horizon * self.n_envs
        self.mb_size = self.batch_rows // c.mini_epochs
        self.control_steps = c.horizon
        self.adam_steps = c.mini_epochs * (self.batch_rows // self.mb_size)
        self.agent_steps = self.batch_rows
        ops = work_models.actor_critic(cfg["policy"])
        self.flops = ((c.horizon + 1) * self.n_envs * work_models.forward_flops(ops)
                      + self.adam_steps * self.mb_size * work_models.train_flops(ops))

    def epoch(self):
        self.state, metrics = self.te(self.state)
        return metrics

    def capture_epoch(self, steps: list):
        """One epoch with its inputs and outputs recorded for the reference:
        the env state before each of `steps` and after it, the generators'
        states before it (the action noise is drawn in the step), and the
        permutations' generator state before the update."""
        cap = _new_capture(self.weights)
        rec = _Recorder()
        record = _state_recorder(cap, steps, self.state.env_gen, self.state.train_gen)

        def wrap_step(step):
            def wrapped(state, env_state, eps=None):
                record(env_state)
                env_state, tr, m = step(state, env_state, eps)
                cap["traj"].append(tree.to_data(tr))
                return env_state, tr, m
            return wrapped

        def wrap_update(update):
            def wrapped(state, obs_rms, priv_rms, batch, perms=None):
                cap["update_args"] = tree.to_data((obs_rms, priv_rms, batch))
                cap["perm_gen"] = (state.train_gen if state.perm_gen is None else state.perm_gen).get_state()
                return update(state, obs_rms, priv_rms, batch, perms)
            return wrapped

        rec.wrap(self.te, "rollout_step", wrap_step)
        rec.wrap(self.te, "update", wrap_update)
        self._record_losses(rec, self.te, cap)
        self._record_adam(rec, self.state.optimizer, dict(self.net.named_parameters()), cap)
        try:
            self.state, metrics = self.te(self.state)
        finally:
            rec.close()
        cap["states"][self.control_steps] = tree.to_data(self.state.env_state)
        return cap, metrics

    def profile_parts(self, cap: dict):
        """(control step, update phase) of the traced slice."""
        env_state = [self.state.env_state]
        obs_rms, priv_rms, batch = tree.from_data(cap["update_args"], {"RMSState": type(self.state.obs_rms)},
                                                  self.dev)

        def control_step(t):
            env_state[0], _, _ = self.te.rollout_step(self.state, env_state[0])

        return control_step, lambda: self.te.update(self.state, obs_rms, priv_rms, batch)

    def free(self):
        del self.state, self.net, self.te


class DAggerSystem(_Base):
    """`student_dagger_*`: DAgger distillation of a fresh `MultiModalModel`
    from the banked teacher (`algo.ext_adapt`), the reservoir included."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, root: str):
        super().__init__(cfg, mix, seed, device)
        import os

        from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea
        from isaacgyminsertion_tpu_torch.models.actor_critic import ActorCriticSplit
        from isaacgyminsertion_tpu_torch.models.running_mean_std import RMSState

        t = cfg["teacher"]
        sd, obs_rms, priv_rms = weights.load_teacher(os.path.join(root, t["checkpoint"]), self.dev)
        net = ActorCriticSplit(num_actions=t["num_actions"], obs_dim=t["obs_dim"], priv_dim=t["priv_dim"],
                               priv_units=tuple(t["priv_units"]), units=tuple(t["units"]))
        net.load_state_dict(sd, strict=True)
        net = net.to(self.dev).eval().requires_grad_(False)
        teacher = ea.TeacherBundle(net=net, obs_rms=RMSState(*obs_rms), priv_rms=RMSState(*priv_rms))
        self.teacher_data = {"weights": {k: v.cpu() for k, v in sd.items()},
                             "obs_rms": [x.cpu() for x in obs_rms], "priv_rms": [x.cpu() for x in priv_rms]}
        d, s = cfg["dagger"], cfg["student"]
        self.da_cfg = ea.DAggerConfig(use_obs=s["use_obs"], use_pcl=s["use_pcl"], only_bc=s["bc_mode"],
                                      **{k: d[k] for k in DAGGER_KEYS})
        self.state, self.te = ea.build(self.task, self.da_cfg, self.model, self.subs, self.n_envs, teacher,
                                       self.seed, device=self.dev)
        self.weights = weights.make(weights.student_shapes(s), self.seed, self.dev)
        with torch.no_grad():
            self.state.net.load_state_dict(self.weights, strict=True)
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        c = self.da_cfg
        self.batch_rows = c.horizon * self.n_envs
        self.mb_size, self.n_mb = self.te.minibatch_shape(self.batch_rows)
        self.control_steps = c.horizon
        self.adam_steps = c.mini_epochs * self.n_mb
        self.agent_steps = self.batch_rows
        t_ops, s_ops = work_models.actor_critic(t), work_models.student(s)
        self.flops = (c.horizon * self.n_envs * (work_models.forward_flops(t_ops) + work_models.forward_flops(s_ops))
                      + self.adam_steps * self.mb_size * work_models.train_flops(s_ops))

    def epoch(self):
        self.state, metrics = self.te(self.state)
        return metrics

    def capture_epoch(self, steps: list):
        """One epoch with its inputs and outputs recorded for the reference
        (as `PPOSystem.capture_epoch`), with the student's rollout actions,
        the reservoir write's uniforms and the minibatch rows the reservoir
        drew."""
        cap = {**_new_capture(self.weights), "teacher": self.teacher_data, "s_actions": [], "rows": [],
               "agent_steps": self.state.agent_steps}
        rec = _Recorder()
        record = _state_recorder(cap, steps, self.state.env_gen, self.state.train_gen)
        student_out = [None]

        def wrap_student(act):
            def wrapped(*a, **kw):
                out = act(*a, **kw)
                student_out[0] = out[0]
                return out
            return wrapped

        def wrap_step(step):
            def wrapped(state, env_state, agent_steps, mix_u=None):
                record(env_state)
                env_state, sample, m, beta = step(state, env_state, agent_steps, mix_u)
                cap["traj"].append(tree.to_data(sample))
                cap["s_actions"].append(student_out[0].cpu())
                return env_state, sample, m, beta
            return wrapped

        def wrap_write(write):
            def wrapped(batch, u, u_a=None):
                cap["res_u"], cap["res_u_a"] = u.cpu(), None if u_a is None else u_a.cpu()
                return write(batch, u, u_a)
            return wrapped

        def wrap_draw(draw):
            def wrapped(*a, **kw):
                rows = draw(*a, **kw)
                cap["rows"].append(rows.cpu())
                return rows
            return wrapped

        rec.wrap(self.te, "student_act", wrap_student)
        rec.wrap(self.te, "rollout_step", wrap_step)
        rec.wrap(self.te.reservoir, "write", wrap_write)
        rec.wrap(self.te.reservoir, "draw_rows", wrap_draw)
        self._record_losses(rec, self.te, cap)
        self._record_adam(rec, self.state.optimizer, dict(self.state.net.named_parameters()), cap)
        try:
            self.state, metrics = self.te(self.state)
        finally:
            rec.close()
        cap["states"][self.control_steps] = tree.to_data(self.state.env_state)
        return cap, metrics

    def profile_parts(self, cap: dict):
        """(control step, update phase) of the traced slice."""
        from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea

        env_state = [self.state.env_state]
        student = ea.StudentBundle(self.state.net, self.state.stud_obs_rms, self.state.pcl_rms)

        def control_step(t):
            env_state[0], _, _, _ = self.te.rollout_step(self.state, env_state[0], self.state.agent_steps)

        def update():
            return self.te.update(student, self.state.optimizer, self.te.reservoir.rows, self.batch_rows,
                                  self.state.train_gen)

        return control_step, update

    def free(self):
        del self.state, self.te


def build(cfg: dict, mix: dict, seed: int, device, root: str):
    if cfg["algo"] == "ppo":
        return PPOSystem(cfg, mix, seed, device)
    if cfg["algo"] == "dagger":
        return DAggerSystem(cfg, mix, seed, device, root)
    raise ValueError(f"configuration {cfg['name']!r}: unknown algo {cfg['algo']!r}")
