"""`student_dagger_*`: DAgger distillation of a fresh `MultiModalModel` from
the banked teacher (`algo.ext_adapt`), the reservoir included. The port's
`DAggerConfig` takes every field that the configuration's `dagger` and
`student` blocks set: the hyperparameters, and the student's modality flags
and output (`use_obs`, `use_tactile`, `use_img`, `use_seg`, `use_pcl`,
`only_bc`) under the port's own names."""

from __future__ import annotations

import os

import torch

from .. import tree, weights
from ..systems import Base, Recorder, new_capture, settings, state_recorder
from ..work import models as work_models


class System(Base):

    @staticmethod
    def counts(cfg: dict, mix: dict) -> dict:
        """Per epoch: minibatches of batch // mini_epochs rows, as the
        reference sizes them (checked against the program's own rule); the
        rollout's teacher and student forwards and the update's."""
        h, n = cfg["dagger"], int(mix["envs"])
        batch_rows = h["horizon"] * n
        mb_size = max(batch_rows // h["mini_epochs"], 1)
        n_mb = batch_rows // mb_size
        adam_steps = h["mini_epochs"] * n_mb
        t_ops, s_ops = work_models.ops(cfg["teacher"], cfg), work_models.ops(cfg["student"], cfg)
        return {"batch_rows": batch_rows, "mb_size": mb_size, "n_mb": n_mb, "control_steps": h["horizon"],
                "adam_steps": adam_steps, "agent_steps": batch_rows,
                "flops": (h["horizon"] * n * (work_models.forward_flops(t_ops) + work_models.forward_flops(s_ops))
                          + adam_steps * mb_size * work_models.train_flops(s_ops))}

    def __init__(self, cfg: dict, mix: dict, seed: int, device, root: str):
        super().__init__(cfg, mix, seed, device)
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
        self.da_cfg = settings(ea.DAggerConfig, cfg["dagger"], cfg["student"])
        self.state, self.te = ea.build(self.task, self.da_cfg, self.model, self.subs, self.n_envs, teacher,
                                       self.seed, device=self.dev)
        if self.te.minibatch_shape(self.batch_rows) != (self.mb_size, self.n_mb):
            raise ValueError(f"the program's minibatches {self.te.minibatch_shape(self.batch_rows)} are not "
                             f"the configuration's {(self.mb_size, self.n_mb)}")
        self.weights = weights.make(weights.layout(cfg["student"]), self.seed, self.dev)
        with torch.no_grad():
            self.state.net.load_state_dict(self.weights, strict=True)
        self.weights = {k: v.cpu() for k, v in self.weights.items()}

    def capture_epoch(self, steps: list):
        """One epoch with its inputs and outputs recorded for the reference
        (as the `ppo` kind's), with the student's rollout actions, the
        reservoir write's uniforms and the minibatch rows the reservoir
        drew."""
        cap = {**new_capture(self.weights), "teacher": self.teacher_data, "s_actions": [], "rows": [],
               "agent_steps": self.state.agent_steps}
        rec = Recorder()
        record = state_recorder(cap, steps, self.state.env_gen, self.state.train_gen)
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
