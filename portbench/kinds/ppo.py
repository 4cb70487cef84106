"""`teacher_ppo`: PPO on a fresh `ActorCriticSplit` (`algo.ppo`)."""

from __future__ import annotations

import torch

from .. import tree, weights
from ..systems import Base, Recorder, new_capture, settings, state_recorder
from ..work import models as work_models


class System(Base):

    @staticmethod
    def counts(cfg: dict, mix: dict) -> dict:
        """Per epoch: a minibatch of batch // mini_epochs rows (the reference's
        rule); the rollout's forwards, the bootstrap's and the update's."""
        h, n = cfg["ppo"], int(mix["envs"])
        batch_rows = h["horizon"] * n
        mb_size = batch_rows // h["mini_epochs"]
        adam_steps = h["mini_epochs"] * (batch_rows // mb_size)
        ops = work_models.ops(cfg["policy"], cfg)
        return {"batch_rows": batch_rows, "mb_size": mb_size, "control_steps": h["horizon"],
                "adam_steps": adam_steps, "agent_steps": batch_rows,
                "flops": ((h["horizon"] + 1) * n * work_models.forward_flops(ops)
                          + adam_steps * mb_size * work_models.train_flops(ops))}

    def __init__(self, cfg: dict, mix: dict, seed: int, device, root: str):
        super().__init__(cfg, mix, seed, device)
        from isaacgyminsertion_tpu_torch.algo import ppo

        self.ppo_cfg = settings(ppo.PPOConfig, cfg["ppo"])
        self.net, _, self.state, self.te = ppo.build(self.task, self.ppo_cfg, self.model, self.subs,
                                                     self.n_envs, self.seed, device=self.dev)
        self.weights = weights.make(weights.layout(cfg["policy"]), self.seed, self.dev)
        with torch.no_grad():
            self.net.load_state_dict(self.weights, strict=True)
        self.weights = {k: v.cpu() for k, v in self.weights.items()}

    def capture_epoch(self, steps: list):
        """One epoch with its inputs and outputs recorded for the reference:
        the env state before each of `steps` and after it, the generators'
        states before it (the action noise is drawn in the step), and the
        permutations' generator state before the update."""
        cap = new_capture(self.weights)
        rec = Recorder()
        record = state_recorder(cap, steps, self.state.env_gen, self.state.train_gen)

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
