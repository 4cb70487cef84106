"""Diffusion-policy training runner.

Port of `isaacgyminsertion_tpu/algo/diffusion_runner.py`: trains the chunked
diffusion policy (`models/diffusion.py`) on collected trajectories
(the observation at a chunk's start → its `chunk` actions, both normalized by
the dataset's stats), keeps EMA weights updated after every step, and
predicts by DDIM sampling from the EMA weights. The optimizer is optax's
`adamw(lr)`: weight decay 1e-4 on every parameter, betas (0.9, 0.999), eps
1e-8. Checkpoints hold `{"params", "ema_params"}` as flax variables trees,
the reference's layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import DataNormalizer, TrajectoryDataset
from ..models.diffusion import DiffusionPolicy
from ..models.zoo import load_jax_params, to_jax_params
from ..utils.checkpoint import Checkpointer, restore_path
from ..utils.metrics import MetricsWriter
from .offline_runner import WEIGHT_DECAY


@dataclass(frozen=True)
class DiffusionConfig:
    chunk: int = 8
    batch_size: int = 128
    epochs: int = 10
    learning_rate: float = 1.0e-4
    num_diffusion_steps: int = 100


class DiffusionRunner:
    def __init__(self, cfg: DiffusionConfig, data_dir: str, out_dir: str, obs_dim: int = 15,
                 act_dim: int = 6, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.normalizer = DataNormalizer(data_dir)
        self.normalizer.run()
        self.dataset = TrajectoryDataset(data_dir, seq_len=cfg.chunk, keys=("student_obs", "actions"),
                                         normalizer=self.normalizer)
        self.policy = DiffusionPolicy(act_dim=act_dim, chunk=cfg.chunk, obs_dim=obs_dim,
                                      num_diffusion_steps=cfg.num_diffusion_steps, device=self.device)
        self.net = self.policy.init(torch.Generator().manual_seed(int(seed)), self.device)
        self.ema = self.policy.ema_copy(self.net)
        self.optimizer = torch.optim.AdamW(self.net.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=WEIGHT_DECAY)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        self.ckpt = Checkpointer(out_dir)
        self.writer = MetricsWriter(out_dir)
        self.losses: list[float] = []

    def train_step(self, actions: torch.Tensor, obs: torch.Tensor, t=None, eps=None) -> torch.Tensor:
        """One AdamW step on the ε-prediction loss, then the EMA update →
        the loss. `t` and `eps` are the step indices and noise (drawn from
        `self.generator` where not given)."""
        loss = self.policy.loss(self.net, actions, obs, t=t, eps=eps, generator=self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.policy.ema_update(self.ema, self.net)
        return loss.detach()

    def run(self) -> dict:
        """`cfg.epochs` epochs over the dataset (batch order from
        `default_rng(0)`, as the reference draws it); the mean loss of the
        last 50 steps is logged and a checkpoint written after each epoch."""
        rng_np = np.random.default_rng(0)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        step = 0
        for _epoch in range(self.cfg.epochs):
            for batch in self.dataset.batches(self.cfg.batch_size, rng_np):
                loss = self.train_step(t(batch["actions"]), t(batch["student_obs"][:, 0]))
                self.losses.append(float(loss))
                step += 1
            self.writer.write(step, {"train/diffusion_loss": float(np.mean(self.losses[-50:]))})
            self.ckpt.save_last(self.checkpoint_tree(), step)
        return {"train/diffusion_loss": float(np.mean(self.losses[-50:]))}

    def checkpoint_tree(self) -> dict:
        return {"params": to_jax_params(self.net), "ema_params": to_jax_params(self.ema)}

    def restore(self, path: str):
        """Weights and EMA weights from a checkpoint of either package."""
        tree = restore_path(path)
        load_jax_params(self.net, tree["params"])
        load_jax_params(self.ema, tree["ema_params"])

    def predict(self, obs, x=None, generator: torch.Generator | None = None) -> torch.Tensor:
        """DDIM-sample action chunks [B, chunk, act_dim] for observations
        [B, obs_dim] from the EMA weights; x_T is `x` or drawn from `generator`
        (the runner's own where neither is given)."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        return self.policy.sample_ddim(self.ema, obs, x=x, generator=generator or self.generator)
