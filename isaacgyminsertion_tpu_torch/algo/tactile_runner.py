"""Tactile-only regression runner (parity: transformer/tactile_runner.py:27).

Port of `isaacgyminsertion_tpu/algo/tactile_runner.py`: trains a tactile
encoder to regress the plug's pose from tactile frames, here on
sim-rendered frames (`algo/collect.py::collect_rotating_plug`) or on
imported real data with the same npz schema (tactile [T, F, H, W, C], pose
targets). The network is `models/student.py::TactileHead` (TactileCNN →
Dense 64 → ReLU → Dense `target_dim`), trained on the MSE by AdamW with
optax's defaults (weight decay 1e-4) at a constant learning rate; the
checkpoint holds `{"params": <flax tree>}`, the reference's layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models.student import (TactileHead, init_student_like_flax, student_to_jax_params,
                              tactile_head_from_jax_params)
from ..utils.checkpoint import Checkpointer
from ..utils.metrics import MetricsWriter
from .offline_runner import WEIGHT_DECAY


@dataclass(frozen=True)
class TactileRunnerConfig:
    batch_size: int = 64
    epochs: int = 10
    learning_rate: float = 3.0e-4
    target_dim: int = 7  # pos 3 + quat 4


class TactileRegressionRunner:
    def __init__(self, cfg: TactileRunnerConfig, out_dir: str, seed: int = 0, device=None):
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.net: TactileHead | None = None   # built at the first `fit`, from the frames' channels
        self.ckpt = Checkpointer(out_dir)
        self.writer = MetricsWriter(out_dir)

    def load_params(self, tree):
        """Load a flax regressor tree (the reference's `params`)."""
        self._set_net(tactile_head_from_jax_params(tree, self.device))

    def _set_net(self, net: TactileHead):
        self.net = net
        self.optimizer = torch.optim.AdamW(net.parameters(), lr=self.cfg.learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)

    def fit(self, tactile: np.ndarray, targets: np.ndarray) -> float:
        """tactile [S, F, H, W, C], targets [S, target_dim] → the last step's
        loss; `epoch_losses` keeps each epoch's mean."""
        rng = np.random.default_rng(0)
        if self.net is None:
            net = TactileHead(tactile.shape[1] * tactile.shape[-1], self.cfg.target_dim)
            self._set_net(init_student_like_flax(net, torch.Generator().manual_seed(int(self.seed)))
                          .to(self.device))
        S = tactile.shape[0]
        losses, step = [], 0
        self.epoch_losses = []
        for epoch in range(self.cfg.epochs):
            first = len(losses)
            order = rng.permutation(S)
            for s in range(0, S - self.cfg.batch_size + 1, self.cfg.batch_size):
                idx = order[s:s + self.cfg.batch_size]
                self.optimizer.zero_grad(set_to_none=True)
                loss = torch.mean(torch.square(self.net(self._t(tactile[idx])) - self._t(targets[idx])))
                loss.backward()
                self.optimizer.step()
                losses.append(loss.detach())
                step += 1
            if len(losses) > first:
                self.epoch_losses.append(float(torch.stack(losses[first:]).mean()))
            last = float(losses[-1]) if losses else float("nan")
            self.writer.write(step, {"train/tactile_loss": last})
        self.ckpt.save_last({"params": student_to_jax_params(self.net.state_dict())}, step)
        return float(losses[-1]) if losses else float("nan")

    @torch.no_grad()
    def predict(self, tactile: np.ndarray) -> np.ndarray:
        return self.net(self._t(tactile)).cpu().numpy()
