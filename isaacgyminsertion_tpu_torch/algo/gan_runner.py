"""CycleGAN sim→real trainer for tactile images.

Port of `isaacgyminsertion_tpu/algo/gan_runner.py`: two `ResnetGenerator`s
(sim → real `g_ab`, real → sim `g_ba`) and two `PatchDiscriminator`s trained
with the CycleGAN objective (LSGAN + cycle consistency + identity) on
unpaired (sim, real) frame sets; `translate` is the sim → real hook that the
env applies to rendered tactile frames.

A step is the reference's, in its order: the generator loss and its fakes
come from the old generators and the old discriminators, the generators take
their Adam step, then the discriminators' loss takes those same fakes,
detached, and the discriminators take theirs. Adam is optax's `adam(lr,
b1=0.5)`: betas (0.5, 0.999), eps 1e-8, one optimizer for the generators and
one for the discriminators. Checkpoints hold `{"params": {"g_ab", "g_ba",
"d_a", "d_b"}}`, each a flax variables tree, so the reference reads this
port's files and the other way round.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models.zoo import PatchDiscriminator, ResnetGenerator, init_like_flax, lsgan_loss, to_jax_params
from ..utils.checkpoint import Checkpointer
from ..utils.metrics import MetricsWriter

NETS = ("g_ab", "g_ba", "d_a", "d_b")


@dataclass(frozen=True)
class CycleGANConfig:
    epochs: int = 5
    batch_size: int = 16
    learning_rate: float = 2.0e-4
    lambda_cycle: float = 10.0
    lambda_identity: float = 0.5


class CycleGANRunner:
    def __init__(self, cfg: CycleGANConfig, out_dir: str, image_shape=(64, 64, 3), seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        c = image_shape[-1]
        gen = torch.Generator().manual_seed(int(seed))
        self.nets = {name: init_like_flax(cls(in_ch=c), gen).to(self.device)
                     for name, cls in zip(NETS, (ResnetGenerator, ResnetGenerator,
                                                 PatchDiscriminator, PatchDiscriminator))}
        self.G_ab, self.G_ba = self.nets["g_ab"], self.nets["g_ba"]
        self.D_a, self.D_b = self.nets["d_a"], self.nets["d_b"]
        adam = lambda nets: torch.optim.Adam([p for n in nets for p in n.parameters()],
                                             lr=cfg.learning_rate, betas=(0.5, 0.999), eps=1e-8)
        self.opt_g = adam((self.G_ab, self.G_ba))
        self.opt_d = adam((self.D_a, self.D_b))
        self.ckpt = Checkpointer(out_dir)
        self.writer = MetricsWriter(out_dir)

    def jax_params(self) -> dict:
        """The four nets as flax variables trees, the checkpoint's layout."""
        return {name: to_jax_params(self.nets[name]) for name in NETS}

    def train_step(self, a: torch.Tensor, b: torch.Tensor) -> dict:
        """One update on a sim batch `a` and a real batch `b` ([B, H, W, C])
        → {"g_loss", "d_loss", "cycle", "adv"} as tensors."""
        cfg = self.cfg
        g_ab, g_ba, d_a, d_b = self.G_ab, self.G_ba, self.D_a, self.D_b
        fake_b, fake_a = g_ab(a), g_ba(b)
        rec_a, rec_b = g_ba(fake_b), g_ab(fake_a)
        idt_b, idt_a = g_ab(b), g_ba(a)
        adv = lsgan_loss(d_b(fake_b), True) + lsgan_loss(d_a(fake_a), True)
        cyc = torch.mean(torch.abs(rec_a - a)) + torch.mean(torch.abs(rec_b - b))
        idt = torch.mean(torch.abs(idt_b - b)) + torch.mean(torch.abs(idt_a - a))
        g_loss = adv + cfg.lambda_cycle * cyc + cfg.lambda_identity * cfg.lambda_cycle * idt
        g_params = [p for n in (g_ab, g_ba) for p in n.parameters()]
        self.opt_g.zero_grad(set_to_none=True)
        g_loss.backward(inputs=g_params)          # the discriminators get no gradient here
        self.opt_g.step()

        fake_a, fake_b = fake_a.detach(), fake_b.detach()
        d_loss = 0.5 * (lsgan_loss(d_a(a), True) + lsgan_loss(d_a(fake_a), False)
                        + lsgan_loss(d_b(b), True) + lsgan_loss(d_b(fake_b), False))
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        self.opt_d.step()
        return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(), "cycle": cyc.detach(),
                "adv": adv.detach()}

    def fit(self, sim_images: np.ndarray, real_images: np.ndarray) -> dict:
        """Unpaired training: sim_images [Sa, H, W, C], real_images [Sb, H, W, C]
        (host arrays), `cfg.epochs` epochs of full batches; each epoch draws
        the sim order, then the real order, from one `default_rng(0)`, as the
        reference does. Writes the metrics and `last.ckpt` after each epoch;
        `self.step_metrics` holds every step's metrics (floats)."""
        rng = np.random.default_rng(0)
        bs = self.cfg.batch_size
        metrics, step = {}, 0
        self.step_metrics = []
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        for _epoch in range(self.cfg.epochs):
            n = min(len(sim_images), len(real_images))
            ia = rng.permutation(len(sim_images))[:n]
            ib = rng.permutation(len(real_images))[:n]
            for s in range(0, n - bs + 1, bs):
                m = self.train_step(t(sim_images[ia[s:s + bs]]), t(real_images[ib[s:s + bs]]))
                metrics = {k: float(v) for k, v in m.items()}
                self.step_metrics.append(metrics)
                step += 1
            self.writer.write(step, metrics)
            self.ckpt.save_last({"params": self.jax_params()}, step)
        return metrics

    @torch.no_grad()
    def translate(self, sim_images) -> torch.Tensor:
        """sim → real translation of [B, H, W, C] frames in [-1, 1]."""
        return self.G_ab(torch.as_tensor(sim_images, dtype=torch.float32, device=self.device))
