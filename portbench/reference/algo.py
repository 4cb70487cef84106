"""PPO's and DAgger's arithmetic, written out: the running normalizers (Chan's
parallel update), the Gaussian policy's log-likelihood, GAE, the losses, the
clip by global norm and Adam (β 0.9, 0.999, ε 1e-8 outside the root)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class RMS(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def rms_init(shape, dev) -> RMS:
    return RMS(torch.zeros(shape, device=dev), torch.ones(shape, device=dev), torch.tensor(1e-4, device=dev))


def rms_update(rms: RMS, x) -> RMS:
    """Fold a batch (every leading axis) into the running moments; the batch
    variance is the population variance."""
    dims = tuple(range(x.ndim - rms.mean.ndim))
    bm, bv = x.mean(dim=dims), x.var(dim=dims, correction=0)
    n = torch.tensor(float(np.prod(x.shape[:len(dims)])), device=x.device)
    delta = bm - rms.mean
    tot = rms.count + n
    m2 = rms.var * rms.count + bv * n + delta ** 2 * rms.count * n / tot
    return RMS(rms.mean + delta * n / tot, m2 / tot, tot)


def rms_norm(rms: RMS, x, clip: float = 5.0):
    return torch.clamp((x - rms.mean) / torch.sqrt(rms.var + 1e-5), -clip, clip)


def rms_unnorm(rms: RMS, y):
    return y * torch.sqrt(rms.var + 1e-5) + rms.mean


def neglogp(actions, mu, log_std):
    return (0.5 * torch.sum(((actions - mu) / torch.exp(log_std)) ** 2, dim=-1) + torch.sum(log_std)
            + 0.5 * actions.shape[-1] * math.log(2.0 * math.pi))


def gae(rewards, values, dones, last_value, gamma: float, tau: float):
    """Advantages and returns [T, N], backwards from the bootstrap value."""
    advs = torch.zeros_like(rewards)
    adv, v_next, nd_next = torch.zeros_like(last_value), last_value, 1.0 - dones[-1]
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * v_next * nd_next - values[t]
        adv = delta + gamma * tau * nd_next * adv
        advs[t] = adv
        v_next, nd_next = values[t], 1.0 - dones[t]
    return advs, advs + values


def ppo_loss(mu, log_std, value, mb: dict, h: dict):
    """The clipped surrogate, the clipped value loss × 0.5 × critic_coef, the
    entropy of the state-independent std and the bounds loss on mu."""
    nlp = neglogp(mb["actions"], mu, log_std)
    ratio = torch.exp(mb["neglogp"] - nlp)
    a_loss = torch.mean(torch.maximum(-mb["advs"] * ratio,
                                      -mb["advs"] * torch.clamp(ratio, 1.0 - h["e_clip"], 1.0 + h["e_clip"])))
    v_clip = mb["values"] + torch.clamp(value - mb["values"], -h["e_clip"], h["e_clip"])
    c_loss = torch.mean(torch.maximum((value - mb["returns"]) ** 2, (v_clip - mb["returns"]) ** 2))
    entropy = torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e))
    b_loss = torch.mean(torch.sum(torch.clamp(mu - 1.1, min=0.0) ** 2 + torch.clamp(mu + 1.1, max=0.0) ** 2,
                                  dim=-1))
    return a_loss + 0.5 * c_loss * h["critic_coef"] - entropy * h["entropy_coef"] + b_loss * h["bounds_loss_coef"]


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if norm < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


class Adam:
    def __init__(self, params: list, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: list, grads: list):
        self.t += 1
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            m_hat = m / (1.0 - self.b1 ** self.t)
            v_hat = v / (1.0 - self.b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def reservoir_rows(cursor: int, u, cap: int) -> dict:
    """Algorithm R: {slot: batch row} of a write of B samples whose global
    indices are cursor … cursor + B − 1 (slot g while g < cap, else
    int32(u · float32(g + 1)) when below cap, else dropped); a slot drawn by
    several samples keeps the last of them."""
    g = cursor + torch.arange(u.shape[0], device=u.device)
    r = (u * (g + 1).to(torch.float32)).to(torch.int32).long()
    slot = torch.where(g < cap, g, r)
    out = {}
    for row, s in enumerate(slot.tolist()):
        if s < cap:
            out[s] = row
    return out
