"""Auxiliary model zoo (PyTorch).

Port of `isaacgyminsertion_tpu/models/zoo.py`:
  - `ActorCritic` (the legacy combined variant) with the `AdaptTConv` 1-D conv
    force/torque-history encoder
  - `TactileTransformer` and `TCN` sequence encoders
  - `PointMAE` masked point autoencoder and `chamfer_distance`
  - `TactileResNet` encoder and `TactileVAE`
  - the CycleGAN `ResnetGenerator` / `PatchDiscriminator` and `lsgan_loss`,
    the sim→real translator of tactile frames

Inputs keep the reference's layouts ([B, T, C] sequences, [B, H, W, C]
images); convolutions run channels-first inside. Submodules carry the
reference's flax names (`Conv_3`, `GroupNorm_1`, `TemporalBlock_0` …), so
`load_jax_params` maps a flax tree onto `state_dict()` key by key and
`to_jax_params` maps it back. Where flax differs from torch it is written
out: "SAME" padding puts the odd pixel after, `ConvTranspose` dilates its
input and correlates with the kernel unflipped, norms use eps 1e-6, `gelu`
is the tanh approximation.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .student import (NORM_EPS, FlaxMLP, SameConv, SameConv1d, SelfAttention, convert_flax_params,
                      init_student_like_flax, student_to_jax_params)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _group_norm(ch: int) -> nn.GroupNorm:
    """flax's `nn.GroupNorm(8)`: 8 groups, eps 1e-6."""
    return nn.GroupNorm(8, ch, eps=NORM_EPS)


class FlaxConvTranspose(nn.Conv2d):
    """flax `nn.ConvTranspose` with its default "SAME" padding: the input is
    dilated by the stride (zeros between pixels), zero-padded by
    (k + s − 2 − pad_after, pad_after) per side as `lax.conv_transpose`
    pads, and correlated with the kernel as stored (not flipped). The weight
    is the flax HWIO kernel in OIHW order, as a Conv's is."""

    def __init__(self, in_ch, out_ch, kernel: int, stride: int = 2):
        super().__init__(in_ch, out_ch, kernel, padding=0)
        self.up = stride
        pad_len = kernel + stride - 2
        pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
        self.pads = (pad_a, pad_len - pad_a)

    def forward(self, x):  # [B, C, H, W]
        b, c, h, w = x.shape
        s = self.up
        y = x.new_zeros((b, c, (h - 1) * s + 1, (w - 1) * s + 1))
        y[:, :, ::s, ::s] = x
        return super().forward(F.pad(y, (*self.pads, *self.pads)))


# --------------------------------------------------------------- 1-D families


class AdaptTConv(nn.Module):
    """1-D conv force/torque-history encoder: [B, T, ft_dim] → [B, out_dim]."""

    def __init__(self, ft_dim: int = 6, out_dim: int = 8, seq_len: int = 30):
        super().__init__()
        chans = ft_dim
        length = seq_len
        for i, (feat, k, s) in enumerate(((32, 9, 2), (32, 5, 1), (32, 5, 1))):
            setattr(self, f"Conv_{i}", SameConv1d(chans, feat, k, s))
            chans, length = feat, -(-length // s)
        self.Dense_0 = nn.Linear(length * chans, out_dim)

    def forward(self, ft_hist):
        x = ft_hist.transpose(1, 2)
        for i in range(3):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return self.Dense_0(x.transpose(1, 2).reshape(x.shape[0], -1))   # flatten [B, T, C]


class ActorCritic(nn.Module):
    """Legacy combined actor-critic with an optional force/torque encoder →
    (mu, log_std, value)."""

    def __init__(self, num_actions: int = 6, obs_dim: int = 15, units: Sequence[int] = (512, 256, 128),
                 use_ft: bool = False, ft_dim: int = 6, ft_len: int = 30):
        super().__init__()
        self.use_ft = use_ft
        if use_ft:
            self.AdaptTConv_0 = AdaptTConv(ft_dim, 8, ft_len)
        self.MLP_0 = FlaxMLP(obs_dim + (8 if use_ft else 0), units)
        self.Dense_0 = nn.Linear(units[-1], num_actions)
        self.Dense_1 = nn.Linear(units[-1], 1)
        self.log_std = nn.Parameter(torch.zeros(num_actions))

    def forward(self, obs, ft_hist=None):
        z = obs
        if self.use_ft and ft_hist is not None:
            z = torch.cat([z, self.AdaptTConv_0(ft_hist)], dim=-1)
        h = self.MLP_0(z)
        return self.Dense_0(h), self.log_std, self.Dense_1(h)[..., 0]


class TemporalBlock(nn.Module):
    """Causal dilated conv (kernel 3) with a residual; [B, T, C] in and out."""

    def __init__(self, in_ch: int, channels: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.Conv_0 = nn.Conv1d(in_ch, channels, 3, dilation=dilation)
        if in_ch != channels:
            self.Dense_0 = nn.Linear(in_ch, channels)

    def forward(self, x):
        h = F.pad(x.transpose(1, 2), (2 * self.dilation, 0))
        h = F.relu(self.Conv_0(h)).transpose(1, 2)
        res = self.Dense_0(x) if hasattr(self, "Dense_0") else x
        return h + res


class TCN(nn.Module):
    """Temporal convolutional net: [B, T, D] → [B, out_dim] at the last step."""

    def __init__(self, in_dim: int, channels: Sequence[int] = (64, 64, 64), out_dim: int = 8):
        super().__init__()
        self.n = len(channels)
        prev = in_dim
        for i, c in enumerate(channels):
            setattr(self, f"TemporalBlock_{i}", TemporalBlock(prev, c, 2**i))
            prev = c
        self.Dense_0 = nn.Linear(prev, out_dim)

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"TemporalBlock_{i}")(x)
        return self.Dense_0(x[:, -1])


class TactileTransformer(nn.Module):
    """Sequence transformer over per-step embeddings: [B, T, D] → [B, out_dim].
    The flax names follow the reference's construction order: in each layer
    the outer Dense (4E → E) is `Dense_{2i+1}`, the inner (E → 4E) `Dense_{2i+2}`."""

    def __init__(self, in_dim: int, seq_len: int, embed_dim: int = 64, num_heads: int = 4,
                 num_layers: int = 2, out_dim: int = 8):
        super().__init__()
        e = embed_dim
        self.num_layers = num_layers
        self.Dense_0 = nn.Linear(in_dim, e)
        self.pos = nn.Parameter(0.02 * torch.randn(1, seq_len, e))
        for i in range(num_layers):
            setattr(self, f"SelfAttention_{i}", SelfAttention(e, num_heads))
            setattr(self, f"LayerNorm_{2 * i}", nn.LayerNorm(e, eps=NORM_EPS))
            setattr(self, f"Dense_{2 * i + 1}", nn.Linear(4 * e, e))
            setattr(self, f"Dense_{2 * i + 2}", nn.Linear(e, 4 * e))
            setattr(self, f"LayerNorm_{2 * i + 1}", nn.LayerNorm(e, eps=NORM_EPS))
        setattr(self, f"Dense_{2 * num_layers + 1}", nn.Linear(e, out_dim))

    def forward(self, x):
        h = self.Dense_0(x) + self.pos
        for i in range(self.num_layers):
            h = getattr(self, f"LayerNorm_{2 * i}")(h + getattr(self, f"SelfAttention_{i}")(h))
            f = F.gelu(getattr(self, f"Dense_{2 * i + 2}")(h), approximate="tanh")
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(h + getattr(self, f"Dense_{2 * i + 1}")(f))
        return getattr(self, f"Dense_{2 * self.num_layers + 1}")(h[:, -1])


class PointMAE(nn.Module):
    """Masked point autoencoder: encode the visible points ([B, P, 3], mask
    [B, P] with 1 = visible), reconstruct `num_out_points` → (points, feature)."""

    def __init__(self, embed_dim: int = 128, num_out_points: int = 128):
        super().__init__()
        self.num_out_points = num_out_points
        self.Dense_0 = nn.Linear(3, 64)
        self.Dense_1 = nn.Linear(64, embed_dim)
        self.Dense_2 = nn.Linear(embed_dim, embed_dim)
        self.Dense_3 = nn.Linear(embed_dim, num_out_points * 3)

    def forward(self, pts, mask):
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(pts))))
        x = torch.where(mask[..., None] > 0, x, torch.full_like(x, -1e30))
        # amax: its gradient is shared among tied maxima, as jnp.max's is
        feat = torch.amax(x, dim=-2)
        out = self.Dense_3(F.relu(self.Dense_2(feat)))
        return out.reshape(out.shape[0], self.num_out_points, 3), feat


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer distance between point sets [B, P, 3] / [B, Q, 3]."""
    d = torch.sum(torch.square(a[:, :, None] - b[:, None, :]), dim=-1)
    return torch.mean(torch.amin(d, dim=2)) + torch.mean(torch.amin(d, dim=1))


# --------------------------------------------------------------- 2-D families


class TactileResNetBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, channels, 3, stride)
        self.GroupNorm_0 = _group_norm(channels)
        self.Conv_1 = SameConv(channels, channels, 3)
        self.GroupNorm_1 = _group_norm(channels)
        if in_ch != channels or stride != 1:
            self.Conv_2 = SameConv(in_ch, channels, 1, stride)

    def forward(self, x):  # [B, C, H, W]
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return F.relu(h + x)


class TactileResNet(nn.Module):
    """Small ResNet tactile encoder (GroupNorm): [B, H, W, C] → [B, out_dim]."""

    def __init__(self, in_ch: int = 3, out_dim: int = 64):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, 32, 7, 2)
        prev = 32
        for i, (c, s) in enumerate(((32, 1), (64, 2), (128, 2))):
            setattr(self, f"TactileResNetBlock_{i}", TactileResNetBlock(prev, c, s))
            prev = c
        self.Dense_0 = nn.Linear(prev, out_dim)

    def forward(self, x):
        h = F.relu(self.Conv_0(_nchw(x)))
        for i in range(3):
            h = getattr(self, f"TactileResNetBlock_{i}")(h)
        return self.Dense_0(torch.mean(h, dim=(2, 3)))


class TactileVAE(nn.Module):
    """Conv VAE over 64 × 64 tactile frames: `forward(x, eps)` → (recon, mu,
    logvar) with z = mu + exp(logvar / 2) · eps; `eps` is given, or drawn
    from `generator`."""

    def __init__(self, in_ch: int = 3, latent_dim: int = 32):
        super().__init__()
        self.enc1 = SameConv(in_ch, 32, 4, 2)
        self.enc2 = SameConv(32, 64, 4, 2)
        self.enc3 = SameConv(64, 128, 4, 2)
        self.fc_mu = nn.Linear(8 * 8 * 128, latent_dim)
        self.fc_logvar = nn.Linear(8 * 8 * 128, latent_dim)
        self.dec_fc = nn.Linear(latent_dim, 8 * 8 * 128)
        self.dec1 = FlaxConvTranspose(128, 64, 4)
        self.dec2 = FlaxConvTranspose(64, 32, 4)
        self.dec3 = FlaxConvTranspose(32, 3, 4)

    def encode(self, x):  # [B, H, W, C]
        h = F.relu(self.enc3(F.relu(self.enc2(F.relu(self.enc1(_nchw(x)))))))
        h = _nhwc(h).reshape(h.shape[0], -1)          # flatten H, W, C as flax does
        return self.fc_mu(h), self.fc_logvar(h)

    def decode(self, z):
        h = _nchw(F.relu(self.dec_fc(z)).reshape(z.shape[0], 8, 8, 128))
        h = F.relu(self.dec2(F.relu(self.dec1(h))))
        return _nhwc(torch.sigmoid(self.dec3(h)))

    def forward(self, x, eps=None, generator: torch.Generator | None = None):
        mu, logvar = self.encode(x)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self.decode(z), mu, logvar


# ------------------------------------------------------------------ CycleGAN


class ResnetGenerator(nn.Module):
    """The CycleGAN image translator: [B, H, W, C] in [-1, 1] → the same
    shape, tanh-ranged. 7×7 conv, a stride-2 3×3 conv (64 → 32 pads (0, 1)),
    `n_blocks` residual blocks, a stride-2 transposed conv back up and a
    7×7 conv, GroupNorm(8) throughout."""

    def __init__(self, in_ch: int = 3, base: int = 32, n_blocks: int = 4):
        super().__init__()
        self.n_blocks = n_blocks
        self.Conv_0 = SameConv(in_ch, base, 7)
        self.GroupNorm_0 = _group_norm(base)
        self.Conv_1 = SameConv(base, base * 2, 3, 2)
        self.GroupNorm_1 = _group_norm(base * 2)
        for i in range(2 * n_blocks):
            setattr(self, f"Conv_{i + 2}", SameConv(base * 2, base * 2, 3))
            setattr(self, f"GroupNorm_{i + 2}", _group_norm(base * 2))
        self.ConvTranspose_0 = FlaxConvTranspose(base * 2, base, 3)
        setattr(self, f"GroupNorm_{2 * n_blocks + 2}", _group_norm(base))
        setattr(self, f"Conv_{2 * n_blocks + 2}", SameConv(base, in_ch, 7))

    def forward(self, x):
        nb = self.n_blocks
        h = F.relu(self.GroupNorm_0(self.Conv_0(_nchw(x))))
        h = F.relu(self.GroupNorm_1(self.Conv_1(h)))
        for i in range(2, 2 * nb + 2, 2):
            r = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(h)))
            h = h + getattr(self, f"GroupNorm_{i + 1}")(getattr(self, f"Conv_{i + 1}")(r))
        h = F.relu(getattr(self, f"GroupNorm_{2 * nb + 2}")(self.ConvTranspose_0(h)))
        return _nhwc(torch.tanh(getattr(self, f"Conv_{2 * nb + 2}")(h)))


class PatchDiscriminator(nn.Module):
    """PatchGAN discriminator: [B, H, W, C] → [B, H/8, W/8, 1] logits."""

    def __init__(self, in_ch: int = 3, base: int = 32):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, base, 4, 2)
        self.Conv_1 = SameConv(base, base * 2, 4, 2)
        self.GroupNorm_0 = _group_norm(base * 2)
        self.Conv_2 = SameConv(base * 2, base * 4, 4, 2)
        self.GroupNorm_1 = _group_norm(base * 4)
        self.Conv_3 = SameConv(base * 4, 1, 4)

    def forward(self, x):
        h = F.leaky_relu(self.Conv_0(_nchw(x)), 0.2)
        h = F.leaky_relu(self.GroupNorm_0(self.Conv_1(h)), 0.2)
        h = F.leaky_relu(self.GroupNorm_1(self.Conv_2(h)), 0.2)
        return _nhwc(self.Conv_3(h))


def lsgan_loss(pred: torch.Tensor, is_real: bool) -> torch.Tensor:
    """Least-squares GAN loss against the target 1 (real) or 0 (fake)."""
    return torch.mean(torch.square(pred - (1.0 if is_real else 0.0)))


# ---------------------------------------------------------------- conversion


def load_jax_params(net: nn.Module, tree) -> nn.Module:
    """Load a flax parameter tree (numpy leaves, with or without its
    "params" key, or a whole `{"params": ...}` variables dict) into `net`."""
    net.load_state_dict(convert_flax_params(tree))
    return net


def to_jax_params(net: nn.Module) -> dict:
    """`net`'s parameters as the flax variables tree `{"params": {...}}`."""
    return student_to_jax_params(net.state_dict())


@torch.no_grad()
def init_like_flax(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw `net` as flax's default initializers draw the reference's
    module: Dense, Conv and ConvTranspose kernels `lecun_normal` over their
    fan-in, zero biases, norms at scale 1, `TactileTransformer.pos`
    normal(0.02)."""
    init_student_like_flax(net, generator)
    for m in net.modules():
        if isinstance(m, TactileTransformer):
            m.pos.normal_(0.0, 0.02, generator=generator)
    return net


def generator_from_jax_params(tree, device=None) -> ResnetGenerator:
    """A frozen eval-mode `ResnetGenerator` from the flax variables of the
    reference's (or this port's) CycleGAN `g_ab`, sized from its kernels."""
    p = tree.get("params", tree)
    n_convs = sum(1 for k in p if k.startswith("Conv_"))
    c_in = p["Conv_0"]["kernel"].shape[2]
    net = ResnetGenerator(in_ch=c_in, base=p["Conv_0"]["kernel"].shape[3], n_blocks=(n_convs - 3) // 2)
    load_jax_params(net, p)
    return net.to(device).eval().requires_grad_(False)
