"""Student multi-modal model (PyTorch): one token per modality, fused by a
small self-attention transformer.

Port of `isaacgyminsertion_tpu/models/student.py`:
  - tactile: 3-finger stacked CNN with spatial soft-argmax (`TactileCNN`), or
    an EfficientNet-b0-style encoder with GroupNorm (`EfficientTactileEncoder`)
  - depth/seg: `DepthCNN` conv stack
  - linear obs: MLP encoder
  - point clouds: per-object `PointNet` encoders + a compressor, with
    POSITIONAL slicing of the merged cloud [plug | socket | goal | scene]
  - token fusion: `MultiLayerDecoder` = self-attention encoder + positional
    embedding + MLP head [256, 128, 64, 32]
  - output: latent 8 (student RMA latent) or a 6-dim tanh action (BC mode)

Public inputs keep the reference's layouts (tactile [B, T, F, H, W, C], images
[B, T, H, W] or [B, T, H, W, C], clouds [B, P, 3]); convolutions run NCHW
inside. Submodules carry the reference's flax names (`Dense_0`, `Conv_1`,
`SelfAttention_0` …), so `convert_flax_params` maps a flax tree onto
`state_dict()` key by key and `student_to_jax_params` maps it back. What
differs between the frameworks is written out: flax convolutions pad "SAME"
(asymmetric for stride 2 on even sizes), flax LayerNorm/GroupNorm use eps
1e-6, flax `gelu` is the tanh approximation. `init_student_like_flax` draws
a fresh student with flax's default initializers.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

NORM_EPS = 1e-6   # flax LayerNorm / GroupNorm default


def _same_pad(x, kernel: int, stride: int, dims: int = 2):
    """Zero-pad the last `dims` axes (H and W, or the length of a 1-D conv's
    input) as XLA's "SAME" does: out = ceil(in / stride), the odd pixel of
    padding goes after (so 64→32 pads (0, 1), 27→14 pads (1, 1))."""
    pads = []
    for size in x.shape[-1:-dims - 1:-1]:              # F.pad takes the last dim first
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv(nn.Conv2d):
    """Conv2d with flax's default padding ("SAME")."""

    def __init__(self, in_ch, out_ch, kernel: int, stride: int = 1, groups: int = 1, bias=True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0, groups=groups, bias=bias)

    def forward(self, x):
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride[0]))


class SameConv1d(nn.Conv1d):
    """Conv1d with flax's default padding ("SAME") over [B, C, L]."""

    def __init__(self, in_ch, out_ch, kernel: int, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0)

    def forward(self, x):
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride[0], dims=1))


class FlaxMLP(nn.Module):
    """Dense stack with ELU after every layer (the reference's `MLP` with its
    default `activate_last=True`), submodules named `Dense_i`."""

    def __init__(self, in_dim: int, units: Sequence[int]):
        super().__init__()
        dims = [in_dim, *units]
        self.n = len(units)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"Dense_{i}", nn.Linear(a, b))

    def forward(self, x):
        for i in range(self.n):
            x = F.elu(getattr(self, f"Dense_{i}")(x))
        return x


class SpatialSoftArgmax(nn.Module):
    """Expected pixel coordinates per channel."""

    def __init__(self, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature

    def forward(self, x):  # [B, C, H, W]
        b, c, h, w = x.shape
        pos_y, pos_x = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=x.device),
                                      torch.linspace(-1.0, 1.0, w, device=x.device), indexing="ij")
        attn = torch.softmax(x.reshape(b, c, h * w) / self.temperature, dim=-1)
        ex = torch.sum(attn * pos_x.reshape(1, 1, h * w), dim=-1)
        ey = torch.sum(attn * pos_y.reshape(1, 1, h * w), dim=-1)
        return torch.cat([ex, ey], dim=-1)  # [B, 2C]


def _fingers_as_channels(x):
    """[B, F, H, W, C] → [B, F·C, H, W], channels in (finger, channel) order."""
    b, f, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b, f * c, h, w)


class TactileCNN(nn.Module):
    """Per-finger CNN + spatial soft-argmax; fingers stacked as channels."""

    def __init__(self, in_ch: int = 9, out_dim: int = 64):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, 32, 3, 2)
        self.Conv_1 = SameConv(32, 64, 3, 2)
        self.Conv_2 = SameConv(64, 64, 3, 2)
        self.SpatialSoftArgmax_0 = SpatialSoftArgmax()
        self.Dense_0 = nn.Linear(128, out_dim)

    def forward(self, x):  # [B, F, H, W, C]
        x = _fingers_as_channels(x)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(conv(x))
        return self.Dense_0(self.SpatialSoftArgmax_0(x))


class MBConv(nn.Module):
    """Mobile inverted bottleneck block (EfficientNet-b0 building block with
    GroupNorm in place of BatchNorm)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, expand: int = 4):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        self.Conv_0 = SameConv(in_ch, mid, 1, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(min(8, mid), mid, eps=NORM_EPS)
        self.Conv_1 = SameConv(mid, mid, 3, stride, groups=mid, bias=False)
        self.GroupNorm_1 = nn.GroupNorm(min(8, mid), mid, eps=NORM_EPS)
        self.Dense_0 = nn.Linear(mid, max(in_ch // 4, 4))      # squeeze-excite
        self.Dense_1 = nn.Linear(max(in_ch // 4, 4), mid)
        self.Conv_2 = SameConv(mid, out_ch, 1, bias=False)
        self.GroupNorm_2 = nn.GroupNorm(min(8, out_ch), out_ch, eps=NORM_EPS)

    def forward(self, x):
        h = F.silu(self.GroupNorm_0(self.Conv_0(x)))
        h = F.silu(self.GroupNorm_1(self.Conv_1(h)))
        se = torch.mean(h, dim=(2, 3))
        se = torch.sigmoid(self.Dense_1(F.silu(self.Dense_0(se))))
        h = h * se[:, :, None, None]
        h = self.GroupNorm_2(self.Conv_2(h))
        return h + x if self.residual else h


class EfficientTactileEncoder(nn.Module):
    """EfficientNet-b0-style tactile encoder (the alternative to the
    spatial-softargmax CNN)."""

    def __init__(self, in_ch: int = 9, out_dim: int = 64):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, 16, 3, 2, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(4, 16, eps=NORM_EPS)
        ch_in, i = 16, 0
        for ch, st in ((24, 2), (40, 2), (80, 2)):
            setattr(self, f"MBConv_{i}", MBConv(ch_in, ch, stride=st))
            setattr(self, f"MBConv_{i + 1}", MBConv(ch, ch, stride=1))
            ch_in, i = ch, i + 2
        self.Dense_0 = nn.Linear(80, out_dim)

    def forward(self, x):  # [B, F, H, W, C]
        h = F.silu(self.GroupNorm_0(self.Conv_0(_fingers_as_channels(x))))
        for i in range(6):
            h = getattr(self, f"MBConv_{i}")(h)
        return self.Dense_0(torch.mean(h, dim=(2, 3)))


class DepthCNN(nn.Module):
    """Conv encoder for 54×96 depth/seg images."""

    def __init__(self, in_ch: int = 1, out_dim: int = 64, flat_dim: int = 4 * 6 * 128):
        super().__init__()
        self.Conv_0 = SameConv(in_ch, 32, 3, 2)
        self.Conv_1 = SameConv(32, 64, 3, 2)
        self.Conv_2 = SameConv(64, 64, 3, 2)
        self.Conv_3 = SameConv(64, 128, 3, 2)
        self.Dense_0 = nn.Linear(flat_dim, out_dim)

    def forward(self, x):  # [B, H, W] or [B, H, W, C]
        x = x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2, self.Conv_3):
            x = F.relu(conv(x))
        # the reference flattens (H, W, C): flatten in that order so its Dense
        # kernel carries over unpermuted
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.Dense_0(x))


class PointNet(nn.Module):
    """Shared-MLP max-pool PointNet."""

    def __init__(self, out_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(3, 64)
        self.Dense_1 = nn.Linear(64, 128)
        self.Dense_2 = nn.Linear(128, out_dim)

    def forward(self, pts):  # [B, P, 3]
        x = pts
        for dense in (self.Dense_0, self.Dense_1, self.Dense_2):
            x = F.relu(dense(x))
        # amax, not max(dim): its gradient is shared among tied maxima, as
        # jnp.max's is (max(dim) sends it all to one of them)
        return torch.amax(x, dim=-2)  # [B, out_dim]


class _Projection(nn.Module):
    """A flax DenseGeneral: `kernel` and `bias` in the reference's shapes."""

    def __init__(self, kernel_shape, bias_shape, fan_in: int):
        super().__init__()
        self.fan_in = fan_in   # the contracted axes of the kernel
        self.kernel = nn.Parameter(torch.randn(kernel_shape) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class SelfAttention(nn.Module):
    """Multi-head self-attention with the reference's parameter layout:
    query/key/value kernels [E, H, D], out kernel [H, D, E]; the query is
    scaled by 1/sqrt(D) before the dot product."""

    def __init__(self, embed_dim: int = 64, num_heads: int = 4):
        super().__init__()
        d = embed_dim // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, _Projection((embed_dim, num_heads, d), (num_heads, d), embed_dim))
        self.out = _Projection((num_heads, d, embed_dim), (embed_dim,), embed_dim)
        self.scale = 1.0 / math.sqrt(d)

    def forward(self, x):  # [B, T, E]
        proj = lambda p: torch.einsum("bte,ehd->bthd", x, p.kernel) + p.bias
        q, k, v = proj(self.query) * self.scale, proj(self.key), proj(self.value)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return torch.einsum("bqhd,hde->bqe", o, self.out.kernel) + self.out.bias


class MultiLayerDecoder(nn.Module):
    """Self-attention token fusion + MLP head."""

    def __init__(self, num_tokens: int, embed_dim: int = 64, num_heads: int = 4, num_layers: int = 2,
                 head_units: Sequence[int] = (256, 128, 64, 32)):
        super().__init__()
        e = embed_dim
        self.num_layers = num_layers
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, num_tokens, e))
        for i in range(num_layers):
            setattr(self, f"SelfAttention_{i}", SelfAttention(e, num_heads))
            setattr(self, f"LayerNorm_{2 * i}", nn.LayerNorm(e, eps=NORM_EPS))
            setattr(self, f"Dense_{2 * i}", nn.Linear(e, 4 * e))
            setattr(self, f"Dense_{2 * i + 1}", nn.Linear(4 * e, e))
            setattr(self, f"LayerNorm_{2 * i + 1}", nn.LayerNorm(e, eps=NORM_EPS))
        self.MLP_0 = FlaxMLP(num_tokens * e, head_units)

    def forward(self, tokens):  # [B, T, E]
        b, t, e = tokens.shape
        x = tokens + self.pos_embed
        for i in range(self.num_layers):
            attn = getattr(self, f"SelfAttention_{i}")(x)
            x = getattr(self, f"LayerNorm_{2 * i}")(x + attn)
            ff = F.gelu(getattr(self, f"Dense_{2 * i}")(x), approximate="tanh")
            x = getattr(self, f"LayerNorm_{2 * i + 1}")(x + getattr(self, f"Dense_{2 * i + 1}")(ff))
        return self.MLP_0(x.reshape(b, t * e))


class MultiModalModel(nn.Module):
    """Student: modality encoders → tokens → transformer → latent/action.

    Token order: obs, tactile (one per history frame), img, seg, pcl. The
    widths a flax module infers from its first input are constructor
    arguments here: `obs_dim`, the encoders' input channels and `num_tokens`."""

    def __init__(self, use_obs=True, use_tactile=False, use_img=False, use_seg=False, use_pcl=False,
                 tactile_encoder: str = "cnn", embed_dim: int = 64, latent_dim: int = 8,
                 bc_mode: bool = False, num_points: int = 400, num_points_socket: int = 400,
                 num_points_goal: int = 400, obs_dim: int = 15, tactile_channels: int = 9,
                 img_channels: int = 1, seg_channels: int = 2, num_tokens: int | None = None,
                 scene_points: bool = False):
        super().__init__()
        self.use_obs, self.use_tactile, self.use_img = use_obs, use_tactile, use_img
        self.use_seg, self.use_pcl, self.bc_mode = use_seg, use_pcl, bc_mode
        self.pcl_counts = (("plug", num_points), ("socket", num_points_socket), ("goal", num_points_goal))
        e = embed_dim
        if use_obs:
            self.obs_enc = FlaxMLP(obs_dim, [128, e])
        if use_tactile:
            enc = EfficientTactileEncoder if tactile_encoder == "efficientnet" else TactileCNN
            self.tactile_enc = enc(tactile_channels, e)
        if use_img:
            self.img_enc = DepthCNN(img_channels, e)
        if use_seg:
            self.seg_enc = DepthCNN(seg_channels, e)
        n_feats = 0
        if use_pcl:
            for name, count in self.pcl_counts:
                if count > 0:
                    setattr(self, f"pn_{name}", PointNet(e))
                    n_feats += 1
            if scene_points:
                self.pn_scene = PointNet(e)
                n_feats += 1
            self.pcl_compressor = nn.Linear(n_feats * e, e)
        if num_tokens is None:   # one history frame per image modality
            num_tokens = int(use_obs) + int(use_tactile) + int(use_img) + int(use_seg) + int(use_pcl)
        self.decoder = MultiLayerDecoder(num_tokens, e)
        self.latent_head = nn.Linear(32, latent_dim)

    def forward(self, obs=None, tactile=None, img=None, seg=None, pcl=None):
        tokens = []
        if self.use_obs and obs is not None:
            tokens.append(self.obs_enc(obs))
        if self.use_tactile and tactile is not None:
            tokens += [self.tactile_enc(tactile[:, i]) for i in range(tactile.shape[1])]
        if self.use_img and img is not None:
            tokens += [self.img_enc(img[:, i]) for i in range(img.shape[1])]
        if self.use_seg and seg is not None:
            tokens += [self.seg_enc(seg[:, i]) for i in range(seg.shape[1])]
        if self.use_pcl and pcl is not None:
            # positional slices [plug | socket | goal | scene]
            p = pcl[:, -1] if pcl.ndim == 4 else pcl
            ofs, feats = 0, []
            for name, count in self.pcl_counts:
                if count > 0 and ofs + count <= p.shape[1]:
                    feats.append(getattr(self, f"pn_{name}")(p[:, ofs:ofs + count]))
                    ofs += count
            if p.shape[1] > ofs:
                feats.append(self.pn_scene(p[:, ofs:]))
            tokens.append(self.pcl_compressor(torch.cat(feats, dim=-1)))
        h = self.decoder(torch.stack(tokens, dim=1))
        out = self.latent_head(h)
        return torch.tanh(out) if self.bc_mode else out


class TactileHead(nn.Module):
    """The tactile pose regressor of `algo/tactile_runner.py` (the
    reference's inline flax `Head`): `TactileCNN` → Dense 64 → ReLU → Dense
    `target_dim`, submodules named as flax names them."""

    def __init__(self, in_ch: int = 9, target_dim: int = 7):
        super().__init__()
        self.TactileCNN_0 = TactileCNN(in_ch, 64)
        self.Dense_0 = nn.Linear(64, 64)
        self.Dense_1 = nn.Linear(64, target_dim)

    def forward(self, x):  # [B, F, H, W, C]
        return self.Dense_1(F.relu(self.Dense_0(self.TactileCNN_0(x))))


# ------------------------------------------------------------------ conversion


def convert_flax_params(params) -> "OrderedDict[str, torch.Tensor]":
    """A flax parameter tree of any module of this file → the `state_dict()`
    of its PyTorch counterpart. Accepts the tree with or without its top-level
    "params" key.

    Dense `kernel` [in, out] → Linear `weight` [out, in]; Conv `kernel` HWIO →
    `weight` OIHW, a 1-D Conv's [K, I, O] → [O, I, K]; LayerNorm/GroupNorm
    `scale` → `weight`; attention projections (3-D kernels outside a `Conv_*`)
    and `pos_embed` keep the reference's shapes."""
    p = params.get("params", params)
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
    sd = OrderedDict()

    def walk(node, prefix):
        for name, val in node.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(val, dict):
                walk(val, path)
                continue
            a = t(val)
            weight = f"{prefix}.weight" if prefix else "weight"
            if name == "kernel" and a.ndim == 2:
                sd[weight] = a.T.contiguous()
            elif name == "kernel" and a.ndim == 4:
                sd[weight] = a.permute(3, 2, 0, 1).contiguous()
            elif name == "kernel" and a.ndim == 3 and prefix.split(".")[-1].startswith("Conv"):
                sd[weight] = a.permute(2, 1, 0).contiguous()
            elif name == "scale":
                sd[weight] = a
            else:   # bias, pos_embed, attention kernels [E, H, D] / [H, D, E]
                sd[path] = a
    walk(p, "")
    return sd


def student_to_jax_params(state_dict) -> dict:
    """The `state_dict()` of any module of this file (`MultiModalModel`,
    `TactileHead`, …) → the flax tree `{"params": {...}}` as float32 numpy
    arrays (the inverse of `convert_flax_params`; the layout of the
    reference's student and tactile-regressor checkpoints). Linear `weight`
    → `kernel` [in, out], Conv `weight` OIHW → `kernel` HWIO (a 1-D Conv's
    [O, I, K] → [K, I, O]), norm `weight` → `scale`; biases, attention
    kernels and `pos_embed` unchanged. Every leaf is a copy, never a view of
    a parameter."""
    tree: dict = {}
    for key, val in state_dict.items():
        a = np.array(val.detach().cpu(), np.float32)
        *path, name = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if name == "weight" and a.ndim == 2:
            node["kernel"] = np.ascontiguousarray(a.T)
        elif name == "weight" and a.ndim == 4:
            node["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif name == "weight" and a.ndim == 3:
            node["kernel"] = np.ascontiguousarray(a.transpose(2, 1, 0))
        elif name == "weight":
            node["scale"] = a
        else:
            node[name] = a
    return {"params": tree}


# flax's lecun_normal: a normal truncated at ±2 std, rescaled so that the
# truncated draw has variance 1 / fan_in (the std of a unit normal truncated
# at ±2 is 0.87962566103423978)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_student_like_flax(net: MultiModalModel, generator: torch.Generator) -> MultiModalModel:
    """Re-draw `net` as flax's defaults initialize the reference's student:
    Dense, Conv and attention kernels `lecun_normal` over their fan-in (a
    Conv's is in/groups · kh · kw, an attention projection's its contracted
    axes), zero biases, norms at scale 1 and bias 0, `pos_embed` normal(0.02)."""
    def lecun(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    for m in net.modules():
        if isinstance(m, nn.Linear):
            lecun(m.weight, m.in_features)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            lecun(m.weight, m.weight[0].numel())
        elif isinstance(m, _Projection):
            lecun(m.kernel, m.fan_in)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
        elif isinstance(m, MultiLayerDecoder):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
        if isinstance(getattr(m, "bias", None), torch.Tensor):
            nn.init.zeros_(m.bias)
    return net


def decoder_only_mask(net: MultiModalModel) -> dict:
    """Parameter name → trainable, for a phase-3 restore: everything but the
    token-fusion decoder and the latent head stays frozen."""
    return {name: ("decoder" in name) or ("latent_head" in name) for name, _ in net.named_parameters()}


def _shape(p, *path):
    for k in path:
        p = p[k]
    return np.asarray(p).shape


def student_from_jax_params(tree, da_cfg, env_cfg, device=None) -> MultiModalModel:
    """An eval-mode `MultiModalModel` built for `da_cfg`'s modalities and
    `env_cfg`'s point counts, sized from and loaded with a flax
    `student_params` tree (numpy leaves)."""
    p = tree.get("params", tree)
    kw = {}
    if da_cfg.use_obs:
        kw["obs_dim"] = _shape(p, "obs_enc", "Dense_0", "kernel")[0]
    if da_cfg.use_tactile:
        eff = "MBConv_0" in p["tactile_enc"]
        kw["tactile_encoder"] = "efficientnet" if eff else "cnn"
        kw["tactile_channels"] = _shape(p, "tactile_enc", "Conv_0", "kernel")[2]
    if da_cfg.use_img:
        kw["img_channels"] = _shape(p, "img_enc", "Conv_0", "kernel")[2]
    if da_cfg.use_seg:
        kw["seg_channels"] = _shape(p, "seg_enc", "Conv_0", "kernel")[2]
    e = env_cfg
    net = MultiModalModel(
        use_obs=da_cfg.use_obs, use_tactile=da_cfg.use_tactile, use_img=da_cfg.use_img,
        use_seg=da_cfg.use_seg, use_pcl=da_cfg.use_pcl,
        latent_dim=_shape(p, "latent_head", "kernel")[1], bc_mode=da_cfg.only_bc,
        num_points=e.num_points if e.include_plug_pcl else 0,
        num_points_socket=e.num_points_socket if e.merge_socket_pcl else 0,
        num_points_goal=e.num_points_goal if e.merge_goal_pcl else 0,
        num_tokens=_shape(p, "decoder", "pos_embed")[1], scene_points="pn_scene" in p, **kw)
    net.load_state_dict(convert_flax_params(p))
    return net.to(device).eval()


def tactile_head_from_jax_params(tree, device=None) -> TactileHead:
    """A `TactileHead` sized from and loaded with the reference regressor's
    flax tree (`TactileCNN_0`, `Dense_0`, `Dense_1`; with or without its
    top-level "params" key). `student_to_jax_params` is the inverse."""
    p = tree.get("params", tree)
    net = TactileHead(in_ch=_shape(p, "TactileCNN_0", "Conv_0", "kernel")[2],
                      target_dim=_shape(p, "Dense_1", "kernel")[1])
    net.load_state_dict(convert_flax_params(p))
    return net.to(device)
