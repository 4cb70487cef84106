"""The visuotactile student `MultiModalModel` (upstream
`algo/models/transformer/tact.py:214-552`): an obs token, a tactile token, a
segmentation token and a point-cloud token, fused by `multimodal`'s decoder
and head into a latent that drives the frozen teacher's actor.

  - tactile (`TactileCNN`): the fingers' RGB frames stacked as channels in
    (finger, channel) order, three 3×3 stride-2 convolutions with ReLU, a
    spatial soft-argmax (the expected x and y of each channel), a Dense
    layer; one token per history frame;
  - segmentation (`DepthCNN`): the last frame's {plug, socket} masks as two
    channels, four 3×3 stride-2 convolutions with ReLU, flattened in (H, W,
    C) order, a Dense layer and ReLU;
  - obs, PointNets, compressor, decoder and head: `multimodal`'s parts.

Tokens go in the port's order: obs, tactile, seg, pcl. A convolution is
written as explicit SAME padding, `F.unfold` and a matmul, so no convolution
routine of the library computes it. The soft-argmax is a softmax over each
channel's pixels and its two expected coordinates on `linspace(-1, 1)`.

Where this departs from upstream `tact.py` (the choices of the repo's JAX
package, which the port follows): the padding is flax's SAME (the odd pixel
after: 64→32 pads (0, 1), 27→14 pads (1, 1)); the three fingers share one
CNN over 9 channels; the soft-argmax has temperature 1 and no learned
parameter; the decoder's positional embedding is learned, its LayerNorms
post-norm with ε 1e-6, its feed-forward tanh-GELU, with no dropout; the
frames reach the network as the env renders them, without upstream's image
transforms (`runner.py:150-192`); the latent loss is off (upstream's term is
commented out, `ext_adapt.py:828-830`).
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from . import actor_critic_split, dense
from . import multimodal as mm

TACTILE = "tactile_enc"
SEG = "seg_enc"


# ------------------------------------------------------------------ convolutions

def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """(before, after) of flax's SAME padding of one axis: out = ceil(size /
    stride), the odd pixel after."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x, weight, bias, stride: int):
    """A SAME convolution of [B, C, H, W] with an OIHW kernel, as padding,
    im2col (`F.unfold`) and one matmul."""
    b, _, h, w = x.shape
    o, _, k, _ = weight.shape
    (top, bottom), (left, right) = same_pads(h, k, stride), same_pads(w, k, stride)
    cols = F.unfold(F.pad(x, (left, right, top, bottom)), k, stride=stride)   # [B, C·k·k, L]
    out = weight.reshape(o, -1) @ cols
    return out.reshape(b, o, math.ceil(h / stride), math.ceil(w / stride)) + bias[:, None, None]


def conv_out(size: tuple, n: int, stride: int = 2) -> tuple:
    """(H, W) after `n` stride-`stride` SAME convolutions."""
    h, w = size
    for _ in range(n):
        h, w = math.ceil(h / stride), math.ceil(w / stride)
    return h, w


def conv_stack_shapes(prefix: str, in_ch: int, units) -> list:
    out, c = [], in_ch
    for i, u in enumerate(units):
        out += [(f"{prefix}.Conv_{i}.weight", (u, c, 3, 3), c * 9), (f"{prefix}.Conv_{i}.bias", (u,), 0)]
        c = u
    return out


def conv_stack_ops(in_ch: int, size: tuple, units) -> list:
    """Each convolution as its im2col matmul: (output pixels × C·9 × O); the
    first one's input is data and needs no gradient."""
    out, c, hw = [], in_ch, tuple(size)
    for i, u in enumerate(units):
        hw = conv_out(hw, 1)
        out.append((hw[0] * hw[1] * c * 9 * u, i > 0, True))
        c = u
    return out


def conv_stack(w: dict, prefix: str, x, n: int):
    for i in range(n):
        x = F.relu(conv_same(x, w[f"{prefix}.Conv_{i}.weight"], w[f"{prefix}.Conv_{i}.bias"], 2))
    return x


# ------------------------------------------------------------------ tactile token

def tactile_shapes(s: dict) -> list:
    last = s["tactile_units"][-1]
    return (conv_stack_shapes(TACTILE, s["tactile_channels"], s["tactile_units"])
            + [(f"{TACTILE}.Dense_0.weight", (s["embed_dim"], 2 * last), 2 * last),
               (f"{TACTILE}.Dense_0.bias", (s["embed_dim"],), 0)])


def softargmax_ops(s: dict) -> list:
    """The soft-argmax's two expected coordinates: a [C, H·W] × [H·W, 2]
    product of each sample (its input needs a gradient, the coordinates do not)."""
    h, w = conv_out(s["tactile_frames"][1:3], len(s["tactile_units"]))
    return [(s["tactile_units"][-1] * h * w * 2, True, False)]


def tactile_ops(s: dict) -> list:
    one = (conv_stack_ops(s["tactile_channels"], s["tactile_frames"][1:3], s["tactile_units"]) + softargmax_ops(s)
           + [(2 * s["tactile_units"][-1] * s["embed_dim"], True, True)])
    return one * s["tactile_history"]


def soft_argmax(x):
    """[B, C, H, W] → [B, 2C]: each channel's expected x, then each one's
    expected y, under a softmax over its pixels, on `linspace(-1, 1)`."""
    b, c, h, w = x.shape
    attn = torch.softmax(x.reshape(b, c, h * w), dim=-1)
    ys, xs = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=x.device),
                            torch.linspace(-1.0, 1.0, w, device=x.device), indexing="ij")
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)           # [H·W, 2]
    e = attn @ coords                                                         # [B, C, 2]
    return torch.cat([e[..., 0], e[..., 1]], dim=-1)


def tactile_token(w: dict, s: dict, frame):
    """One history frame [B, F, H, W, C] → [B, E]."""
    b, f, h, wd, c = frame.shape
    x = frame.permute(0, 1, 4, 2, 3).reshape(b, f * c, h, wd)
    x = conv_stack(w, TACTILE, x, len(s["tactile_units"]))
    return dense(w, f"{TACTILE}.Dense_0", soft_argmax(x))


# ------------------------------------------------------------------ segmentation token

def seg_flat(s: dict) -> int:
    h, w = conv_out(s["seg_size"], len(s["seg_units"]))
    return h * w * s["seg_units"][-1]


def seg_shapes(s: dict) -> list:
    return (conv_stack_shapes(SEG, s["seg_channels"], s["seg_units"])
            + [(f"{SEG}.Dense_0.weight", (s["embed_dim"], seg_flat(s)), seg_flat(s)),
               (f"{SEG}.Dense_0.bias", (s["embed_dim"],), 0)])


def seg_ops(s: dict) -> list:
    return (conv_stack_ops(s["seg_channels"], s["seg_size"], s["seg_units"])
            + [(seg_flat(s) * s["embed_dim"], True, True)])


def seg_token(w: dict, s: dict, masks):
    """The masks [B, H, W, 2] → [B, E]."""
    x = conv_stack(w, SEG, masks.permute(0, 3, 1, 2), len(s["seg_units"]))
    return F.relu(dense(w, f"{SEG}.Dense_0", x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))


# ------------------------------------------------------------------ the kind

def _check(s: dict):
    if (not all(s[f"use_{m}"] for m in ("obs", "tactile", "seg", "pcl")) or s.get("use_img", False)
            or s.get("only_bc", False) or s.get("tactile_encoder", "cnn") != "cnn"):
        raise ValueError("the visuotactile student reads obs, tactile frames, segmentation and the point cloud "
                         "(no depth image), encodes touch with the CNN and drives the teacher by its latent")


def shapes(s: dict) -> list:
    _check(s)
    return (mm.obs_shapes(s) + tactile_shapes(s) + seg_shapes(s) + mm.pcl_shapes(s) + mm.decoder_shapes(s)
            + mm.head_shapes(s))


def ops(s: dict, cfg: dict) -> list:
    """The student's matmuls and its latent's path through the frozen teacher."""
    _check(s)
    return (mm.obs_ops(s) + tactile_ops(s) + seg_ops(s) + mm.pcl_ops(s) + mm.decoder_ops(s) + mm.head_ops(s)
            + actor_critic_split.injected_ops(cfg["teacher"]))


def forward(w: dict, s: dict, inputs: dict):
    """The latent [B, out_dim] of the normalized inputs: `obs` [B, D],
    `tactile` [B, T, F, H, W, C], `seg` [B, 1, H, W, 2], `pcl` [B, P, 3]."""
    _check(s)
    tactile = [tactile_token(w, s, inputs["tactile"][:, i]) for i in range(inputs["tactile"].shape[1])]
    seg = [seg_token(w, s, inputs["seg"][:, i]) for i in range(inputs["seg"].shape[1])]
    tokens = [mm.obs_token(w, s, inputs["obs"]), *tactile, *seg, mm.pcl_token(w, s, inputs["pcl"])]
    return mm.head(w, s, mm.decoder(w, s, tokens))


act = mm.act   # the latent through the teacher's actor, clipped to [-1, 1] (`inject`)
