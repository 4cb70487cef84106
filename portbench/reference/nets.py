"""The networks' forward passes on a dict of weights (the port's layout:
Linear weights [out, in]), written out from the layer equations."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F


def _dense(w: dict, name: str, x):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def _mlp(w: dict, prefix: str, x, n: int, act, layer="layers.{i}"):
    for i in range(n):
        x = act(_dense(w, f"{prefix}.{layer.format(i=i)}", x))
    return x


def actor_critic(w: dict, p: dict, obs, priv):
    """ActorCriticSplit: (mu, log_std, value, latent) of normalized inputs.
    Priv MLP → latent; actor and critic ELU MLPs over obs ⊕ latent; linear heads."""
    latent = _mlp(w, "priv_mlp", priv, len(p["priv_units"]), F.elu)
    x = torch.cat([obs, latent], dim=-1)
    a = _mlp(w, "actor_mlp", x, len(p["units"]), F.elu)
    c = _mlp(w, "critic_mlp", x, len(p["units"]), F.elu)
    return _dense(w, "mu", a), w["log_std"], _dense(w, "value", c)[..., 0], latent


def _layer_norm(w: dict, name: str, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps=1e-6)


def _attention(w: dict, name: str, x, heads: int):
    """Multi-head self-attention, kernels [E, H, D] and [H, D, E]; the query
    scaled by 1/sqrt(D) before the dot product."""
    b, t, e = x.shape
    d = e // heads
    proj = lambda p: (x.reshape(b * t, e) @ w[f"{name}.{p}.kernel"].reshape(e, heads * d)).reshape(b, t, heads, d) \
        + w[f"{name}.{p}.bias"]
    q = proj("query") * (1.0 / math.sqrt(d))
    k, v = proj("key"), proj("value")
    att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b * t, heads * d)
    return (o @ w[f"{name}.out.kernel"].reshape(heads * d, e)).reshape(b, t, e) + w[f"{name}.out.bias"]


def student(w: dict, s: dict, obs, pcl):
    """The obs + point-cloud MultiModalModel: an ELU obs token, a point-cloud
    token (a ReLU PointNet with a max-pool per object, then a linear
    compressor), a post-norm self-attention decoder with tanh-GELU
    feed-forward, the ELU head and a tanh action (bc mode)."""
    e, layers = s["embed_dim"], s["decoder_layers"]
    tokens = [_mlp(w, "obs_enc", obs, len(s["obs_units"]) + 1, F.elu, layer="Dense_{i}")]
    feats, ofs = [], 0
    for name, count in zip(("pn_plug", "pn_socket"), s["pcl_points"]):
        h = _mlp(w, name, pcl[:, ofs:ofs + count], len(s["pointnet_units"]) + 1, F.relu, layer="Dense_{i}")
        feats.append(torch.amax(h, dim=-2))
        ofs += count
    tokens.append(_dense(w, "pcl_compressor", torch.cat(feats, dim=-1)))
    x = torch.stack(tokens, dim=1) + w["decoder.pos_embed"]
    for i in range(layers):
        x = _layer_norm(w, f"decoder.LayerNorm_{2 * i}", x + _attention(w, f"decoder.SelfAttention_{i}", x,
                                                                        s["num_heads"]))
        ff = F.gelu(_dense(w, f"decoder.Dense_{2 * i}", x), approximate="tanh")
        x = _layer_norm(w, f"decoder.LayerNorm_{2 * i + 1}", x + _dense(w, f"decoder.Dense_{2 * i + 1}", ff))
    h = _mlp(w, "decoder.MLP_0", x.reshape(x.shape[0], -1), len(s["head_units"]), F.elu, layer="Dense_{i}")
    out = _dense(w, "latent_head", h)
    return torch.tanh(out) if s["bc_mode"] else out
