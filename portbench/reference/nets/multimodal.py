"""The student `MultiModalModel` with an obs token and a point-cloud token:
an ELU obs MLP; a ReLU PointNet with a max-pool per object, then a linear
compressor; a post-norm self-attention decoder with tanh-GELU feed-forward;
the ELU head and the output layer. With `only_bc` the output is a tanh
action, otherwise a latent injected into the frozen teacher's actor.

Each part gives its weight layout (`*_shapes`), its matmuls (`*_ops`) and
its forward, so that another kind of student composes them.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from . import actor_critic_split, dense, mlp, mlp_ops, mlp_shapes

PCL_NETS = ("pn_plug", "pn_socket")


# ------------------------------------------------------------------ obs token

def obs_shapes(s: dict) -> list:
    return mlp_shapes("obs_enc", s["obs_dim"], s["obs_units"] + [s["embed_dim"]], layer="Dense_{i}")


def obs_ops(s: dict) -> list:
    return mlp_ops(s["obs_dim"], s["obs_units"] + [s["embed_dim"]], False)


def obs_token(w: dict, s: dict, obs):
    return mlp(w, "obs_enc", obs, len(s["obs_units"]) + 1, F.elu, layer="Dense_{i}")


# ------------------------------------------------------------------ point-cloud token

def pcl_shapes(s: dict) -> list:
    e, n = s["embed_dim"], len(s["pcl_points"])
    out = []
    for name in PCL_NETS[:n]:
        out += mlp_shapes(name, 3, s["pointnet_units"] + [e], layer="Dense_{i}")
    return out + [("pcl_compressor.weight", (e, n * e), n * e), ("pcl_compressor.bias", (e,), 0)]


def pcl_ops(s: dict) -> list:
    e = s["embed_dim"]
    out = []
    for count in s["pcl_points"]:
        out += mlp_ops(3, s["pointnet_units"] + [e], False, rows=count)
    return out + [(len(s["pcl_points"]) * e * e, True, True)]


def pcl_token(w: dict, s: dict, pcl):
    """One PointNet per object over its slice of the merged cloud [B, P, 3]."""
    feats, ofs = [], 0
    for name, count in zip(PCL_NETS, s["pcl_points"]):
        h = mlp(w, name, pcl[:, ofs:ofs + count], len(s["pointnet_units"]) + 1, F.relu, layer="Dense_{i}")
        feats.append(torch.amax(h, dim=-2))
        ofs += count
    return dense(w, "pcl_compressor", torch.cat(feats, dim=-1))


# ------------------------------------------------------------------ decoder

def decoder_shapes(s: dict) -> list:
    """fan_in -1 marks a unit LayerNorm scale, -2 the positional embedding
    (0.02 std)."""
    e = s["embed_dim"]
    hd = (s["num_heads"], e // s["num_heads"])
    out = [("decoder.pos_embed", (1, s["num_tokens"], e), -2)]
    for i in range(s["decoder_layers"]):
        a = f"decoder.SelfAttention_{i}"
        for proj in ("query", "key", "value"):
            out += [(f"{a}.{proj}.kernel", (e, *hd), e), (f"{a}.{proj}.bias", hd, 0)]
        out += [(f"{a}.out.kernel", (*hd, e), e), (f"{a}.out.bias", (e,), 0)]
        for j, (shape, fan) in ((2 * i, ((4 * e, e), e)), (2 * i + 1, ((e, 4 * e), 4 * e))):
            out += [(f"decoder.LayerNorm_{j}.weight", (e,), -1), (f"decoder.LayerNorm_{j}.bias", (e,), 0),
                    (f"decoder.Dense_{j}.weight", shape, fan), (f"decoder.Dense_{j}.bias", (shape[0],), 0)]
    return out


def decoder_ops(s: dict) -> list:
    e, t = s["embed_dim"], s["num_tokens"]
    ops = []
    for _ in range(s["decoder_layers"]):
        ops += [(t * e * e, True, True)] * 3              # query, key, value projections
        ops += [(t * t * e, True, True)] * 2              # scores and the weighted sum
        ops.append((t * e * e, True, True))               # output projection
        ops += [(t * e * 4 * e, True, True), (t * 4 * e * e, True, True)]   # feed-forward
    return ops


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


def decoder(w: dict, s: dict, tokens: list):
    """The tokens [B, E] each, in the port's order, → the fused tokens [B, T, E]."""
    x = torch.stack(tokens, dim=1) + w["decoder.pos_embed"]
    for i in range(s["decoder_layers"]):
        x = _layer_norm(w, f"decoder.LayerNorm_{2 * i}", x + _attention(w, f"decoder.SelfAttention_{i}", x,
                                                                        s["num_heads"]))
        ff = F.gelu(dense(w, f"decoder.Dense_{2 * i}", x), approximate="tanh")
        x = _layer_norm(w, f"decoder.LayerNorm_{2 * i + 1}", x + dense(w, f"decoder.Dense_{2 * i + 1}", ff))
    return x


# ------------------------------------------------------------------ head

def head_shapes(s: dict) -> list:
    h = s["head_units"][-1]
    return (mlp_shapes("decoder.MLP_0", s["num_tokens"] * s["embed_dim"], s["head_units"], layer="Dense_{i}")
            + [("latent_head.weight", (s["out_dim"], h), h), ("latent_head.bias", (s["out_dim"],), 0)])


def head_ops(s: dict) -> list:
    return (mlp_ops(s["num_tokens"] * s["embed_dim"], s["head_units"], True)
            + [(s["head_units"][-1] * s["out_dim"], True, True)])


def head(w: dict, s: dict, x):
    """The ELU MLP over the flattened tokens, then the output layer (no activation)."""
    h = mlp(w, "decoder.MLP_0", x.reshape(x.shape[0], -1), len(s["head_units"]), F.elu, layer="Dense_{i}")
    return dense(w, "latent_head", h)


# ------------------------------------------------------------------ the kind

def shapes(s: dict) -> list:
    return ((obs_shapes(s) if s["use_obs"] else []) + (pcl_shapes(s) if s["use_pcl"] else [])
            + decoder_shapes(s) + head_shapes(s))


def ops(s: dict, cfg: dict) -> list:
    """With a latent output, the student's forward runs the frozen teacher too."""
    return ((obs_ops(s) if s["use_obs"] else []) + (pcl_ops(s) if s["use_pcl"] else []) + decoder_ops(s)
            + head_ops(s) + ([] if s["only_bc"] else actor_critic_split.injected_ops(cfg["teacher"])))


def forward(w: dict, s: dict, inputs: dict):
    tokens = []
    if s["use_obs"]:
        tokens.append(obs_token(w, s, inputs["obs"]))
    if s["use_pcl"]:
        tokens.append(pcl_token(w, s, inputs["pcl"]))
    return head(w, s, decoder(w, s, tokens))


def act(out, s: dict, inject=None):
    return torch.tanh(out) if s["only_bc"] else inject(out)
