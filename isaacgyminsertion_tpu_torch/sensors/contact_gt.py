"""Privileged extrinsic-contact ground truth (PyTorch).

Port of `isaacgyminsertion_tpu/sensors/contact_gt.py`: the plug's dense
surface samples are moved by the plug pose into the socket frame, |SDF| of the
socket is evaluated there, and the upstream post-processing is applied:

  d = clip(dist, 0, threshold); d = 1 − d/threshold; d[d > 0.1] = 1
  then a uniform(0, 0.1) fraction of the active contacts is zeroed at random.

Output: [N, P] contact vector in [0, 1]. Runs on coordinate planes like the
reference, so the two compare term by term.
"""

from __future__ import annotations

import torch

from ..assets import SOCKET_PLATE_HX, SOCKET_PLATE_HY
from ..ops import rotations as rot
from ..ops import sdf as sdfm


def extrinsic_contact(
    dense_points: torch.Tensor,   # [N, P, 3] plug-frame surface samples
    plug_q: torch.Tensor,         # [N, 4]
    plug_pos: torch.Tensor,       # [N, 3]
    socket_q: torch.Tensor,
    socket_pos: torch.Tensor,
    kind_onehot: torch.Tensor,
    hole_hx: torch.Tensor,
    hole_hy: torch.Tensor,
    socket_height: torch.Tensor,
    generator: torch.Generator | None,
    threshold: float = 0.002,
) -> torch.Tensor:
    """`generator=None` skips the random dropout (deterministic output)."""
    lx, ly, lz = dense_points[..., 0], dense_points[..., 1], dense_points[..., 2]
    Rp = rot.quat_to_matrix(plug_q)
    Rs = rot.quat_to_matrix(socket_q)
    rp = lambda i, j: Rp[..., i, j][..., None]
    rs = lambda i, j: Rs[..., i, j][..., None]
    col = lambda v, i: v[..., i][..., None]

    wx = rp(0, 0) * lx + rp(0, 1) * ly + rp(0, 2) * lz + col(plug_pos, 0)
    wy = rp(1, 0) * lx + rp(1, 1) * ly + rp(1, 2) * lz + col(plug_pos, 1)
    wz = rp(2, 0) * lx + rp(2, 1) * ly + rp(2, 2) * lz + col(plug_pos, 2)
    dxw = wx - col(socket_pos, 0)
    dyw = wy - col(socket_pos, 1)
    dzw = wz - col(socket_pos, 2)
    # socket frame: p_s = Rsᵀ (w − t_s)
    sx = rs(0, 0) * dxw + rs(1, 0) * dyw + rs(2, 0) * dzw
    sy = rs(0, 1) * dxw + rs(1, 1) * dyw + rs(2, 1) * dzw
    sz = rs(0, 2) * dxw + rs(1, 2) * dyw + rs(2, 2) * dzw

    oh = tuple(kind_onehot[..., k][..., None] for k in range(kind_onehot.shape[-1]))
    dist = torch.abs(sdfm.socket_sdf_planes(
        sx, sy, sz, oh, hole_hx[:, None], hole_hy[:, None], socket_height[:, None],
        float(SOCKET_PLATE_HX), float(SOCKET_PLATE_HY)))
    d = 1.0 - torch.clamp(dist, 0.0, threshold) / threshold
    d = torch.where(d > 0.1, torch.ones_like(d), d)
    if generator is None:
        return d
    # random dropout of a uniform(0, 0.1) fraction of the active contacts
    dev = d.device
    frac = torch.rand((d.shape[0], 1), generator=generator, device=dev) * 0.1
    drop = torch.rand(d.shape, generator=generator, device=dev) < frac
    return torch.where((d == 1.0) & drop, torch.zeros_like(d), d)
