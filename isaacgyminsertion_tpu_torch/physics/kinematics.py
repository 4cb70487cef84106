"""Batched forward kinematics and Jacobians for the fixed-base tree (PyTorch).

Port of `isaacgyminsertion_tpu/physics/kinematics.py`. The tree is static, so
FK is a Python walk over the 15 bodies; every step is batched over the env
axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import const
from ..ops import rotations as rot
from .robot import RobotModel

_IDENT_Q = (0.0, 0.0, 0.0, 1.0)


class FK(NamedTuple):
    """World-frame kinematics of every body/joint (leading batch dims allowed)."""

    body_q: torch.Tensor       # [..., nd, 4] body (joint frame) orientation
    body_t: torch.Tensor       # [..., nd, 3] joint frame origin
    joint_axis_w: torch.Tensor  # [..., nd, 3] world-frame joint axis
    com_w: torch.Tensor        # [..., nd, 3] world-frame body com


def forward_kinematics(model: RobotModel, q: torch.Tensor) -> FK:
    """FK over the static tree (serial chain walk). q: [..., nd]."""
    nd = model.parent.shape[0]
    batch = q.shape[:-1]
    dev, dt = q.device, q.dtype
    ident_q = const(_IDENT_Q, dev, dt).expand(batch + (4,))
    zero_t = torch.zeros(batch + (3,), dtype=dt, device=dev)
    joint_q = const(model.joint_q, dev, dt)
    joint_t = const(model.joint_t, dev, dt)
    axes = const(model.axis, dev, dt)

    body_q, body_t = [], []
    for i in range(nd):
        p = int(model.parent[i])
        pq, pt = (ident_q, zero_t) if p < 0 else (body_q[p], body_t[p])
        fq, ft = rot.tf_combine(pq, pt, joint_q[i].expand(batch + (4,)),
                                joint_t[i].expand(batch + (3,)))
        qj = rot.quat_from_angle_axis(q[..., i], axes[i].expand(batch + (3,)))
        body_q.append(rot.quat_mul(fq, qj))
        body_t.append(ft)

    body_q = torch.stack(body_q, dim=-2)
    body_t = torch.stack(body_t, dim=-2)
    axis_w = rot.quat_apply(body_q, axes)
    com_w = body_t + rot.quat_apply(body_q, const(model.com, dev, dt))
    return FK(body_q=body_q, body_t=body_t, joint_axis_w=axis_w, com_w=com_w)



def forward_kinematics_jump(model: RobotModel, q: torch.Tensor) -> FK:
    """FK by pointer jumping (a parallel prefix over the static tree): every
    body composes its parent's accumulated transform in ceil(log2(depth))
    batched rounds over all bodies at once. The reference keeps it as the
    documented alternative to the serial walk; nothing here calls it."""
    nd = model.parent.shape[0]
    batch = q.shape[:-1]
    dev, dt = q.device, q.dtype
    axes = const(model.axis, dev, dt)
    qj = rot.quat_from_angle_axis(q, axes.expand(batch + (nd, 3)))
    lq = rot.quat_mul(const(model.joint_q, dev, dt).expand(batch + (nd, 4)), qj)
    lt = const(model.joint_t, dev, dt).expand(batch + (nd, 3))

    parent = np.asarray(model.parent).copy()          # static jump pointers
    Q, T = lq, lt
    while (parent >= 0).any():
        idx = np.where(parent >= 0, parent, 0)
        has_parent = torch.as_tensor((parent >= 0)[:, None], device=dev)
        cq, ct = rot.tf_combine(Q[..., idx, :], T[..., idx, :], Q, T)
        Q = torch.where(has_parent, cq, Q)
        T = torch.where(has_parent, ct, T)
        parent = np.where(parent >= 0, parent[idx], -1)   # P_i ← P_{P_i}

    axis_w = rot.quat_apply(Q, axes)
    com_w = T + rot.quat_apply(Q, const(model.com, dev, dt))
    return FK(body_q=Q, body_t=T, joint_axis_w=axis_w, com_w=com_w)


def forward_kinematics_rates(model: RobotModel, fk: FK, qd: torch.Tensor) -> FK:
    """Time derivative of every FK field at joint velocities qd.

    The reference differentiates FK in forward mode (`jax.jvp`); here the
    same tangents come from the velocity recursion over the tree:
      ω_i = ω_parent + a_i q̇_i                (a_i: world joint axis)
      ṫ_i = ṫ_parent + ω_parent × (t_i − t_parent)
      ȧ_i = ω_i × a_i,   ċ_i = ṫ_i + ω_i × (c_i − t_i)
      q̇_i = ½ [ω_i, 0] ⊗ q_i
    """
    nd = model.parent.shape[0]
    zero = torch.zeros_like(fk.body_t[..., 0, :])
    omega, tdot = [], []
    for i in range(nd):
        p = int(model.parent[i])
        wp, tp_dot = (zero, zero) if p < 0 else (omega[p], tdot[p])
        tp = zero if p < 0 else fk.body_t[..., p, :]
        omega.append(wp + fk.joint_axis_w[..., i, :] * qd[..., i:i + 1])
        tdot.append(tp_dot + torch.linalg.cross(wp, fk.body_t[..., i, :] - tp))
    omega = torch.stack(omega, dim=-2)
    t_dot = torch.stack(tdot, dim=-2)
    axis_dot = torch.linalg.cross(omega, fk.joint_axis_w)
    com_dot = t_dot + torch.linalg.cross(omega, fk.com_w - fk.body_t)
    q_dot = 0.5 * rot.quat_mul(torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1),
                               fk.body_q)
    return FK(body_q=q_dot, body_t=t_dot, joint_axis_w=axis_dot, com_w=com_dot)


def site_pose(model: RobotModel, fk: FK, site: int):
    """World pose (quat, pos) of a named site frame."""
    b = int(model.site_body[site])
    dev, dt = fk.body_q.device, fk.body_q.dtype
    sq = const(model.site_q, dev, dt)[site]
    st = const(model.site_t, dev, dt)[site]
    return rot.tf_combine(fk.body_q[..., b, :], fk.body_t[..., b, :], sq, st)


def point_jacobian(model: RobotModel, fk: FK, point_w: torch.Tensor, body: int) -> torch.Tensor:
    """Geometric Jacobian [..., 6, nd] of a world point rigidly attached to
    `body`; rows [linear; angular]."""
    mask = const(model.ancestor_mask, point_w.device, point_w.dtype)[body]  # [nd]
    r = point_w[..., None, :] - fk.body_t                                    # [..., nd, 3]
    lin = torch.linalg.cross(fk.joint_axis_w, r) * mask[..., None]
    ang = fk.joint_axis_w * mask[..., None]
    return torch.cat([lin, ang], dim=-1).transpose(-1, -2)


def all_com_jacobians(model: RobotModel, fk: FK) -> torch.Tensor:
    """Body-com Jacobians for every body: [..., nb, 6, nd]."""
    mask = const(model.ancestor_mask, fk.body_t.device, fk.body_t.dtype)  # [nb, nd]
    r = fk.com_w[..., :, None, :] - fk.body_t[..., None, :, :]            # [..., nb, nd, 3]
    axes = fk.joint_axis_w[..., None, :, :].expand(r.shape)
    lin = torch.linalg.cross(axes, r) * mask[..., None]
    ang = axes * mask[..., None]
    return torch.cat([lin, ang], dim=-1).transpose(-1, -2)


def all_com_jacobians_rate(model: RobotModel, fk: FK, fk_dot: FK) -> torch.Tensor:
    """Time derivative of `all_com_jacobians`: [..., nb, 6, nd]."""
    mask = const(model.ancestor_mask, fk.body_t.device, fk.body_t.dtype)
    r = fk.com_w[..., :, None, :] - fk.body_t[..., None, :, :]
    r_dot = fk_dot.com_w[..., :, None, :] - fk_dot.body_t[..., None, :, :]
    axes = fk.joint_axis_w[..., None, :, :].expand(r.shape)
    axes_dot = fk_dot.joint_axis_w[..., None, :, :].expand(r.shape)
    lin = (torch.linalg.cross(axes_dot, r) + torch.linalg.cross(axes, r_dot)) * mask[..., None]
    ang = axes_dot * mask[..., None]
    return torch.cat([lin, ang], dim=-1).transpose(-1, -2)

