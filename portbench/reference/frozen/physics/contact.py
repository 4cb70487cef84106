"""Batched contact generation against analytic SDFs (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/physics/contact.py`. Produces kinematic contact
data (point, normal, depth, other-body velocity) for the velocity-level
impulse solver; no forces are computed here.

Contact sources, fixed shapes per env:
  - plug surface sample points vs the socket SDF (socket frame);
  - the same points vs the table halfspace;
  - 3 fingertip gel pads vs the plug SDF, as 5-point patches.

Frame changes are written as scalar-broadcast multiply-adds over x/y/z
planes, in the reference's order; the SDF queries and their gradients use the
vector SDFs of `ops.sdf` on the stacked points.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import rotations as rot
from ..ops import sdf as sdfm
from .solver import ContactSet

FINGERTIP_RADIUS = 0.0145  # AllSight gel hemisphere radius
GEL_STIFFNESS = 3500.0     # N/m — ~10 N at the 3 mm working indentation
PATCH_POINTS = 5           # center + 4-point ring per gel pad
PATCH_RING_FRAC = 0.55     # ring offset as a fraction of the pad radius


class MaterialParams(NamedTuple):
    """Per-env friction coefficients (pair-combined, PhysX average-mode)."""

    mu_socket: torch.Tensor   # plug↔socket
    mu_table: torch.Tensor    # plug↔table
    mu_finger: torch.Tensor   # fingertip↔plug


def default_materials(dtype=torch.float32, device=None) -> MaterialParams:
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return MaterialParams(mu_socket=f(0.5), mu_table=f(0.3), mu_finger=f(0.99))


def _col(v, i):
    return v[..., i][..., None]


def _rot_planes(R, px, py, pz, transpose=False):
    """R @ p (or Rᵀ @ p) on [N, P] coordinate planes with [N, 1] entries."""
    e = (lambda i, j: _col(R[..., j, :], i)) if transpose else (lambda i, j: _col(R[..., i, :], j))
    return (e(0, 0) * px + e(0, 1) * py + e(0, 2) * pz,
            e(1, 0) * px + e(1, 1) * py + e(1, 2) * pz,
            e(2, 0) * px + e(2, 1) * py + e(2, 2) * pz)


def _unit_gradient(fn, px, py, pz):
    """(sdf, unit gradient planes) of a vector SDF evaluated on stacked planes."""
    d, g = sdfm.sdf_and_grad(fn, torch.stack([px, py, pz], dim=-1))
    gx, gy, gz = g.unbind(-1)
    gn = torch.sqrt(gx * gx + gy * gy + gz * gz).clamp_min(1e-9)
    return d, gx / gn, gy / gn, gz / gn


def plug_env_contacts(socket_points, socket_weights, table_points, table_weights, plug_q,
                      plug_pos, plug_com_w, socket_q, socket_pos, kind_onehot, hole_hx, hole_hy,
                      socket_height, table_height, mat: MaterialParams) -> ContactSet:
    """Socket-SDF + table contacts over their point subsets → [N, Ps+Pt]."""
    Rp = rot.quat_to_matrix(plug_q)
    Rs = rot.quat_to_matrix(socket_q)

    def to_world(pts):
        wx, wy, wz = _rot_planes(Rp, pts[..., 0], pts[..., 1], pts[..., 2])
        return wx + _col(plug_pos, 0), wy + _col(plug_pos, 1), wz + _col(plug_pos, 2)

    # ---- socket SDF (socket frame): p_s = Rsᵀ (w − t_s)
    wx, wy, wz = to_world(socket_points)
    sx, sy, sz = _rot_planes(Rs, wx - _col(socket_pos, 0), wy - _col(socket_pos, 1),
                             wz - _col(socket_pos, 2), transpose=True)
    from ..assets import SOCKET_PLATE_HX, SOCKET_PLATE_HY

    oh = kind_onehot[..., None, :]
    hx, hy, hgt = hole_hx[..., None], hole_hy[..., None], socket_height[..., None]

    def sock_sdf(p):
        return sdfm.socket_sdf(p, oh, hx, hy, hgt, torch.full_like(hx, SOCKET_PLATE_HX),
                               torch.full_like(hx, SOCKET_PLATE_HY))

    d_s, gx, gy, gz = _unit_gradient(sock_sdf, sx, sy, sz)
    nx, ny, nz = _rot_planes(Rs, gx, gy, gz)   # normal back to world: n_w = Rs n_local

    shape = d_s.shape
    zeros3 = torch.zeros(shape + (3,), dtype=d_s.dtype, device=d_s.device)
    cs_socket = ContactSet(
        r=torch.stack([wx - _col(plug_com_w, 0), wy - _col(plug_com_w, 1),
                       wz - _col(plug_com_w, 2)], dim=-1),
        n=torch.stack([nx, ny, nz], dim=-1),
        depth=-d_s,
        v_other=zeros3,
        mu=mat.mu_socket[..., None].expand(shape),
        weight=socket_weights.expand(shape),
        stiffness=torch.zeros(shape, dtype=d_s.dtype, device=d_s.device),
    )

    # ---- table halfspace z >= table_height
    tx, ty, tz = to_world(table_points)
    shape_t = tz.shape
    zero = torch.zeros(shape_t, dtype=tz.dtype, device=tz.device)
    cs_table = ContactSet(
        r=torch.stack([tx - _col(plug_com_w, 0), ty - _col(plug_com_w, 1),
                       tz - _col(plug_com_w, 2)], dim=-1),
        n=torch.stack([zero, zero, torch.ones_like(zero)], dim=-1),
        depth=table_height[..., None] - tz,
        v_other=torch.zeros(shape_t + (3,), dtype=tz.dtype, device=tz.device),
        mu=mat.mu_table[..., None].expand(shape_t),
        weight=table_weights.expand(shape_t),
        stiffness=zero,
    )
    return concat_contacts(cs_socket, cs_table)


class FingerContactAux(NamedTuple):
    contact_point: torch.Tensor  # [N, F, 3] world
    normal: torch.Tensor         # [N, F, 3] push-direction on the plug


def fingertip_plug_contacts(tip_pos, tip_vel, plug_q, plug_pos, plug_com_w, kind_onehot,
                            plug_hx, plug_hy, plug_length, mat: MaterialParams,
                            radius: float = FINGERTIP_RADIUS):
    """Gel-pad vs plug-SDF patch contacts → [N, F*PATCH_POINTS] contact set
    (finger-major order). Each pad contributes a center point and a tangent
    ring at PATCH_RING_FRAC·R, the gel stiffness split per point, so the patch
    resists roll/pitch slip torques a single point cannot."""
    F = tip_pos.shape[-2]
    oh = kind_onehot[..., None, :]
    hx, hy, ln = plug_hx[..., None], plug_hy[..., None], plug_length[..., None]

    def psdf(p):
        return sdfm.plug_sdf(p, oh, hx, hy, ln)

    Rp = rot.quat_to_matrix(plug_q)

    def query(points_w):
        # plug frame: p = Rpᵀ (w − t)
        px, py, pz = _rot_planes(Rp, points_w[..., 0] - _col(plug_pos, 0),
                                 points_w[..., 1] - _col(plug_pos, 1),
                                 points_w[..., 2] - _col(plug_pos, 2), transpose=True)
        d, gx, gy, gz = _unit_gradient(psdf, px, py, pz)
        return d, torch.stack(_rot_planes(Rp, gx, gy, gz), dim=-1)

    # pass 1: pad centers → contact normal → tangent basis of each pad
    _d_c, out_c = query(tip_pos)
    e_z = torch.zeros_like(out_c)
    e_z[..., 2] = 1.0
    e_x = torch.zeros_like(out_c)
    e_x[..., 0] = 1.0
    ref = torch.where(torch.abs(out_c[..., 2:3]) > 0.9, e_x, e_z)
    t1 = torch.linalg.cross(out_c, ref)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True).clamp_min(1e-9)
    t2 = torch.linalg.cross(out_c, t1)

    off = PATCH_RING_FRAC * radius
    offsets = torch.stack([torch.zeros_like(t1), off * t1, -off * t1, off * t2, -off * t2],
                          dim=-2)                                    # [N, F, P, 3]
    pts = tip_pos[..., None, :] + offsets
    pts_flat = pts.reshape(pts.shape[:-3] + (F * PATCH_POINTS, 3))

    # pass 2: all patch points
    d, out_w = query(pts_flat)

    contact_pt = pts_flat - out_w * torch.minimum(d, torch.tensor(radius, dtype=d.dtype,
                                                                  device=d.device))[..., None]
    # ring points sit off-axis on the spherical pad: their indentation uses
    # the reduced effective radius sqrt(R² − off²)
    ring_r = radius * float(np.sqrt(1.0 - PATCH_RING_FRAC ** 2))
    radius_pt = torch.tensor([radius] + [ring_r] * (PATCH_POINTS - 1), dtype=d.dtype,
                             device=d.device).repeat(F)
    cs = ContactSet(
        r=contact_pt - plug_com_w[..., None, :],
        n=-out_w,                       # pad pushes the plug inward along −outward
        depth=radius_pt - d,
        v_other=torch.repeat_interleave(tip_vel, PATCH_POINTS, dim=-2),
        mu=mat.mu_finger[..., None].expand(d.shape),
        weight=torch.ones_like(d),
        stiffness=torch.full_like(d, GEL_STIFFNESS / PATCH_POINTS),
    )
    aux_pt = contact_pt.reshape(pts.shape)[..., 0, :]
    return cs, FingerContactAux(contact_point=aux_pt, normal=-out_c)


def concat_contacts(*sets: ContactSet) -> ContactSet:
    return ContactSet(*[torch.cat(parts, dim=-2 if parts[0].ndim >= 3 else -1)
                        for parts in zip(*sets)])
