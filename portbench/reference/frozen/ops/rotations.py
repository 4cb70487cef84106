"""Batched rotation / rigid-transform math (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/ops/rotations.py`. Quaternions are **xyzw**
(IsaacGym convention). Every function broadcasts over leading batch dims.

The Hamilton product and the quaternion rotation are bilinear/quadratic forms
against constant structure tensors, as in the reference: one small matmul per
call instead of a dozen elementwise launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import const


def _quat_mul_tensor() -> np.ndarray:
    """M[i,j,k] with (a⊗b)_k = a_i b_j M[i,j,k] (xyzw Hamilton product)."""
    M = np.zeros((4, 4, 4), np.float32)
    x, y, z, w = 0, 1, 2, 3
    for i, j, k, s in [
        (w, x, x, 1), (x, w, x, 1), (y, z, x, 1), (z, y, x, -1),
        (w, y, y, 1), (x, z, y, -1), (y, w, y, 1), (z, x, y, 1),
        (w, z, z, 1), (x, y, z, 1), (y, x, z, -1), (z, w, z, 1),
        (w, w, w, 1), (x, x, w, -1), (y, y, w, -1), (z, z, w, -1),
    ]:
        M[i, j, k] += s
    return M.reshape(16, 4)


def _quat_rot_tensor() -> np.ndarray:
    """T[i,j,l,k] with (R(q) v)_k = q_i q_j v_l T[i,j,l,k] for unit q."""
    T = np.zeros((4, 4, 3, 3), np.float32)
    x, y, z, w = 0, 1, 2, 3
    # R = (w^2 - s.s) I + 2 s s^T + 2 w [s]_x   (s = xyz)
    for l in range(3):
        T[w, w, l, l] += 1.0
        for s_ in (x, y, z):
            T[s_, s_, l, l] -= 1.0
    for a in range(3):
        for b in range(3):
            T[a, b, b, a] += 2.0
    eps3 = np.zeros((3, 3, 3))
    eps3[0, 1, 2] = eps3[1, 2, 0] = eps3[2, 0, 1] = 1.0
    eps3[0, 2, 1] = eps3[2, 1, 0] = eps3[1, 0, 2] = -1.0
    for k in range(3):
        for a in range(3):
            for l in range(3):
                T[w, a, l, k] += 1.0 * eps3[k, a, l]
                T[a, w, l, k] += 1.0 * eps3[k, a, l]
    return T.reshape(48, 3)


_QMUL = _quat_mul_tensor()
_QROT = _quat_rot_tensor()


# ----------------------------------------------------------------------------- basics


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-9)


def quat_identity_like(x: torch.Tensor) -> torch.Tensor:
    q = torch.zeros(x.shape[:-1] + (4,), dtype=x.dtype, device=x.device)
    q[..., 3] = 1.0
    return q


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, xyzw layout (bilinear form)."""
    a, b = torch.broadcast_tensors(a, b)
    ab = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (16,))
    return ab @ const(_QMUL, a.device, a.dtype)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (quadratic form)."""
    batch = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    qb = q.expand(batch + (4,))
    vb = v.expand(batch + (3,))
    qq = (qb[..., :, None] * qb[..., None, :]).reshape(batch + (16,))
    x = (qq[..., :, None] * vb[..., None, :]).reshape(batch + (48,))
    return x @ const(_QROT, v.device, v.dtype)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_apply(quat_conjugate(q), v)


# ------------------------------------------------------------------- constructions


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_from_rotvec(rotvec: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    angle = torch.linalg.norm(rotvec, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < eps
    sinc_half = torch.where(small, 0.5 - angle * angle / 48.0,
                            torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([rotvec * sinc_half, torch.cos(half)], dim=-1)


def axis_angle_from_quat(q: torch.Tensor, eps: float = 1.0e-6) -> torch.Tensor:
    """Rotation vector (axis*angle) from quaternion (pytorch3d-style stable form)."""
    mag = torch.linalg.norm(q[..., :3], dim=-1)
    half_angle = torch.atan2(mag, q[..., 3])
    angle = 2.0 * half_angle
    big = torch.abs(angle) > eps
    sin_half_over_angle = torch.where(
        big, torch.sin(half_angle) / torch.where(big, angle, torch.ones_like(angle)),
        0.5 - angle * angle / 48.0,
    )
    return q[..., :3] / sin_half_over_angle[..., None]


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ euler -> quaternion (IsaacGym's quat_from_euler_xyz)."""
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def get_euler_xyz(q: torch.Tensor):
    """Quaternion -> (roll, pitch, yaw), each in [0, 2pi) like IsaacGym's."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(torch.abs(sinp) >= 1.0,
                        torch.copysign(torch.full_like(sinp, math.pi / 2.0), sinp),
                        torch.asin(sinp.clamp(-1.0, 1.0)))
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    two_pi = 2.0 * math.pi
    return roll % two_pi, pitch % two_pi, yaw % two_pi


def euler_xyz_signed(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> [..., 3] euler xyz wrapped to (-pi, pi] (degrasp check)."""
    e = torch.stack(get_euler_xyz(q), dim=-1)
    return torch.where(e > math.pi, e - 2.0 * math.pi, e)


# ---------------------------------------------------------------------- matrices


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion xyzw (branch-free, stable)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    qw_w = safe_sqrt(tw) / 2.0
    q_w = torch.stack([(m21 - m12) / (4 * qw_w), (m02 - m20) / (4 * qw_w),
                       (m10 - m01) / (4 * qw_w), qw_w], dim=-1)
    qx_x = safe_sqrt(tx) / 2.0
    q_x = torch.stack([qx_x, (m01 + m10) / (4 * qx_x), (m02 + m20) / (4 * qx_x),
                       (m21 - m12) / (4 * qx_x)], dim=-1)
    qy_y = safe_sqrt(ty) / 2.0
    q_y = torch.stack([(m01 + m10) / (4 * qy_y), qy_y, (m12 + m21) / (4 * qy_y),
                       (m02 - m20) / (4 * qy_y)], dim=-1)
    qz_z = safe_sqrt(tz) / 2.0
    q_z = torch.stack([(m02 + m20) / (4 * qz_z), (m12 + m21) / (4 * qz_z), qz_z,
                       (m10 - m01) / (4 * qz_z)], dim=-1)
    t = torch.stack([tx, ty, tz, tw], dim=-1)
    idx = torch.argmax(t, dim=-1)
    cands = torch.stack([q_x, q_y, q_z, q_w], dim=-2)  # [..., 4, 4]
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4))).squeeze(-2)
    return quat_unit(q)


def quat_to_rot6d(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 6d rotation rep (first two rows of R, row-major)."""
    return quat_to_matrix(q)[..., :2, :].reshape(q.shape[:-1] + (6,))


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-9)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp_min(1e-9)
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-2)


def rot6d_to_quat(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(rot6d_to_matrix(d6))


# --------------------------------------------------------------------- transforms


def tf_inverse(q: torch.Tensor, t: torch.Tensor):
    q_inv = quat_conjugate(q)
    return q_inv, -quat_apply(q_inv, t)


def tf_apply(q: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_apply(q, v) + t


def tf_combine(q1, t1, q2, t2):
    """Compose transforms: (q1,t1) ∘ (q2,t2)."""
    return quat_mul(q1, q2), quat_apply(q1, t2) + t1


def translate_along_local_z(pos: torch.Tensor, quat: torch.Tensor, offset) -> torch.Tensor:
    """Translate a position along body-local z by `offset` ([...] or scalar)."""
    off = torch.as_tensor(offset, dtype=pos.dtype, device=pos.device)
    if off.ndim and off.shape[-1:] == (1,):
        off = off[..., 0]
    z = torch.zeros_like(pos)
    z[..., 2] = 1.0
    return pos + quat_apply(quat, z * off[..., None] if off.ndim < pos.ndim else z * off)


def quat_diff_rad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = quat_mul(a, quat_conjugate(b))
    return 2.0 * torch.asin(torch.linalg.norm(d[..., :3], dim=-1).clamp(max=1.0))


# ------------------------------------------------------------------------ random


def random_quat(generator: torch.Generator, shape: tuple = (), device=None) -> torch.Tensor:
    """Uniform random quaternions (Shoemake)."""
    u = torch.rand(tuple(shape) + (3,), generator=generator, device=device)
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    tau = 2.0 * math.pi
    return torch.stack(
        [
            torch.sqrt(1 - u0) * torch.sin(tau * u1),
            torch.sqrt(1 - u0) * torch.cos(tau * u1),
            torch.sqrt(u0) * torch.sin(tau * u2),
            torch.sqrt(u0) * torch.cos(tau * u2),
        ],
        dim=-1,
    )
