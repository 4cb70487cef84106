"""Batched articulated rigid-body dynamics (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/physics/dynamics.py`: Jacobian-based CRBA

  M(q)      = Σ_b J_bᵀ S_b J_b
  C(q, qd)  = Σ_b J_bᵀ (S_b A_bias_b + v_b ×* S_b v_b) − J_gᵀ m g

where A_bias = d/dt (J qd) with qdd = 0. The reference gets J̇ from one
forward-mode pass (`jax.jvp`) through FK; here the same tangents come from
the velocity recursion of `kinematics.forward_kinematics_rates`, which is
exact and far cheaper in eager PyTorch than dual-number forward mode.
"""

from __future__ import annotations

import torch

from ..ops import const
from ..ops.linalg import chol_solve_small
from ..ops.rotations import quat_to_matrix
from .kinematics import (
    FK,
    all_com_jacobians,
    all_com_jacobians_rate,
    forward_kinematics,
    forward_kinematics_rates,
)
from .robot import RobotModel


def _world_inertia(model: RobotModel, fk: FK) -> torch.Tensor:
    """Rotational inertia of each body about its com, world frame [..., nb, 3, 3]."""
    R = quat_to_matrix(fk.body_q)
    I_local = const(model.inertia, R.device, R.dtype)
    return (R @ I_local) @ R.transpose(-1, -2)


def mass_matrix(model: RobotModel, q: torch.Tensor, fk: FK | None = None,
                J: torch.Tensor | None = None) -> torch.Tensor:
    """Joint-space mass matrix [..., nd, nd] (+ armature on the diagonal)."""
    fk = forward_kinematics(model, q) if fk is None else fk
    J = all_com_jacobians(model, fk) if J is None else J
    Jv, Jw = J[..., :3, :], J[..., 3:, :]
    m = const(model.mass, q.device, q.dtype)
    Iw = _world_inertia(model, fk)
    # Σ_b m_b Jv_bᵀ Jv_b + Σ_b Jw_bᵀ I_b Jw_b, as one [..., nd, 3·nb] product each
    flat = lambda x: x.reshape(x.shape[:-3] + (-1, x.shape[-1]))
    M = (flat(Jv).transpose(-1, -2) @ flat(Jv * m[:, None, None])
         + flat(Jw).transpose(-1, -2) @ flat(Iw @ Jw))
    return M + torch.diag(const(model.armature, q.device, q.dtype))


def fk_jacobians_with_tangents(model: RobotModel, q: torch.Tensor, qd: torch.Tensor):
    """(fk, J) and their time derivatives at joint velocities qd."""
    fk = forward_kinematics(model, q)
    fk_dot = forward_kinematics_rates(model, fk, qd)
    return fk, all_com_jacobians(model, fk), fk_dot, all_com_jacobians_rate(model, fk, fk_dot)


def bias_forces(model: RobotModel, q: torch.Tensor, qd: torch.Tensor, gravity=0.0,
                fk: FK | None = None, J: torch.Tensor | None = None,
                J_dot: torch.Tensor | None = None) -> torch.Tensor:
    """Generalized bias forces C(q, qd) [..., nd] such that M qdd + C = tau.
    `gravity` is the world z acceleration applied to the robot's links."""
    fk = forward_kinematics(model, q) if fk is None else fk
    J = all_com_jacobians(model, fk) if J is None else J
    m = const(model.mass, q.device, q.dtype)
    Iw = _world_inertia(model, fk)

    if J_dot is None:
        J_dot = all_com_jacobians_rate(model, fk, forward_kinematics_rates(model, fk, qd))
    v = torch.einsum("...bij,...j->...bi", J, qd)
    a_bias = torch.einsum("...bij,...j->...bi", J_dot, qd)
    vlin, w = v[..., :3], v[..., 3:]
    alin, aw = a_bias[..., :3], a_bias[..., 3:]

    f = m[..., None] * alin
    Iww = torch.einsum("...bij,...bj->...bi", Iw, w)
    tau_b = torch.einsum("...bij,...bj->...bi", Iw, aw) + torch.linalg.cross(w, Iww)

    g = torch.zeros_like(vlin)
    g[..., 2] = g[..., 2] + torch.as_tensor(gravity, dtype=q.dtype, device=q.device)
    f = f - m[..., None] * g

    wrench = torch.cat([f, tau_b], dim=-1)
    return torch.einsum("...bik,...bi->...k", J, wrench)


def implicit_pd_step(model: RobotModel, q, qd, q_target, kp, kd, tau_ext, h: float, M, C,
                     torque_mode_mask=None, tau_cmd=None):
    """One semi-implicit substep with implicitly damped joint PD.

    Solves (M + h diag(kd + d_joint)) qd' = M qd + h (tau_drive + tau_ext - C),
    tau_drive = clip(kp (q_t - q) - kd qd, ±effort) in PD mode or the
    commanded torque in torque mode. Returns (q', qd', applied_drive_torque).
    """
    dev, dt = q.device, q.dtype
    effort = const(model.effort_limit, dev, dt)
    drive_pd = torch.clamp(kp * (q_target - q) - kd * qd, -effort, effort)
    if torque_mode_mask is not None and tau_cmd is not None:
        tmask = torque_mode_mask != 0
        drive = torch.where(tmask, torch.clamp(tau_cmd, -effort, effort), drive_pd)
        kd_eff = torch.where(tmask, torch.zeros_like(kd), kd)
    else:
        drive = drive_pd
        kd_eff = kd
    d = const(model.damping, dev, dt)
    nd = q.shape[-1]
    lhs = M + h * torch.eye(nd, dtype=dt, device=dev) * (kd_eff + d)[..., None, :]
    rhs = torch.einsum("...ij,...j->...i", M, qd) + h * (drive + tau_ext - C)
    qd_new = chol_solve_small(lhs, rhs)
    vlim = const(model.velocity_limit, dev, dt)
    qd_new = torch.clamp(qd_new, -vlim, vlim)
    q_new = q + h * qd_new
    q_new = torch.clamp(q_new, const(model.dof_lower, dev, dt), const(model.dof_upper, dev, dt))
    return q_new, qd_new, drive
