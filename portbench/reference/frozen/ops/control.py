"""Task/joint-space control math (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/ops/control.py` (parity with the reference's
factory_control.py): all eight controller modes as batched functions
producing either PD position targets (`gym_default`, `joint_space_ik`) or
commanded torques (the six torque modes). Rows: arm = dofs 0:7, gripper =
dofs 7:15; the gripper is always position-PD; torques are clamped at ±100.
"""

from __future__ import annotations

import torch

from . import rotations as rot
from .linalg import chol_solve_small

TORQUE_CLAMP = 100.0
NUM_ARM = 7


def _t(vals, like):
    return torch.as_tensor(vals, dtype=like.dtype, device=like.device)


def get_pose_error(pos, quat, target_pos, target_quat, rot_error_type: str = "axis_angle"):
    """Pose error target ⊖ current: position error + quaternion difference
    (as a quaternion, or as axis-angle)."""
    pos_error = target_pos - pos
    quat_dot = torch.sum(quat * target_quat, dim=-1, keepdim=True)
    tq = torch.where(quat_dot < 0.0, -target_quat, target_quat)   # shortest path
    quat_error = rot.quat_mul(tq, rot.quat_conjugate(quat))
    if rot_error_type == "quat":
        return pos_error, quat_error
    return pos_error, rot.axis_angle_from_quat(quat_error)


def _get_delta_dof_pos(delta_pose, jacobian, ik_method: str = "dls", lambda_val: float = 0.1):
    """IK Δq from Δpose [..., 6] and jacobian [..., 6, 7]."""
    if ik_method == "pinv":
        return torch.einsum("...ij,...j->...i", torch.linalg.pinv(jacobian), delta_pose)
    if ik_method == "trans":
        return torch.einsum("...ji,...j->...i", jacobian, delta_pose)
    if ik_method == "dls":
        A = torch.einsum("...ik,...jk->...ij", jacobian, jacobian)   # J Jᵀ [..., 6, 6]
        A = A + (lambda_val ** 2) * torch.eye(6, dtype=jacobian.dtype, device=jacobian.device)
        u = chol_solve_small(A, delta_pose)                          # SPD: J Jᵀ + λ²I
        return torch.einsum("...ij,...j->...i", jacobian.transpose(-1, -2), u)
    if ik_method == "svd":
        min_singular_value = 1.0e-5
        U, S, Vh = torch.linalg.svd(jacobian, full_matrices=False)
        S_inv = torch.where(S > min_singular_value,
                            1.0 / torch.clamp_min(S, min_singular_value), torch.zeros_like(S))
        J_pinv = torch.einsum("...ji,...j,...kj->...ik", Vh, S_inv, U)
        return torch.einsum("...ij,...j->...i", J_pinv, delta_pose)
    raise ValueError(f"unknown ik_method {ik_method}")


def compute_dof_pos_target(arm_dof_pos, fingertip_pos, fingertip_quat, jacobian,
                           ctrl_target_fingertip_pos, ctrl_target_fingertip_quat,
                           ctrl_target_gripper_dof_pos, ik_method: str = "dls"):
    """PD position targets for all 15 dofs."""
    pos_error, axis_angle_error = get_pose_error(
        fingertip_pos, fingertip_quat, ctrl_target_fingertip_pos, ctrl_target_fingertip_quat)
    delta_pose = torch.cat([pos_error, axis_angle_error], dim=-1)
    delta_arm = _get_delta_dof_pos(delta_pose, jacobian, ik_method)
    return torch.cat([arm_dof_pos + delta_arm, ctrl_target_gripper_dof_pos], dim=-1)


def _gripper_pd(gripper_dof_pos, gripper_dof_vel, target, kp=10.0, kd=0.2):
    return kp * (target - gripper_dof_pos) - kd * gripper_dof_vel


def compute_dof_torque(cfg_ctrl: dict, dof_pos, dof_vel, fingertip_pos, fingertip_quat,
                       fingertip_linvel, fingertip_angvel, left_finger_force, right_finger_force,
                       jacobian, arm_mass_matrix, ctrl_target_gripper_dof_pos,
                       ctrl_target_fingertip_pos, ctrl_target_fingertip_quat,
                       ctrl_target_fingertip_contact_wrench):
    """Commanded torques [..., 15] for the torque-control modes."""
    batch = dof_pos.shape[:-1]
    arm_vel = dof_vel[..., :7]
    zeros = lambda k: torch.zeros(batch + (k,), dtype=dof_pos.dtype, device=dof_pos.device)

    if cfg_ctrl["motion_ctrl"] in ("joint_space_id", "joint_space_ik"):
        pos_error, axis_angle_error = get_pose_error(
            fingertip_pos, fingertip_quat, ctrl_target_fingertip_pos, ctrl_target_fingertip_quat)
        delta = torch.cat([pos_error, axis_angle_error], dim=-1)
        dq = _get_delta_dof_pos(delta, jacobian, cfg_ctrl.get("ik_method", "dls"))
        t_arm = (_t(cfg_ctrl["joint_prop_gains"], dof_pos) * dq
                 - _t(cfg_ctrl["joint_deriv_gains"], dof_pos) * arm_vel)
        if cfg_ctrl["motion_ctrl"] == "joint_space_id":
            t_arm = torch.einsum("...ij,...j->...i", arm_mass_matrix, t_arm)
    else:
        task_wrench = zeros(6)
        if cfg_ctrl["motion_ctrl"] in ("task_space_impedance", "operational_space_motion",
                                       "hybrid_force_motion"):
            pos_error, axis_angle_error = get_pose_error(
                fingertip_pos, fingertip_quat, ctrl_target_fingertip_pos,
                ctrl_target_fingertip_quat)
            delta = torch.cat([pos_error, axis_angle_error], dim=-1)
            vel = torch.cat([fingertip_linvel, fingertip_angvel], dim=-1)
            w_motion = (_t(cfg_ctrl["task_prop_gains"], dof_pos) * delta
                        - _t(cfg_ctrl["task_deriv_gains"], dof_pos) * vel)
            axes = _t(cfg_ctrl.get("motion_ctrl_axes", [1] * 6), dof_pos)
            if cfg_ctrl["motion_ctrl"] in ("operational_space_motion", "hybrid_force_motion"):
                Minv = torch.linalg.inv(arm_mass_matrix)
                JMiJT = torch.einsum("...ik,...kl,...jl->...ij", jacobian, Minv, jacobian)
                w_motion = torch.einsum("...ij,...j->...i", torch.linalg.inv(JMiJT), w_motion)
            task_wrench = task_wrench + axes * w_motion

        if cfg_ctrl["force_ctrl"] in ("open", "closed"):
            f_axes = _t(cfg_ctrl.get("force_ctrl_axes", [1] * 6), dof_pos)
            w_target = ctrl_target_fingertip_contact_wrench
            w_force = w_target
            if cfg_ctrl["force_ctrl"] == "closed":
                kf = _t(cfg_ctrl["wrench_prop_gains"], dof_pos)
                measured = torch.cat([left_finger_force + right_finger_force, zeros(3)], dim=-1)
                w_force = w_target + kf * (w_target - measured)
            task_wrench = task_wrench + f_axes * w_force

        t_arm = torch.einsum("...ji,...j->...i", jacobian, task_wrench)

    t_grip = _gripper_pd(dof_pos[..., 7:], dof_vel[..., 7:], ctrl_target_gripper_dof_pos,
                         kp=_t(cfg_ctrl.get("gripper_prop_gains", [10.0] * 8), dof_pos),
                         kd=_t(cfg_ctrl.get("gripper_deriv_gains", [0.2] * 8), dof_pos))
    return torch.clamp(torch.cat([t_arm, t_grip], dim=-1), -TORQUE_CLAMP, TORQUE_CLAMP)


DEFAULT_CTRL_CFGS = {
    "gym_default": dict(motion_ctrl="gym_default", force_ctrl="off", ik_method="dls",
                        joint_prop_gains=[290, 208, 145, 145, 232, 204, 176],
                        joint_deriv_gains=[81, 80, 40, 43, 75, 82, 47],
                        gripper_prop_gains=[10.0] * 8, gripper_deriv_gains=[0.2] * 8),
    "joint_space_ik": dict(motion_ctrl="joint_space_ik", force_ctrl="off", ik_method="dls",
                           joint_prop_gains=[1.0] * 7, joint_deriv_gains=[0.1] * 7),
    "joint_space_id": dict(motion_ctrl="joint_space_id", force_ctrl="off", ik_method="dls",
                           joint_prop_gains=[290, 208, 145, 145, 232, 204, 176],
                           joint_deriv_gains=[81, 80, 40, 43, 75, 82, 47]),
    "task_space_impedance": dict(motion_ctrl="task_space_impedance", force_ctrl="off",
                                 motion_ctrl_axes=[1] * 6,
                                 task_prop_gains=[300, 300, 300, 50, 50, 50],
                                 task_deriv_gains=[34, 34, 34, 1.4, 1.4, 1.4]),
    "operational_space_motion": dict(motion_ctrl="operational_space_motion", force_ctrl="off",
                                     motion_ctrl_axes=[1] * 6,
                                     task_prop_gains=[200] * 6, task_deriv_gains=[10] * 6),
    "open_loop_force": dict(motion_ctrl="off", force_ctrl="open", force_ctrl_axes=[1] * 6),
    "closed_loop_force": dict(motion_ctrl="off", force_ctrl="closed", force_ctrl_axes=[1] * 6,
                              wrench_prop_gains=[0.1] * 6),
    "hybrid_force_motion": dict(motion_ctrl="hybrid_force_motion", force_ctrl="open",
                                motion_ctrl_axes=[1] * 6, task_prop_gains=[40] * 6,
                                task_deriv_gains=[8] * 6, force_ctrl_axes=[1] * 6,
                                wrench_prop_gains=[0.1] * 6),
}
for _name, _cfg in DEFAULT_CTRL_CFGS.items():
    _cfg.setdefault("gripper_prop_gains", [10.0] * 8)
    _cfg.setdefault("gripper_deriv_gains", [0.2] * 8)
