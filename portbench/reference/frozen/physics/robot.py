"""KUKA iiwa7 + OpenHand Model-O robot model as packed arrays.

A snapshot of the port's module, itself a numpy-only copy of `isaacgyminsertion_tpu/physics/robot.py` (the tests hold
the two tables equal). Kinematic/inertial parameters follow
assets/factory/urdf/factory_kuka.urdf: 7 revolute arm joints + 8 revolute
finger joints; fixed mounts merged into their parent actuated bodies with
exact parallel-axis inertia composition. `RobotModel` holds static numpy
arrays; the torch kinematics/dynamics take device copies of them through
`ops.const`.

DOF order (matches the reference's dof_dict layout, SURVEY.md §8.5):
  0:7  iiwa7_joint_1..7
  7    base_to_finger_1_1   (finger-1 base swivel, axis x, [0, pi/2])
  8    finger_1_1_to_finger_1_2  (f1 proximal, [-0.1, 3.0])
  9    finger_1_2_to_finger_1_3  (f1 distal,   [0, 1.27])
  10   base_to_finger_2_1   (finger-2 base swivel, [-pi/2, 0])
  11   finger_2_1_to_finger_2_2  (f2 proximal)
  12   finger_2_2_to_finger_2_3  (f2 distal)
  13   base_to_finger_3_2   (f3 proximal — finger 3 has no swivel)
  14   finger_3_2_to_finger_3_3  (f3 distal)

Body i is the child link of DOF i. Site frames (fingertips, fingertip_centered)
are fixed transforms on bodies.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

PI = math.pi
NUM_DOFS = 15
NUM_ARM_DOFS = 7


class RobotModel(NamedTuple):
    """Static robot description (numpy)."""

    parent: np.ndarray        # [nd] parent body index, -1 = fixed world base
    joint_t: np.ndarray       # [nd, 3] joint frame origin in parent joint frame
    joint_q: np.ndarray       # [nd, 4] joint frame rotation (xyzw) in parent frame
    axis: np.ndarray          # [nd, 3] rotation axis in joint frame
    mass: np.ndarray          # [nd]
    com: np.ndarray           # [nd, 3] body com in joint frame
    inertia: np.ndarray       # [nd, 3, 3] rotational inertia about com, joint frame
    armature: np.ndarray      # [nd]
    damping: np.ndarray       # [nd] passive joint damping — 0: IsaacGym DOF-prop
                              # damping REPLACES URDF damping and the reference sets it
                              # to the PD deriv gain (factory_base.py:489-498), which
                              # implicit_pd_step already applies as kd
    dof_lower: np.ndarray     # [nd]
    dof_upper: np.ndarray     # [nd]
    effort_limit: np.ndarray  # [nd]
    velocity_limit: np.ndarray  # [nd]
    ancestor_mask: np.ndarray   # [nd, nd] mask[b, j] = 1 if dof j moves body b
    # site frames: fixed (q, t) transforms in their carrier body's joint frame
    site_body: np.ndarray     # [ns] body index of each site
    site_t: np.ndarray        # [ns, 3]
    site_q: np.ndarray        # [ns, 4]


# site indices
SITE_FINGERTIP_CENTERED = 0
SITE_FINGER_1 = 1  # left  (finger_1_3)
SITE_FINGER_2 = 2  # right (finger_2_3)
SITE_FINGER_3 = 3  # middle/bottom (finger_3_3)


def _rpy_to_quat(r, p, y):
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    # URDF rpy = extrinsic xyz == intrinsic zyx; quat xyzw
    qw = cy * cp * cr + sy * sp * sr
    qx = cy * cp * sr - sy * sp * cr
    qy = cy * sp * cr + sy * cp * sr
    qz = sy * cp * cr - cy * sp * sr
    return np.array([qx, qy, qz, qw])


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def _quat_rot(q, v):
    xyz, w = q[:3], q[3]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _quat_mat(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _tf(t, rpy):
    return np.asarray(t, float), _rpy_to_quat(*rpy)


def _compose(t1, q1, t2, q2):
    return t1 + _quat_rot(q1, t2), _quat_mul(q1, q2)


def _merge_inertial(parts):
    """Combine (mass, com, I_about_com, q, t) rigid parts into one inertial.

    Each part's com/inertia are given in its own frame; (q, t) maps that frame
    into the target (joint) frame. Exact parallel-axis composition.
    """
    m_tot = 0.0
    c_tot = np.zeros(3)
    moved = []
    for m, c, I, q, t in parts:
        R = _quat_mat(q)
        c_w = R @ np.asarray(c, float) + t
        I_w = R @ np.asarray(I, float) @ R.T
        moved.append((m, c_w, I_w))
        m_tot += m
        c_tot += m * c_w
    c_tot /= max(m_tot, 1e-12)
    I_tot = np.zeros((3, 3))
    for m, c_w, I_w in moved:
        d = c_w - c_tot
        I_tot += I_w + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m_tot, c_tot, I_tot


def _diag(ixx, iyy, izz):
    return np.diag([ixx, iyy, izz])


def build_kuka_openhand(armature: float = 0.01) -> RobotModel:
    """Build the 15-dof KUKA+OpenHand model (numeric data per factory_kuka.urdf)."""
    I3 = np.eye(3)
    ident = np.array([0.0, 0.0, 0.0, 1.0])

    # gripper base fixed transform on link7
    tg, qg = _tf([0, 0, 0.21], (0, PI / 2, 0))

    joints = []  # (parent, t, q, axis, inertial_parts, damping, lo, hi, effort, vel)

    def arm(parent, t, rpy, lo, hi, m, com, I):
        joints.append(
            dict(parent=parent, t=np.asarray(t, float), q=_rpy_to_quat(*rpy), axis=np.array([0.0, 0.0, 1.0]),
                 parts=[(m, com, I, ident, np.zeros(3))], damping=0.0, lo=lo, hi=hi, effort=300.0, vel=2.0)
        )

    # iiwa7 arm (joint origins/limits and link inertials: factory_kuka.urdf)
    arm(-1, [0, 0, 0.1575], (0, 0, 0), -2.96705972839, 2.96705972839, 4.0, [0, -0.03, 0.12], _diag(0.1, 0.09, 0.02))
    arm(0, [0, 0, 0.2025], (PI / 2, 0, PI), -2.09439510239, 2.09439510239, 4.0, [0.0003, 0.059, 0.042], _diag(0.05, 0.018, 0.044))
    arm(1, [0, 0.2045, 0], (PI / 2, 0, PI), -2.96705972839, 2.96705972839, 3.0, [0, 0.03, 0.13], _diag(0.08, 0.075, 0.01))
    arm(2, [0, 0, 0.2155], (PI / 2, 0, 0), -2.09439510239, 2.09439510239, 2.7, [0, 0.067, 0.034], _diag(0.03, 0.01, 0.029))
    arm(3, [0, 0.1845, 0], (-PI / 2, PI, 0), -2.96705972839, 2.96705972839, 1.7, [0.0001, 0.021, 0.076], _diag(0.02, 0.018, 0.005))
    arm(4, [0, 0, 0.2155], (PI / 2, 0, 0), -2.09439510239, 2.09439510239, 1.8, [0, 0.0006, 0.0004], _diag(0.005, 0.0036, 0.0047))
    # link7 merged with: dummy_ft (m 0.1 @ [0,0,0.11]) and gripper_base (m 0.7,
    # com [0.03,0,0] in gripper frame)
    link7_parts = [
        (0.3, [0, 0, 0.02], _diag(0.001, 0.001, 0.001), ident, np.zeros(3)),
        (0.1, [0, 0, 0], _diag(0.001, 0.001, 0.001), ident, np.array([0, 0, 0.11])),
        (0.7, [0.03, 0, 0], _diag(0.001, 0.001, 0.001), qg, tg),
    ]
    joints.append(
        dict(parent=5, t=np.array([0, 0.081, 0.0]), q=_rpy_to_quat(-PI / 2, PI, 0), axis=np.array([0.0, 0.0, 1.0]),
             parts=link7_parts, damping=0.5, lo=-3.05432619099, hi=3.05432619099, effort=300.0, vel=2.0)
    )

    small_I = _diag(1e-4, 1e-4, 1e-4)
    mount_tip_t, mount_tip_q = _tf([0.025, 0.003, 0], (PI / 2, 0, 0))

    def finger_base(parent_t, parent_rpy, lo, hi):
        # base swivel joint: origin = gripper_base ∘ offset, axis x
        off_t, off_q = _tf(parent_t, parent_rpy)
        t, q = _compose(tg, qg, off_t, off_q)
        joints.append(
            dict(parent=6, t=t, q=q, axis=np.array([1.0, 0.0, 0.0]),
                 parts=[(0.05, [0, 0, 0], small_I, ident, np.zeros(3))],
                 damping=0.0, lo=lo, hi=hi, effort=3.0, vel=2.0)
        )

    def finger_link(parent, t, rpy, axis, lo, hi, with_mount=False):
        parts = [(0.05, [0, 0, 0], small_I, ident, np.zeros(3))]
        if with_mount:  # fixed fingertip link merged into the mount body
            parts.append((0.05, [0, 0, 0], small_I, mount_tip_q, mount_tip_t))
        joints.append(
            dict(parent=parent, t=np.asarray(t, float), q=_rpy_to_quat(*rpy), axis=np.asarray(axis, float),
                 parts=parts, damping=0.0, lo=lo, hi=hi, effort=3.0, vel=2.0)
        )

    # finger 1 (left): bodies 7, 8, 9
    finger_base([-0.003, -0.034, -0.027], (PI, 0, 0), 0.0, PI / 2)
    finger_link(7, [-0.023, 0.00725, 0], (0, 0, 0), [0, 0, 1], -0.1, 3.0)
    finger_link(8, [0.0008, 0.063, 0], (0, 0, PI / 2), [0, 0, 1], 0.0, 1.27, with_mount=True)
    # finger 2 (right): bodies 10, 11, 12
    finger_base([-0.003, -0.034, 0.027], (PI, 0, 0), -PI / 2, 0.0)
    finger_link(10, [-0.02, 0.00725, 0], (0, 0, 0), [0, 0, 1], -0.1, 3.0)
    finger_link(11, [0.0008, 0.063, 0], (0, 0, PI / 2), [0, 0, 1], 0.0, 1.27, with_mount=True)
    # finger 3 (middle, no swivel): bodies 13, 14; proximal mounts on gripper base
    off_t, off_q = _tf([-0.023, 0.047, 0], (0, 0, 0))
    t, q = _compose(tg, qg, off_t, off_q)
    joints.append(
        dict(parent=6, t=t, q=q, axis=np.array([0.0, 0.0, 1.0]),
             parts=[(0.05, [0, 0, 0], small_I, ident, np.zeros(3))],
             damping=0.0, lo=-0.1, hi=3.0, effort=3.0, vel=2.0)
    )
    finger_link(13, [0.0008, 0.063, 0], (0, 0, PI / 2), [0, 0, 1], 0.0, 1.27, with_mount=True)

    nd = len(joints)
    assert nd == NUM_DOFS

    parent = np.array([j["parent"] for j in joints], np.int32)
    joint_t = np.stack([j["t"] for j in joints]).astype(np.float32)
    joint_q = np.stack([j["q"] for j in joints]).astype(np.float32)
    axis = np.stack([j["axis"] for j in joints]).astype(np.float32)

    mass = np.zeros(nd, np.float32)
    com = np.zeros((nd, 3), np.float32)
    inertia = np.zeros((nd, 3, 3), np.float32)
    for i, j in enumerate(joints):
        m, c, I = _merge_inertial(j["parts"])
        mass[i], com[i], inertia[i] = m, c, I

    ancestor = np.zeros((nd, nd), np.float32)
    for b in range(nd):
        a = b
        while a != -1:
            ancestor[b, a] = 1.0
            a = parent[a]

    # sites
    site_body = np.array([6, 9, 12, 14], np.int32)
    # fingertip_centered (kuka_fingertip_centered frame): on the tool axis at
    # the centroid of the three fingertip pads in the closed-hand pose
    # (computed from this model's FK; grasp/motion frame of factory_base)
    ftc_t = np.array([0.0, 0.0017, 0.2827])
    site_t = np.stack([ftc_t, mount_tip_t, mount_tip_t, mount_tip_t]).astype(np.float32)
    site_q = np.stack([ident, mount_tip_q, mount_tip_q, mount_tip_q]).astype(np.float32)

    return RobotModel(
        parent=parent,
        joint_t=joint_t,
        joint_q=joint_q,
        axis=axis,
        mass=mass,
        com=com,
        inertia=inertia.astype(np.float32),
        armature=np.full(nd, armature, np.float32),
        damping=np.array([j["damping"] for j in joints], np.float32),
        dof_lower=np.array([j["lo"] for j in joints], np.float32),
        dof_upper=np.array([j["hi"] for j in joints], np.float32),
        effort_limit=np.array([j["effort"] for j in joints], np.float32),
        velocity_limit=np.array([j["vel"] for j in joints], np.float32),
        ancestor_mask=ancestor,
        site_body=site_body,
        site_t=site_t,
        site_q=site_q,
    )


# DOF index helpers (parity with the reference's dof_dict lookups)
F1_BASE, F1_PROX, F1_DIST = 7, 8, 9
F2_BASE, F2_PROX, F2_DIST = 10, 11, 12
F3_PROX, F3_DIST = 13, 14
HAND_JOINT_IDX = np.array([F1_PROX, F2_PROX, F3_PROX, F1_DIST, F2_DIST, F3_DIST])
GRIPPER_DOFS = slice(7, 15)
ARM_DOFS = slice(0, 7)
