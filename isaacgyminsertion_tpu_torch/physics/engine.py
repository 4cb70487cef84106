"""The batched physics engine: `step(state) -> state` over [N, ...] tensors.

Port of `isaacgyminsertion_tpu/physics/engine.py`: dt = 1/60 with 3 substeps,
each with
  robot:  implicit joint-PD articulation step + contact reaction torques
  plug:   free rigid body; contacts vs socket SDF / table / fingertip pads,
          solved by the fused split-impulse contact solver
  socket/table: static (poses are per-env params set at reset)

The contact solve dispatches on the tensors' device: CUDA tensors go to the
hand-written CUDA kernel, CPU tensors to its plain PyTorch version
(`solver_kernel.solve_contacts_fused`).

Spans (`utils.profiling`): `physics` is `step`; inside it each substep's
`physics.dynamics` (the robot's FK, Jacobians, mass matrix and bias forces,
and the plug's free velocity) and `physics.contacts` (contact generation,
with its autograd SDF gradients).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import const
from ..ops import rotations as rot
from ..utils import profiling
from .contact import (
    PATCH_POINTS,
    MaterialParams,
    concat_contacts,
    default_materials,
    fingertip_plug_contacts,
    plug_env_contacts,
)
from .dynamics import bias_forces, fk_jacobians_with_tangents, implicit_pd_step, mass_matrix
from .kinematics import point_jacobian, site_pose
from .robot import SITE_FINGER_1, SITE_FINGER_2, SITE_FINGER_3, RobotModel
from .solver import ContactSet
from .solver_kernel import solve_contacts_fused

FINGER_SITES = (SITE_FINGER_1, SITE_FINGER_2, SITE_FINGER_3)
FINGER_BODIES = (9, 12, 14)
SOLVER_ITERS = 16
# PhysX rigid-body velocity caps: the explicit gyroscopic term grows
# quadratically in ω, so an uncapped spin diverges within a few substeps
MAX_ANG_VEL = 64.0
MAX_LIN_VEL = 100.0


class PhysicsState(NamedTuple):
    """Dynamic simulation state, leading axis = env batch N."""

    q: torch.Tensor           # [N, 15] robot dof positions
    qd: torch.Tensor          # [N, 15]
    plug_pos: torch.Tensor    # [N, 3] plug base-frame origin (world)
    plug_quat: torch.Tensor   # [N, 4] xyzw
    plug_v: torch.Tensor      # [N, 3] plug com linear velocity
    plug_w: torch.Tensor      # [N, 3] plug angular velocity
    ctrl_torque: torch.Tensor  # [N, 15] last applied drive torque
    tip_forces: torch.Tensor   # [N, 3, 3] smoothed fingertip contact reaction forces
    tip_fn: torch.Tensor       # [N, 3] fingertip normal force magnitudes


class PhysicsParams(NamedTuple):
    """Per-env static-for-the-episode physics data (all [N] / [N, ...])."""

    kind_onehot: torch.Tensor     # [N, K]
    plug_hx: torch.Tensor         # [N]
    plug_hy: torch.Tensor
    plug_length: torch.Tensor
    hole_hx: torch.Tensor
    hole_hy: torch.Tensor
    socket_height: torch.Tensor
    surface_points: torch.Tensor  # [N, P, 3]
    surface_weights: torch.Tensor  # [N, P]
    plug_mass: torch.Tensor       # [N]
    plug_inertia: torch.Tensor    # [N, 3] diagonal, plug com frame
    plug_com_z: torch.Tensor      # [N]
    socket_pos: torch.Tensor      # [N, 3]
    socket_quat: torch.Tensor     # [N, 4]
    plug_scale: torch.Tensor      # [N] asset-yaml scale (priv state)
    socket_scale: torch.Tensor    # [N] setup-only DR sample (priv state)
    table_height: torch.Tensor    # [N]
    gravity: torch.Tensor         # [N] z acceleration on the plug (0: disabled)
    kp: torch.Tensor              # [N, 15]
    kd: torch.Tensor              # [N, 15]
    contact: MaterialParams       # per-env friction coefficients


class ControlInput(NamedTuple):
    q_target: torch.Tensor          # [N, 15] PD position targets
    tau_cmd: torch.Tensor           # [N, 15] commanded torques (torque-mode rows)
    torque_mode_mask: torch.Tensor  # [15] or [N, 15], 1 = torque-driven row
    plug_wrench: torch.Tensor       # [N, 6] external disturbance (force, torque)


def make_params(sub_set, sub_idx: torch.Tensor, n_envs: int,
                kp_arm=(290.0, 208.0, 145.0, 145.0, 232.0, 204.0, 176.0),
                kd_arm=(81.0, 80.0, 40.0, 43.0, 75.0, 82.0, 47.0),
                kp_gripper: float = 10.0, kd_gripper: float = 0.2, gravity: float = 0.0,
                dtype=torch.float32) -> PhysicsParams:
    """Gather per-env shape rows of a SubassemblySet by `sub_idx` [N] (on the
    device of `sub_idx`). Gains default to the gym_default controller spec."""
    dev = sub_idx.device
    g = lambda a: const(a, dev, dtype)[sub_idx]
    row = lambda vals: torch.tensor(vals, dtype=dtype, device=dev).repeat(n_envs, 1)
    return PhysicsParams(
        kind_onehot=g(sub_set.kind_onehot),
        plug_hx=g(sub_set.plug_hx),
        plug_hy=g(sub_set.plug_hy),
        plug_length=g(sub_set.plug_length),
        hole_hx=g(sub_set.hole_hx),
        hole_hy=g(sub_set.hole_hy),
        socket_height=g(sub_set.socket_height),
        surface_points=g(sub_set.surface_points),
        surface_weights=g(sub_set.surface_weights),
        plug_mass=g(sub_set.plug_mass),
        plug_inertia=g(sub_set.plug_inertia),
        plug_com_z=g(sub_set.plug_com_z),
        socket_pos=row([0.5, 0.0, 0.001]),
        socket_quat=row([0.0, 0.0, 0.0, 1.0]),
        plug_scale=g(sub_set.plug_scale),
        socket_scale=torch.ones((n_envs,), dtype=dtype, device=dev),
        table_height=torch.full((n_envs,), 0.001, dtype=dtype, device=dev),
        gravity=torch.full((n_envs,), gravity, dtype=dtype, device=dev),
        kp=row(list(kp_arm) + [kp_gripper] * 8),
        kd=row(list(kd_arm) + [kd_gripper] * 8),
        contact=default_materials(dtype, dev),
    )


def initial_state(n_envs: int, model: RobotModel, dtype=torch.float32, device=None) -> PhysicsState:
    row = lambda vals: torch.tensor(vals, dtype=dtype, device=device).repeat(n_envs, 1)
    z = lambda *s: torch.zeros((n_envs,) + s, dtype=dtype, device=device)
    return PhysicsState(
        q=row([0.0064, 0.2375, -0.0075, -1.2022, 0.0015, 1.69, -1.5699,
               0.7, 1.0, 0.1, -0.7, 1.0, 0.1, 1.0, 0.1]),
        qd=z(15),
        plug_pos=row([0.5, 0.0, 0.1]),
        plug_quat=row([0.0, 0.0, 0.0, 1.0]),
        plug_v=z(3), plug_w=z(3), ctrl_torque=z(15), tip_forces=z(3, 3), tip_fn=z(3),
    )


def fingertip_poses(model: RobotModel, fk):
    """World (quat, pos) of the 3 fingertip pad sites, stacked [..., 3, 4|3]."""
    qs, ts = zip(*(site_pose(model, fk, s) for s in FINGER_SITES))
    return torch.stack(qs, dim=-2), torch.stack(ts, dim=-2)


def _plug_inertia_world(plug_quat, inertia_diag, inverse=False):
    R = rot.quat_to_matrix(plug_quat)
    d = 1.0 / inertia_diag.clamp_min(1e-12) if inverse else inertia_diag
    return (R * d[..., None, :]) @ R.transpose(-1, -2)


def _com_offset(params: PhysicsParams):
    z = torch.zeros_like(params.plug_com_z)
    return torch.stack([z, z, params.plug_com_z], dim=-1)


def _com_of(state: PhysicsState, params: PhysicsParams):
    return state.plug_pos + rot.quat_apply(state.plug_quat, _com_offset(params))


class _Prepared(NamedTuple):
    M: torch.Tensor
    C: torch.Tensor
    Jtips: torch.Tensor
    com_w: torch.Tensor
    I_inv_w: torch.Tensor
    v_free: torch.Tensor
    w_free: torch.Tensor
    cs: ContactSet


def _prepare(model, params: PhysicsParams, state: PhysicsState, ctrl: ControlInput, h: float):
    """Everything a substep computes before the contact solve."""
    with profiling.span("physics.dynamics"):
        fk, J, _fk_dot, J_dot = fk_jacobians_with_tangents(model, state.q, state.qd)
        M = mass_matrix(model, state.q, fk=fk, J=J)
        C = bias_forces(model, state.q, state.qd, gravity=0.0, fk=fk, J=J, J_dot=J_dot)

        _tip_q, tip_t = fingertip_poses(model, fk)
        Jtips = torch.stack([point_jacobian(model, fk, tip_t[..., i, :], FINGER_BODIES[i])
                             for i in range(3)], dim=-3)                      # [N, 3, 6, nd]
        tip_vel = torch.einsum("...fij,...j->...fi", Jtips[..., :3, :], state.qd)
        com_w = _com_of(state, params)

        # ---- free-velocity update (gravity + disturbance wrench)
        m = params.plug_mass[..., None]
        zg = torch.zeros_like(params.gravity)
        g_vec = torch.stack([zg, zg, params.gravity], dim=-1)
        Iw = _plug_inertia_world(state.plug_quat, params.plug_inertia)
        I_inv_w = _plug_inertia_world(state.plug_quat, params.plug_inertia, inverse=True)
        gyro = torch.linalg.cross(state.plug_w, torch.einsum("...ij,...j->...i", Iw, state.plug_w))
        # light linear/angular damping (sim.add_damping)
        damp = torch.exp(torch.tensor(-1.0 * h, dtype=state.plug_v.dtype, device=state.plug_v.device))
        v_free = state.plug_v * damp + h * (g_vec + ctrl.plug_wrench[..., :3] / m)
        w_free = state.plug_w * damp + h * torch.einsum(
            "...ij,...j->...i", I_inv_w, ctrl.plug_wrench[..., 3:] - gyro)

    # ---- contact generation
    with profiling.span("physics.contacts"):
        cs_fing, _aux = fingertip_plug_contacts(
            tip_t, tip_vel, state.plug_quat, state.plug_pos, com_w, params.kind_onehot,
            params.plug_hx, params.plug_hy, params.plug_length, params.contact)
        from ..assets import SOCKET_PT_COUNT, TABLE_PT_IDX

        tbl_idx = const(TABLE_PT_IDX, params.surface_points.device, torch.long)
        cs_env = plug_env_contacts(
            params.surface_points[:, :SOCKET_PT_COUNT], params.surface_weights[:, :SOCKET_PT_COUNT],
            params.surface_points[:, tbl_idx], params.surface_weights[:, tbl_idx],
            state.plug_quat, state.plug_pos, com_w, params.socket_quat, params.socket_pos,
            params.kind_onehot, params.hole_hx, params.hole_hy, params.socket_height,
            params.table_height, params.contact)
        cs = concat_contacts(cs_fing, cs_env)  # finger patches occupy slots [0:3*PATCH_POINTS]
    return _Prepared(M, C, Jtips, com_w, I_inv_w.contiguous(), v_free.contiguous(),
                     w_free.contiguous(), cs)


def contact_problem(model, params: PhysicsParams, state: PhysicsState, ctrl: ControlInput, h: float):
    """The contact-solver inputs of one substep: (mass, I_inv_w, v_free, w_free, cs)."""
    p = _prepare(model, params, state, ctrl, h)
    return params.plug_mass.contiguous(), p.I_inv_w, p.v_free, p.w_free, p.cs


def substep(model: RobotModel, params: PhysicsParams, state: PhysicsState, ctrl: ControlInput,
            h: float, solver_iters: int = SOLVER_ITERS) -> PhysicsState:
    """One physics substep (vectorized over the env batch)."""
    p = _prepare(model, params, state, ctrl, h)
    cs = p.cs
    # split impulse: zero-bias velocity solve, then positional projection, in
    # one fused solve (the CUDA kernel on the card)
    res = solve_contacts_fused(params.plug_mass.contiguous(), p.I_inv_w, p.v_free, p.w_free,
                               cs, h, iters=solver_iters)
    v = torch.clamp(res.v, -MAX_LIN_VEL, MAX_LIN_VEL)
    w = torch.clamp(res.w, -MAX_ANG_VEL, MAX_ANG_VEL)

    # fingertip reaction (impulse → force): patch slots summed per finger
    n_fc = 3 * PATCH_POINTS
    f_pts = (cs.n[..., :n_fc, :] * res.lam_n[..., :n_fc, None] + res.lam_t[..., :n_fc, :]) / h
    tip_force = -f_pts.reshape(f_pts.shape[:-2] + (3, PATCH_POINTS, 3)).sum(-2)
    tip_fn = res.lam_n[..., :n_fc].reshape(res.lam_n.shape[:-1] + (3, PATCH_POINTS)).sum(-1) / h

    # ---- integrate plug (velocity step + positional correction)
    com_new = p.com_w + h * v + res.dx
    rot_vec = w * h + res.dth
    dq = rot.quat_mul(torch.cat([rot_vec * 0.5, torch.zeros_like(w[..., :1])], dim=-1),
                      state.plug_quat)
    quat_new = rot.quat_unit(state.plug_quat + dq)
    pos_new = com_new - rot.quat_apply(quat_new, _com_offset(params))

    # ---- robot: contact reaction torques, then implicit PD
    tau_ext = torch.einsum("...fik,...fi->...k", p.Jtips[..., :3, :], tip_force)
    q_new, qd_new, drive = implicit_pd_step(
        model, state.q, state.qd, ctrl.q_target, params.kp, params.kd, tau_ext, h, p.M, p.C,
        torque_mode_mask=ctrl.torque_mode_mask, tau_cmd=ctrl.tau_cmd)

    return PhysicsState(q=q_new, qd=qd_new, plug_pos=pos_new, plug_quat=quat_new, plug_v=v,
                        plug_w=w, ctrl_torque=drive, tip_forces=tip_force, tip_fn=tip_fn)


def step(model: RobotModel, params: PhysicsParams, state: PhysicsState, ctrl: ControlInput,
         dt: float = 1.0 / 60.0, n_substeps: int = 3, smooth_force: float = 0.9,
         solver_iters: int = SOLVER_ITERS) -> PhysicsState:
    """Advance one control step = `n_substeps` physics substeps; fingertip
    forces are EMA-filtered across substeps with `smooth_force`."""
    h = dt / n_substeps
    st, tipf = state, state.tip_forces
    with profiling.span("physics"):
        for _ in range(n_substeps):
            st = substep(model, params, st, ctrl, h, solver_iters=solver_iters)
            tipf = smooth_force * tipf + (1.0 - smooth_force) * st.tip_forces
    return st._replace(tip_forces=tipf)
