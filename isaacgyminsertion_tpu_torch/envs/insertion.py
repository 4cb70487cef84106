"""FactoryTaskInsertionTactile: the insertion MDP over [N, ...] tensors.

Port of `isaacgyminsertion_tpu/envs/insertion.py`:

    state', out = step(cfg, model, subs, state, policy_actions, generator,
                       grasp_data=None, gan=None)

Masked resets, the action latency queue, observation staleness, domain
randomization, rewards and success/failure detection are fixed-shape tensor
programs over the env batch. Random draws come from an explicit
`torch.Generator` (the reference carries a JAX key in its state); the
reference's `lax.cond(any(reset_buf))` is a host `if`.

Resets sample the predefined-grasp distribution analytically: socket pose
with noise, the arm placed by IK so the fingertip frame sits over the plug,
the plug hanging in the grasp with pose noise, and the hand closed onto it by
a per-finger bisection on the predicted gel force. With `grasp_data` (a
`grasp_gen.GraspData` table) a row drawn per env replaces the dofs and the
socket pose, and the plug rides the row's hand-relative pose; the row's draw
is one extra uniform, taken only when a table is given, so the draws without
one are those of the analytic resets.

The sensor modalities (tactile images, external depth/seg camera, point
clouds, contact ground truth) are rendered after the physics, decimated and
delayed per env, and kept in FIFO queues. The image queues are stored in
float16 (pure [0, 1]-ranged frame storage; the ~1e-3 quantization sits far
below the 0.01 pixel noise) and handed out as float32. With
`env.render_capacity < 1` only the env rows that consume a fresh frame this
step are rendered (`render_selection`). `gan`, a `models.zoo.ResnetGenerator`,
translates the rendered tactile frames sim → real before they enter the queue
(the CycleGAN hook: frames × 2 − 1 → generator → (out + 1) / 2), on the
gathered rows where only those are rendered. Under data parallelism
(`dp=`, a `parallel.mesh.DataParallel`, this process holding its rows of the
global batch) the rows to render are selected over the global batch, as the
single process selects them, and each rank renders the selected rows that it
owns; `extras["render_rows"]` says how many each renderer drew here.

Spans and counters (`utils.profiling`): `env` is the step; inside it
`env.sync` is its one host sync (does any env reset?), `env.reset` the
resets, `physics` the engine's step, `sensors` the sensor step with
`sensors.tactile` and `sensors.camera` (the point cloud included);
`sensors.rows_rendered` counts the rows each renderer drew, and
`sensors.rows_consumed` those of them whose fresh frame a consumer takes
this step (a device count, kept only while tracing is on).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..assets import PLUG_FRICTION, SubassemblySet
from ..ops import const
from ..ops import control as ctrlmod
from ..ops import rotations as rot
from ..physics import engine
from ..physics.contact import GEL_STIFFNESS, PATCH_POINTS, MaterialParams, fingertip_plug_contacts
from ..physics.engine import ControlInput, PhysicsParams, PhysicsState
from ..physics.kinematics import forward_kinematics, point_jacobian, site_pose
from ..physics.robot import HAND_JOINT_IDX, SITE_FINGERTIP_CENTERED, RobotModel
from ..sensors import camera as cam_mod
from ..sensors import contact_gt as cgt_mod
from ..sensors import pcl as pcl_mod
from ..sensors import tactile as tact_mod
from ..parallel import mesh
from ..utils import profiling
from . import dr as dr_mod
from .config import TaskConfig

ACTION_QUEUE_LEN = 16  # action_latency_max 15 + current
# sensor frame queues ([N, 0] when the modality is off); the first three are float16
SENSOR_QUEUES = ("tactile_queue", "img_queue", "seg_queue", "pcl_queue", "contact_queue")


class EnvState(NamedTuple):
    """Complete per-env episode state; every tensor is [N, ...]."""

    phys: PhysicsState
    params: PhysicsParams          # DR-randomized per episode
    sub_idx: torch.Tensor          # [N] subassembly row per env
    progress: torch.Tensor         # [N] steps since reset
    frame: torch.Tensor            # [N] global frame (decimation phase)
    global_step: int               # total policy steps (schedules)
    # action pipeline
    actions: torch.Tensor          # [N, 6] current policy actions
    prev_actions: torch.Tensor     # [N, 6]
    applied_actions: torch.Tensor  # [N, 6] EMA-smoothed applied actions
    actions_queue: torch.Tensor    # [N, Q, 6] newest at index 0
    action_latency: torch.Tensor   # [N]
    targets: torch.Tensor          # [N, 6] accumulated pose targets
    gripper_target: torch.Tensor   # [N, 8] held grasp closure targets (set at reset)
    # observation staleness state
    obs_queue: torch.Tensor        # [N, hist*obs]
    obs_stud_queue: torch.Tensor   # [N, hist*obs_stud]
    obs_plug_pos_freq: torch.Tensor   # [N, 3] decimated plug pos
    obs_plug_quat_freq: torch.Tensor  # [N, 4]
    obs_plug_pos: torch.Tensor     # [N, 3] decimated + delayed plug pos
    obs_plug_quat: torch.Tensor    # [N, 4]
    plug_pose_refresh_rate: torch.Tensor    # [N] in [1, max_object_skip_obs]
    plug_pose_refresh_offset: torch.Tensor  # [N]
    # episode reference snapshots
    plug_hand_pos_init: torch.Tensor   # [N, 3]
    plug_hand_quat_init: torch.Tensor  # [N, 4]
    plug_pos_init: torch.Tensor        # [N, 3]
    # raw correlated DR noise, held per randomization window
    obs_noise_corr: torch.Tensor   # [N, obs_dim]
    act_noise_corr: torch.Tensor   # [N, 6]
    finger_forces_ema: torch.Tensor  # [N, 3]
    rb_force: torch.Tensor         # [N, 3] decaying random plug force
    # termination
    reset_buf: torch.Tensor        # [N] bool
    success_reset_buf: torch.Tensor
    timeout_reset_buf: torch.Tensor
    degrasp_buf: torch.Tensor
    far_from_goal_buf: torch.Tensor
    progress_change_tracker: torch.Tensor  # [N]
    ep_reward: torch.Tensor        # [N]
    # sensor FIFO queues (zero-sized [N, 0] when the modality is off)
    tactile_queue: torch.Tensor    # [N, Th, F, H, W, C] f16
    img_queue: torch.Tensor        # [N, Ih, H, W] f16
    seg_queue: torch.Tensor        # [N, Ih, H, W] f16 (float of int ids)
    pcl_queue: torch.Tensor        # [N, Ih, P, 3]
    contact_queue: torch.Tensor    # [N, Ch, P]
    tactile_refresh_rate: torch.Tensor    # [N]
    tactile_refresh_offset: torch.Tensor  # [N]
    img_refresh_rate: torch.Tensor        # [N]
    img_refresh_offset: torch.Tensor      # [N]


class StepOutput(NamedTuple):
    obs: torch.Tensor          # [N, hist*15]
    student_obs: torch.Tensor  # [N, hist*15]
    priv_info: torch.Tensor    # [N, 64]
    rew: torch.Tensor          # [N]
    reset: torch.Tensor        # [N] bool
    timeout: torch.Tensor      # [N] bool
    extras: dict
    # sensor modalities, float32; zero-sized when the modality is off
    tactile: torch.Tensor      # [N, Th, F, H, W, C]
    img: torch.Tensor          # [N, Ih, H, W]
    seg: torch.Tensor          # [N, Ih, H, W]
    pcl: torch.Tensor          # [N, Ih, P, 3]
    contacts: torch.Tensor     # [N, Ch, P]


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def _f32(vals, device):
    return torch.as_tensor(vals, dtype=torch.float32, device=device)


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _sym_noise(gen, shape, scale, device):
    """Uniform in [-scale, scale] per component."""
    return (2.0 * torch.rand(shape, generator=gen, device=device) - 1.0) * _f32(scale, device)


def _where(mask, new, old):
    """Masked update; mask [N] broadcasts over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim)), new, old)


def _masked_tree(mask, new, old):
    if isinstance(new, tuple):
        return type(new)(*[_masked_tree(mask, a, b) for a, b in zip(new, old)])
    return _where(mask, new, old)


def world_to_robot_base(pos, quat):
    """The kuka base sits at the world origin: robot frame == world frame."""
    return pos, quat


# --------------------------------------------------------------------------- #
# reset
# --------------------------------------------------------------------------- #

_NOMINAL_IK_CACHE: dict = {}


def nominal_grasp_arm_q(model: RobotModel, target=(0.5, 0.0, 0.175)) -> np.ndarray:
    """Host-side IK (CPU, float32) for the nominal reset pose: fingertip_centered
    over the socket with the tool axis down. Cached per model."""
    key = (id(model), tuple(round(t, 4) for t in target))
    hit = _NOMINAL_IK_CACHE.get(key)
    if hit is not None and hit[0] is model:
        return hit[1]
    q = torch.tensor([[0.0064, 0.2375, -0.0075, -1.2022, 0.0015, 1.69, -1.5699] + [0.0] * 8],
                     dtype=torch.float32)
    tgt = torch.tensor([target], dtype=torch.float32)
    for _ in range(30):
        fk = forward_kinematics(model, q)
        _fq, ft = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
        J = point_jacobian(model, fk, ft, 6)[..., :7]
        err = torch.cat([tgt - ft, torch.zeros((1, 3))], dim=-1)
        dq = ctrlmod._get_delta_dof_pos(err, J, "dls")
        q = torch.cat([q[:, :7] + torch.clamp(dq, -0.2, 0.2), q[:, 7:]], dim=-1)
    out = q[0, :7].numpy().copy()
    _NOMINAL_IK_CACHE[key] = (model, out)
    return out


def _gather_shape_rows(subs: SubassemblySet, sub_idx: torch.Tensor) -> dict:
    g = lambda a: const(a, sub_idx.device)[sub_idx]
    return {k: g(getattr(subs, k)) for k in (
        "kind_onehot", "plug_hx", "plug_hy", "plug_length", "plug_scale", "hole_hx", "hole_hy",
        "socket_height", "surface_points", "surface_weights", "plug_mass", "plug_inertia",
        "plug_com_z", "friction")}


def _z_offset(z):
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z], dim=-1)


def _sample_episode(cfg: TaskConfig, model: RobotModel, subs: SubassemblySet,
                    gen: torch.Generator, n: int, sub_idx: torch.Tensor,
                    base_params: PhysicsParams, global_step: int = 0, grasp_data=None):
    """Sample fresh episode state for ALL envs (callers mask into the batch)."""
    dev = sub_idx.device
    rz = cfg.randomize
    rows = _gather_shape_rows(subs, sub_idx)

    # ---- socket pose
    sock_xy = _f32(rz.socket_pos_xy_initial, dev) + _sym_noise(gen, (n, 2), rz.socket_pos_xy_noise, dev)
    sock_z = cfg.sim.table_height + _uniform(gen, (n,), float(rz.socket_pos_z_noise_bounds[0]),
                                             float(rz.socket_pos_z_noise_bounds[1]), dev)
    socket_pos = torch.cat([sock_xy, sock_z[:, None]], dim=-1)
    sock_eul = _sym_noise(gen, (n, 3), rz.socket_rot_euler_noise, dev)
    socket_quat = rot.quat_from_euler_xyz(sock_eul[..., 0], sock_eul[..., 1], sock_eul[..., 2])

    # ---- robot dofs: IK-placed arm (nominal host IK + 3 per-env refinements
    # toward a grasp U[0.05, 0.08] m above the socket) + hand closed with noise
    oh = cfg.env.openhand
    grip_depth = rows["plug_length"] * 0.8
    plug_base_z = sock_z + rows["socket_height"] + _uniform(
        gen, (n,), float(rz.plug_pos_z_noise_bounds[0]), float(rz.plug_pos_z_noise_bounds[1]), dev)
    plug_xy = sock_xy + _sym_noise(gen, (n, 2), rz.plug_pos_xy_noise, dev)
    ftc_target = torch.cat([plug_xy, (plug_base_z + grip_depth)[:, None]], dim=-1)
    q_arm = _f32(nominal_grasp_arm_q(model), dev).repeat(n, 1)
    prox = oh.proximal_close + _sym_noise(gen, (n, 3), oh.proximal_noise, dev)
    dist = oh.distal_close + _sym_noise(gen, (n, 3), oh.distal_noise, dev)
    base = torch.full((n, 1), oh.base_angle, device=dev)
    q_hand = torch.cat([base, prox[:, :1], dist[:, :1], -base, prox[:, 1:2], dist[:, 1:2],
                        prox[:, 2:], dist[:, 2:]], dim=-1)
    q = torch.cat([q_arm, q_hand], dim=-1)
    zeros3 = torch.zeros((n, 3), device=dev)
    for _ in range(3):
        fk = forward_kinematics(model, q)
        _fq, ft = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
        J = point_jacobian(model, fk, ft, 6)[..., :7]
        dq = ctrlmod._get_delta_dof_pos(torch.cat([ftc_target - ft, zeros3], dim=-1), J, "dls")
        q = torch.cat([q[:, :7] + torch.clamp(dq, -0.2, 0.2), q[:, 7:]], dim=-1)

    # ---- grasp-dataset override: a sampled row replaces the IK pose and the
    # socket pose for envs whose subassembly has rows
    if grasp_data is not None:
        gd = lambda a: const(a, dev)[sub_idx, row]
        counts = const(grasp_data.count, dev, torch.long)[sub_idx]
        row = (torch.rand((n,), generator=gen, device=dev) * torch.clamp_min(counts, 1)).long()
        has = counts > 0
        q = _where(has, gd(grasp_data.dof_pos), q)
        socket_pos = _where(has, gd(grasp_data.socket_pos), socket_pos)
        socket_quat = _where(has, gd(grasp_data.socket_quat), socket_quat)

    # ---- plug pose: grasped below the fingertip-centered frame
    fk = forward_kinematics(model, q)
    ftc_q, ftc_t = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
    plug_eul = _sym_noise(gen, (n, 3), rz.plug_rot_noise, dev)
    plug_quat = rot.quat_unit(rot.quat_from_euler_xyz(plug_eul[..., 0], plug_eul[..., 1],
                                                      plug_eul[..., 2]))
    grasp_off = _sym_noise(gen, (n, 3), (rz.grasp_plug_noise,) * 3, dev)
    plug_pos = ftc_t + grasp_off - rot.quat_apply(plug_quat, _z_offset(rows["plug_length"] * 0.8))
    if grasp_data is not None:
        # the plug rides the row's plug-in-hand pose
        pq_gd, pp_gd = rot.tf_combine(ftc_q, ftc_t, gd(grasp_data.plug_quat_hand),
                                      gd(grasp_data.plug_pos_hand))
        plug_pos = _where(has, pp_gd, plug_pos)
        plug_quat = _where(has, pq_gd, plug_quat)

    # ---- close the hand ONTO the plug: per-finger bisection of the closure
    # fraction until each pad's predicted gel force (the patch spring model
    # the solver applies) hits a common target; equal force, not equal depth,
    # keeps the grasp torque-balanced
    prox_idx = [8, 11, 13]
    dist_idx = [9, 12, 14]
    prox_closed = q[:, prox_idx]
    dist_closed = q[:, dist_idx]

    def hand_at(f):
        p = oh.proximal_open + f * (prox_closed - oh.proximal_open)
        d = oh.distal_open + f * (dist_closed - oh.distal_open)
        return torch.cat([q[:, :7], q[:, 7:8], p[:, :1], d[:, :1], q[:, 10:11], p[:, 1:2],
                          d[:, 1:2], p[:, 2:], d[:, 2:]], dim=-1)

    com_w = plug_pos + rot.quat_apply(plug_quat, _z_offset(rows["plug_com_z"]))

    def pad_force(qf):
        _, tips = engine.fingertip_poses(model, forward_kinematics(model, qf))
        cs_f, _ = fingertip_plug_contacts(
            tips, torch.zeros_like(tips), plug_quat, plug_pos, com_w, rows["kind_onehot"],
            rows["plug_hx"], rows["plug_hy"], rows["plug_length"], base_params.contact)
        d = torch.clamp_min(cs_f.depth, 0.0).reshape(n, 3, PATCH_POINTS)
        return (GEL_STIFFNESS / PATCH_POINTS) * torch.sum(d, dim=-1)   # [n, 3] N

    target_force = 5.0   # N per pad: ≈2.5 mm pad indentation
    lo = torch.zeros((n, 3), device=dev)
    hi = torch.ones((n, 3), device=dev)
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        too_deep = pad_force(hand_at(mid)) > target_force
        hi = torch.where(too_deep, mid, hi)
        lo = torch.where(too_deep, lo, mid)
    f_touch = 0.5 * (lo + hi)
    q = hand_at(f_touch)
    # PD closure target slightly past touching keeps the grip active
    gripper_target = hand_at(torch.clamp_max(f_touch + 0.04, 1.0))[:, 7:]

    # ---- DR over physics params
    sock_scale = _uniform(gen, (n,), float(rz.socket_scale[0]), float(rz.socket_scale[1]), dev)
    if rz.clearance_curriculum_extra > 0.0:
        remain = 1.0 - min(float(global_step) / float(rz.clearance_curriculum_steps), 1.0)
        sock_scale = sock_scale * (1.0 + float(rz.clearance_curriculum_extra) * remain)
    mass_scale = _uniform(gen, (n,), float(rz.plug_mass_scale[0]), float(rz.plug_mass_scale[1]), dev)
    plug_fric_scale = _uniform(gen, (n,), float(rz.plug_friction_scale[0]),
                               float(rz.plug_friction_scale[1]), dev)
    sock_fric = _uniform(gen, (n,), float(rz.socket_friction_scale[0]),
                         float(rz.socket_friction_scale[1]), dev)
    mu_plug = PLUG_FRICTION * plug_fric_scale
    contact = MaterialParams(
        mu_socket=0.5 * (mu_plug + sock_fric),            # PhysX-style pair average
        mu_table=0.5 * (mu_plug + cfg.sim.table_friction),
        mu_finger=0.5 * (mu_plug + cfg.sim.kuka_friction),
    )

    gravity = torch.full((n,), 0.0 if cfg.sim.disable_gravity else cfg.sim.gravity, device=dev)
    if rz.domain_randomize and not cfg.sim.disable_gravity:
        gravity = dr_mod.apply_noise(rz.gravity, gen,
                                     dr_mod.sample_correlated(rz.gravity, gen, (n,), dev),
                                     gravity, global_step)

    params = base_params._replace(
        kind_onehot=rows["kind_onehot"],
        plug_hx=rows["plug_hx"],
        plug_hy=rows["plug_hy"],
        plug_length=rows["plug_length"],
        hole_hx=rows["hole_hx"] * sock_scale,
        hole_hy=rows["hole_hy"] * sock_scale,
        # the setup-only socket-scale DR scales the whole actor, height included
        socket_height=rows["socket_height"] * sock_scale,
        plug_scale=rows["plug_scale"],
        socket_scale=sock_scale,
        surface_points=rows["surface_points"],
        surface_weights=rows["surface_weights"],
        plug_mass=rows["plug_mass"] * mass_scale,
        plug_inertia=rows["plug_inertia"] * mass_scale[:, None],
        plug_com_z=rows["plug_com_z"],
        socket_pos=socket_pos,
        socket_quat=socket_quat,
        table_height=torch.full((n,), cfg.sim.table_height, device=dev),
        gravity=gravity,
        contact=contact,
    )
    z = lambda *s: torch.zeros((n,) + s, device=dev)
    phys = PhysicsState(q=q, qd=z(15), plug_pos=plug_pos, plug_quat=plug_quat, plug_v=z(3),
                        plug_w=z(3), ctrl_torque=z(15), tip_forces=z(3, 3), tip_fn=z(3))
    aux = dict(mu_plug=mu_plug, mu_socket=sock_fric, ftc_q=ftc_q, ftc_t=ftc_t,
               mass_scale=mass_scale, gripper_target=gripper_target)
    return phys, params, aux


def _pose_in_frame(pos, quat, frame_t, frame_q):
    inv_q, inv_t = rot.tf_inverse(frame_q, frame_t)
    return rot.tf_combine(inv_q, inv_t, quat, pos)


def _sensor_queues(cfg: TaskConfig, subs: SubassemblySet, n: int, dev) -> dict:
    """Zeroed sensor queues for the modalities that are on ([N, 0] otherwise)."""
    e = cfg.env
    tcfg, ccfg = tact_mod.TactileConfig(), cam_mod.CameraConfig()
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    zh = lambda *shape: torch.zeros(shape, dtype=torch.float16, device=dev)
    n_pcl = ((e.num_points if e.include_plug_pcl else 0)
             + (e.num_points_socket if e.merge_socket_pcl else 0)
             + (e.num_points_goal if e.merge_goal_pcl else 0))
    return dict(
        tactile_queue=zh(n, e.tactile_history_len, 3, tcfg.height, tcfg.width, tcfg.num_channels)
        if e.tactile else zh(n, 0),
        img_queue=zh(n, e.img_history_len, ccfg.height, ccfg.width)
        if (e.external_cam and e.depth_cam) else zh(n, 0),
        seg_queue=zh(n, e.img_history_len, ccfg.height, ccfg.width)
        if (e.external_cam and e.seg_cam) else zh(n, 0),
        pcl_queue=z(n, e.img_history_len, n_pcl, 3) if (e.external_cam and e.pcl_cam) else z(n, 0),
        contact_queue=z(n, e.ft_history_len, subs.dense_points.shape[1])
        if e.compute_contact_gt else z(n, 0),
    )


def reset_all(cfg: TaskConfig, model: RobotModel, subs: SubassemblySet, generator: torch.Generator,
              n: int, grasp_data=None) -> EnvState:
    """A fresh EnvState for the full batch, on the generator's device
    (`grasp_data`: resets from a grasp-dataset table)."""
    gen = generator
    dev = gen.device
    sub_idx = torch.randint(0, len(subs.names), (n,), generator=gen, device=dev)
    base_params = engine.make_params(subs, sub_idx, n)
    phys, params, aux = _sample_episode(cfg, model, subs, gen, n, sub_idx, base_params,
                                        grasp_data=grasp_data)

    e = cfg.env
    fk = forward_kinematics(model, phys.q)
    hand_q, hand_t = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
    ph_pos, ph_quat = _pose_in_frame(phys.plug_pos, phys.plug_quat, hand_t, hand_q)
    z = lambda *s: torch.zeros((n,) + s, device=dev)
    zi = lambda: torch.zeros((n,), dtype=torch.long, device=dev)
    zb = lambda: torch.zeros((n,), dtype=torch.bool, device=dev)
    randint = lambda lo, hi: torch.randint(lo, hi, (n,), generator=gen, device=dev)
    return EnvState(
        phys=phys,
        params=params,
        sub_idx=sub_idx,
        progress=zi(),
        frame=zi(),
        global_step=0,
        actions=z(6),
        prev_actions=z(6),
        applied_actions=z(6),
        actions_queue=z(ACTION_QUEUE_LEN, 6),
        action_latency=randint(0, 2),
        targets=z(6),
        gripper_target=aux["gripper_target"],
        obs_queue=z(e.num_obs_hist * e.num_observations),
        obs_stud_queue=z(e.num_obs_stud_hist * e.num_obs_student),
        obs_plug_pos_freq=phys.plug_pos,
        obs_plug_quat_freq=phys.plug_quat,
        obs_plug_pos=phys.plug_pos,
        obs_plug_quat=phys.plug_quat,
        plug_pose_refresh_rate=randint(1, e.max_object_skip_obs + 1),
        plug_pose_refresh_offset=randint(0, e.max_object_skip_obs),
        plug_hand_pos_init=ph_pos,
        plug_hand_quat_init=ph_quat,
        plug_pos_init=phys.plug_pos,
        obs_noise_corr=dr_mod.sample_correlated(cfg.randomize.observations, gen,
                                                (n, e.num_observations), dev),
        act_noise_corr=dr_mod.sample_correlated(cfg.randomize.actions, gen, (n, 6), dev),
        finger_forces_ema=z(3),
        rb_force=z(3),
        reset_buf=zb(),
        success_reset_buf=zb(),
        timeout_reset_buf=zb(),
        degrasp_buf=zb(),
        far_from_goal_buf=zb(),
        progress_change_tracker=zi(),
        ep_reward=z(),
        **_sensor_queues(cfg, subs, n, dev),
        tactile_refresh_rate=randint(1, e.max_skip_tactile + 1),
        tactile_refresh_offset=randint(0, e.max_skip_tactile),
        img_refresh_rate=randint(1, e.max_skip_img + 1),
        img_refresh_offset=randint(0, e.max_skip_img),
    )


def _reset_idx(cfg, model, subs, state: EnvState, mask: torch.Tensor,
               gen: torch.Generator, grasp_data=None) -> EnvState:
    """Masked re-init of done envs."""
    n = mask.shape[0]
    dev = mask.device
    new_sub = state.sub_idx if cfg.randomize.same_socket else torch.randint(
        0, len(subs.names), (n,), generator=gen, device=dev)
    sub_idx = torch.where(mask, new_sub, state.sub_idx)
    phys_new, params_new, aux = _sample_episode(cfg, model, subs, gen, n, sub_idx, state.params,
                                                global_step=state.global_step, grasp_data=grasp_data)
    phys = _masked_tree(mask, phys_new, state.phys)
    params = _masked_tree(mask, params_new, state.params)

    fk = forward_kinematics(model, phys_new.q)
    hand_q, hand_t = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
    ph_pos, ph_quat = _pose_in_frame(phys_new.plug_pos, phys_new.plug_quat, hand_t, hand_q)

    # annealed per-env action latency cap
    e = cfg.env
    cur_max = min(max((state.global_step * e.action_latency_cur_max)
                      // max(e.action_latency_scheduled_steps, 1), 1), e.action_latency_cur_max)
    lat = (torch.rand((n,), generator=gen, device=dev) * (float(cur_max) + 1.0)).long()

    zero6 = torch.zeros((n, 6), device=dev)
    zero3 = torch.zeros((n, 3), device=dev)
    randint = lambda lo, hi: torch.randint(lo, hi, (n,), generator=gen, device=dev)
    w = lambda new, old: _where(mask, new, old)
    return state._replace(
        phys=phys,
        params=params,
        sub_idx=sub_idx,
        progress=torch.where(mask, 0, state.progress),
        actions=w(zero6, state.actions),
        prev_actions=w(zero6, state.prev_actions),
        applied_actions=w(zero6, state.applied_actions),
        # correlated-DR window refresh (frequency 499 ≈ every episode)
        obs_noise_corr=w(dr_mod.sample_correlated(cfg.randomize.observations, gen,
                                                  (n, e.num_observations), dev),
                         state.obs_noise_corr),
        act_noise_corr=w(dr_mod.sample_correlated(cfg.randomize.actions, gen, (n, 6), dev),
                         state.act_noise_corr),
        actions_queue=w(torch.zeros_like(state.actions_queue), state.actions_queue),
        action_latency=torch.where(mask, lat, state.action_latency),
        targets=w(zero6, state.targets),
        gripper_target=w(aux["gripper_target"], state.gripper_target),
        obs_queue=w(torch.zeros_like(state.obs_queue), state.obs_queue),
        obs_stud_queue=w(torch.zeros_like(state.obs_stud_queue), state.obs_stud_queue),
        obs_plug_pos_freq=w(phys_new.plug_pos, state.obs_plug_pos_freq),
        obs_plug_quat_freq=w(phys_new.plug_quat, state.obs_plug_quat_freq),
        obs_plug_pos=w(phys_new.plug_pos, state.obs_plug_pos),
        obs_plug_quat=w(phys_new.plug_quat, state.obs_plug_quat),
        plug_pose_refresh_rate=torch.where(mask, randint(1, e.max_object_skip_obs + 1),
                                           state.plug_pose_refresh_rate),
        plug_pose_refresh_offset=torch.where(mask, randint(0, e.max_object_skip_obs),
                                             state.plug_pose_refresh_offset),
        plug_hand_pos_init=w(ph_pos, state.plug_hand_pos_init),
        plug_hand_quat_init=w(ph_quat, state.plug_hand_quat_init),
        plug_pos_init=w(phys_new.plug_pos, state.plug_pos_init),
        finger_forces_ema=w(zero3, state.finger_forces_ema),
        rb_force=w(zero3, state.rb_force),
        reset_buf=state.reset_buf & ~mask,
        success_reset_buf=state.success_reset_buf & ~mask,
        timeout_reset_buf=state.timeout_reset_buf & ~mask,
        degrasp_buf=state.degrasp_buf & ~mask,
        far_from_goal_buf=state.far_from_goal_buf & ~mask,
        progress_change_tracker=torch.where(mask, 0, state.progress_change_tracker),
        ep_reward=torch.where(mask, 0.0, state.ep_reward),
        **{k: (w(torch.zeros_like(getattr(state, k)), getattr(state, k))
               if getattr(state, k).numel() else getattr(state, k)) for k in SENSOR_QUEUES},
        tactile_refresh_rate=torch.where(mask, randint(1, e.max_skip_tactile + 1),
                                         state.tactile_refresh_rate),
        tactile_refresh_offset=torch.where(mask, randint(0, e.max_skip_tactile),
                                           state.tactile_refresh_offset),
        img_refresh_rate=torch.where(mask, randint(1, e.max_skip_img + 1), state.img_refresh_rate),
        img_refresh_offset=torch.where(mask, randint(0, e.max_skip_img), state.img_refresh_offset),
    )


# --------------------------------------------------------------------------- #
# step
# --------------------------------------------------------------------------- #


def _socket_tip(params: PhysicsParams) -> torch.Tensor:
    return rot.translate_along_local_z(params.socket_pos, params.socket_quat, params.socket_height)


def _physics_params_vec(cfg, params: PhysicsParams) -> torch.Tensor:
    """14-dim physics-param block of the priv state."""
    c = params.contact
    mu_plug = 2.0 * c.mu_table - cfg.sim.table_friction  # invert the pair average
    mu_socket = 2.0 * c.mu_socket - mu_plug
    finger_mu = torch.broadcast_to(2.0 * c.mu_finger - mu_plug, mu_plug.shape)
    return torch.stack([
        params.plug_mass, mu_plug, mu_socket, finger_mu, finger_mu, finger_mu,
        params.plug_length,          # plug_heights
        2.0 * params.plug_hy,        # plug_depths
        2.0 * params.plug_hx,        # plug_widths
        params.socket_height,        # socket_heights
        2.0 * params.hole_hy,        # socket_depths
        2.0 * params.hole_hx,        # socket_widths
        params.plug_scale,
        params.socket_scale,
    ], dim=-1)


def _hand_joints(q):
    return q[:, const(HAND_JOINT_IDX, q.device, torch.long)]


def priv_info_of(cfg: TaskConfig, model: RobotModel, state: EnvState) -> torch.Tensor:
    """The 64-dim privileged state of the current EnvState (the critic/priv
    input for the state before a step; `step` emits the same layout)."""
    phys, params = state.phys, state.params
    fk = forward_kinematics(model, phys.q)
    hand_q, hand_t = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
    socket_tip = _socket_tip(params)
    plug_tip = rot.translate_along_local_z(phys.plug_pos, phys.plug_quat, params.plug_length)
    ph_pos, ph_quat = _pose_in_frame(state.obs_plug_pos, state.obs_plug_quat, hand_t, hand_q)
    plug_pos_err, plug_quat_err = ctrlmod.get_pose_error(
        state.obs_plug_pos, state.obs_plug_quat, params.socket_pos, params.socket_quat,
        rot_error_type="quat")
    return torch.cat([
        _hand_joints(phys.q), phys.q[:, :7], phys.qd[:, :7], socket_tip, params.socket_pos,
        plug_tip, phys.plug_pos, phys.plug_quat, ph_pos, ph_quat, plug_pos_err, plug_quat_err,
        _physics_params_vec(cfg, params),
    ], dim=-1)


def step(cfg: TaskConfig, model: RobotModel, subs: SubassemblySet, state: EnvState,
         policy_actions: torch.Tensor, generator: torch.Generator, grasp_data=None, gan=None,
         dp=None):
    """One control step of the full env batch → (state', StepOutput).
    `grasp_data` makes the resets replay a grasp-dataset table; `gan`, a
    `ResnetGenerator`, translates the rendered tactile frames sim → real;
    `dp` makes `state` this rank's rows of a data-parallel batch (only the
    render-on-demand selection looks past them). The step is the span `env`."""
    with profiling.span("env"):
        return _step(cfg, model, subs, state, policy_actions, generator, grasp_data, gan, dp)


def _step(cfg, model, subs, state, policy_actions, generator, grasp_data, gan, dp):
    gen = generator
    n = policy_actions.shape[0]
    dev = policy_actions.device
    rz = cfg.randomize
    e = cfg.env

    # ---------------- pre-physics: reset done envs (rare: skipped on the host)
    with profiling.span("env.sync"):
        any_reset = bool(state.reset_buf.any())
    if any_reset:
        with profiling.span("env.reset"):
            state = _reset_idx(cfg, model, subs, state, state.reset_buf, gen, grasp_data=grasp_data)
    gs = state.global_step

    # action DR noise (white + correlated, held per randomization window)
    actions = torch.clamp(policy_actions, -1.0, 1.0)
    if rz.domain_randomize:
        actions = dr_mod.apply_noise(rz.actions, gen, state.act_noise_corr, actions, gs)
    prev_actions = state.actions
    # latency queue: newest at slot 0
    queue = torch.cat([actions[:, None], state.actions_queue[:, :-1]], dim=1)
    lat = torch.clamp(state.action_latency, 0, ACTION_QUEUE_LEN - 1).long()
    delayed = torch.gather(queue, 1, lat[:, None, None].expand(n, 1, queue.shape[-1]))[:, 0]
    delay_mask = torch.rand((n, 1), generator=gen, device=dev) > e.action_delay_prob_max
    actions_applied = torch.where(delay_mask, delayed, prev_actions)

    # action moving-average schedule: the scalar anneals upper → lower over
    # schedule_steps; with env.action_ema the applied actions are smoothed
    ma_lo, ma_up = e.actions_moving_average_range
    ma_steps = max(e.actions_moving_average_schedule_steps, 1)
    ma_freq = max(e.actions_moving_average_schedule_freq, 1)
    quant = (gs // ma_freq) * ma_freq
    act_ma = ma_up + (ma_lo - ma_up) * (float(min(quant, ma_steps)) / float(ma_steps))
    if e.action_ema:
        actions_applied = act_ma * actions_applied + (1.0 - act_ma) * state.applied_actions

    # action scale DR
    pos_scale = _f32(cfg.rl.pos_action_scale, dev)
    rot_scale = _f32(cfg.rl.rot_action_scale, dev)
    if rz.domain_randomize:
        pos_noise = _sym_noise(gen, (n, 3), rz.scale_noise_pos, dev)
        rot_noise = _sym_noise(gen, (n, 3), rz.scale_noise_rot, dev)
        pos_on = torch.rand((n, 1), generator=gen, device=dev) > 1 - e.scale_pos_prob
        rot_on = torch.rand((n, 1), generator=gen, device=dev) > e.scale_rot_prob
        pos_scale = torch.clamp_min(pos_scale + pos_noise * pos_on, 0.0)
        rot_scale = torch.clamp_min(rot_scale + rot_noise * rot_on, 0.0)
    pos_actions = actions_applied[:, :3] * pos_scale
    rot_actions = actions_applied[:, 3:6] * rot_scale

    # ---------------- control targets → q_target (IK, gym_default path)
    fk = forward_kinematics(model, state.phys.q)
    ftc_q, ftc_t = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
    target_pos = ftc_t + pos_actions
    angle = torch.linalg.norm(rot_actions, dim=-1)
    axis = rot_actions / torch.clamp_min(angle[:, None], 1e-9)
    dquat = rot.quat_from_angle_axis(angle, axis)
    if cfg.rl.clamp_rot:
        ident = _f32([0.0, 0.0, 0.0, 1.0], dev)
        dquat = torch.where((angle > cfg.rl.clamp_rot_thresh)[:, None], dquat, ident)
    target_quat = rot.quat_mul(dquat, ftc_q)

    J_ftc = point_jacobian(model, fk, ftc_t, 6)[..., :7]
    # constant closure target from reset: re-targeting the current finger
    # pose would make the grip zero-stiffness
    gripper_target = state.gripper_target
    q_target = ctrlmod.compute_dof_pos_target(state.phys.q[:, :7], ftc_t, ftc_q, J_ftc,
                                              target_pos, target_quat, gripper_target)
    tau_cmd = torch.zeros_like(q_target)
    torque_mask = torch.zeros((15,), device=dev)
    if cfg.ctrl_type not in ("gym_default", "joint_space_ik"):
        # torque-control modes: arm rows torque-driven, gripper rows stay PD
        from ..physics.dynamics import mass_matrix

        ctrl_cfg = ctrlmod.DEFAULT_CTRL_CFGS[cfg.ctrl_type]
        tip_vel6 = torch.einsum("...ij,...j->...i", point_jacobian(model, fk, ftc_t, 6),
                                state.phys.qd)
        M_arm = mass_matrix(model, state.phys.q)[:, :7, :7]
        wrench_target = torch.zeros((n, 6), device=dev)
        if cfg.rl.unidirectional_force:
            wrench_target[:, 2] = -1.0
        tau_cmd = ctrlmod.compute_dof_torque(
            ctrl_cfg, state.phys.q, state.phys.qd, ftc_t, ftc_q, tip_vel6[..., :3],
            tip_vel6[..., 3:], state.phys.tip_forces[:, 0], state.phys.tip_forces[:, 1], J_ftc,
            M_arm, gripper_target, target_pos, target_quat, wrench_target)
        torque_mask = torch.cat([torch.ones((7,), device=dev), torch.zeros((8,), device=dev)])

    # random plug disturbance wrench (Dactyl-style)
    if rz.force_scale > 0.0:
        rbf = state.rb_force * (0.99 ** (cfg.sim.dt / 0.08))
        hit = torch.rand((n, 1), generator=gen, device=dev) < 0.01
        new_f = (torch.randn((n, 3), generator=gen, device=dev)
                 * state.params.plug_mass[:, None] * rz.force_scale)
        rbf = torch.where(hit, new_f, rbf)
    else:
        rbf = state.rb_force * 0.0
    wrench = torch.cat([rbf, torch.zeros((n, 3), device=dev)], dim=-1)
    ctrl = ControlInput(q_target=q_target, tau_cmd=tau_cmd, torque_mode_mask=torque_mask,
                        plug_wrench=wrench)

    # ---------------- physics
    phys = engine.step(model, state.params, state.phys, ctrl, dt=cfg.sim.dt,
                       n_substeps=cfg.sim.substeps, smooth_force=0.9 if e.smooth_force else 0.0,
                       solver_iters=cfg.sim.solver_iters)

    # ---------------- post-physics: derived tensors
    params = state.params
    progress = state.progress + 1
    frame = state.frame + 1
    fk2 = forward_kinematics(model, phys.q)
    ftc_q2, ftc_t2 = site_pose(model, fk2, SITE_FINGERTIP_CENTERED)
    socket_tip = _socket_tip(params)
    plug_tip = rot.translate_along_local_z(phys.plug_pos, phys.plug_quat, params.plug_length)
    ema = 0.9 if e.smooth_force else 0.0
    finger_forces_ema = ((1 - ema) * torch.linalg.norm(phys.tip_forces, dim=-1)
                         + ema * state.finger_forces_ema)

    # ---------------- sensor modalities (decimation + delay)
    with profiling.span("sensors"):
        queues, render_overflow, render_rows = _sensor_step(cfg, model, subs, state, phys, fk2, ftc_t2,
                                                            frame, progress, finger_forces_ema, gen, gan, dp)

    # ---------------- observation staleness (decimation + delay)
    refresh = ((frame + state.plug_pose_refresh_offset) % state.plug_pose_refresh_rate) == 0
    obs_plug_pos_freq = _where(refresh, phys.plug_pos, state.obs_plug_pos_freq)
    obs_plug_quat_freq = _where(refresh, phys.plug_quat, state.obs_plug_quat_freq)
    upd = torch.rand((n,), generator=gen, device=dev) > e.plug_obs_delay_prob
    obs_plug_pos = _where(upd, obs_plug_pos_freq, state.obs_plug_pos)
    obs_plug_quat = _where(upd, obs_plug_quat_freq, state.obs_plug_quat)

    # ---------------- teacher/student obs (15 = eef pos 3 + rot6d 6 + actions 6)
    eef_pos_rb, eef_quat_rb = world_to_robot_base(ftc_t2, ftc_q2)
    obs = torch.cat([eef_pos_rb, rot.quat_to_rot6d(eef_quat_rb), actions], dim=-1)
    if rz.domain_randomize:
        obs = dr_mod.apply_noise(rz.observations, gen, state.obs_noise_corr, obs, gs)
    no = e.num_observations
    obs_queue = torch.cat([state.obs_queue[:, no:], obs], dim=-1)
    obs_stud_queue = torch.cat([state.obs_stud_queue[:, no:], obs], dim=-1)

    # ---------------- priv state (64 = 50 state + 14 physics params)
    ph_pos, ph_quat = _pose_in_frame(obs_plug_pos, obs_plug_quat, ftc_t2, ftc_q2)
    sock_priv_noise = _sym_noise(gen, (n, 3), e.socket_priv_obs_noise, dev)
    plug_pos_err, plug_quat_err = ctrlmod.get_pose_error(
        obs_plug_pos, obs_plug_quat, params.socket_pos + sock_priv_noise, params.socket_quat,
        rot_error_type="quat")
    priv = torch.cat([
        _hand_joints(phys.q),   # 6
        phys.q[:, :7],          # 7 arm_dof_pos
        phys.qd[:, :7],         # 7 arm_dof_vel
        socket_tip,             # 3
        params.socket_pos,      # 3
        plug_tip,               # 3
        phys.plug_pos,          # 3
        phys.plug_quat,         # 4
        ph_pos,                 # 3
        ph_quat,                # 4
        plug_pos_err,           # 3
        plug_quat_err,          # 4
        _physics_params_vec(cfg, params),  # 14
    ], dim=-1)

    # ---------------- termination
    success = _check_inserted(cfg, phys, params, socket_tip)
    timeout = progress >= (cfg.rl.max_episode_length - 1)
    degrasp = torch.any(torch.abs(rot.euler_xyz_signed(phys.plug_quat)) > 0.4, dim=-1)
    far = torch.linalg.norm(phys.plug_pos - params.socket_pos, dim=-1) > 0.3
    reset = timeout
    if cfg.reset_at_fails:
        # env 0 always runs full episodes for logging (reference quirk)
        reset = reset | (degrasp & (torch.arange(n, device=dev) > 0))
    tracker = state.progress_change_tracker + success.long()
    if cfg.reset_at_success:
        reset = reset | (tracker >= 100)

    # ---------------- reward
    rew, rew_terms = _compute_reward(cfg, params, phys, actions, prev_actions, socket_tip,
                                     success, degrasp, far)
    ep_reward = state.ep_reward + rew
    extras = {
        "successes": ((timeout | degrasp | far) & success).float(),
        "keypoint_reward": rew_terms["keypoint"],
        "engagement_reward": rew_terms["engagement"],
        "ori_reward": rew_terms["ori"],
        "degrasp": degrasp.float(),
        "ep_reward": ep_reward,
        "action_moving_average_scalar": torch.full((n,), act_ma, device=dev),
        # render-on-demand starvation: env rows that wanted a fresh sensor
        # frame this step but were past render_capacity (0 when capacity = 1)
        "render_overflow": render_overflow.expand(n),
        # env rows the tactile and camera renderers drew this step, here (host ints)
        "render_rows": render_rows,
    }

    new_state = state._replace(
        phys=phys, progress=progress, frame=frame, global_step=gs + 1, actions=actions,
        prev_actions=prev_actions, applied_actions=actions_applied, actions_queue=queue,
        targets=state.targets + torch.cat([pos_actions, rot_actions], dim=-1),
        obs_queue=obs_queue, obs_stud_queue=obs_stud_queue, obs_plug_pos_freq=obs_plug_pos_freq,
        obs_plug_quat_freq=obs_plug_quat_freq, obs_plug_pos=obs_plug_pos,
        obs_plug_quat=obs_plug_quat, finger_forces_ema=finger_forces_ema, rb_force=rbf,
        reset_buf=reset, success_reset_buf=success, timeout_reset_buf=timeout | reset,
        degrasp_buf=degrasp, far_from_goal_buf=far, progress_change_tracker=tracker,
        ep_reward=ep_reward, **queues,
    )
    out = StepOutput(obs=obs_queue, student_obs=obs_stud_queue, priv_info=priv, rew=rew,
                     reset=reset, timeout=timeout, extras=extras,
                     # the image queues are stored f16; consumers see f32
                     tactile=queues["tactile_queue"].float(), img=queues["img_queue"].float(),
                     seg=queues["seg_queue"].float(), pcl=queues["pcl_queue"],
                     contacts=queues["contact_queue"])
    return new_state, out


def _push(latest, queue):
    """FIFO push: the newest frame enters at slot 0."""
    return torch.cat([latest[:, None], queue[:, :-1]], dim=1)


def render_count(n: int, capacity: float) -> int:
    """Rows the render-on-demand path draws out of a batch of `n`: ceil(capacity·n)
    rounded up to a multiple of 8, at least 8, at most n."""
    return min(n, max(8, -(-int(capacity * n) // 8) * 8))


def render_selection(prio: torch.Tensor, capacity: float, global_step: int, dp=None) -> torch.Tensor:
    """The rows to render this step, lowest priority rank first: the
    `render_count` rows of the batch, the tie-break rotating with global_step. With `dp` the priorities [N / W] are
    this rank's rows: the selection is made over the gathered global [N]
    vector, and this rank gets the selected rows that it owns (local indices,
    in the global order; possibly none)."""
    n = prio.shape[0] if dp is None else prio.shape[0] * dp.world_size
    if dp is not None:
        prio = mesh.all_gather_rows(prio, dp)
    k = render_count(n, capacity)
    # int64 arithmetic: the reference's int32 product wraps after ~271k steps
    rotate = (torch.arange(n, device=prio.device) + global_step * 7919) % n
    sel = torch.argsort(prio.long() * n + rotate, stable=True)[:k]
    if dp is None:
        return sel
    lo, hi = dp.rows(n)
    return sel[(sel >= lo) & (sel < hi)] - lo


def _rows_consumed(consume, sel):
    """The rendered rows (the selection `sel`, or every row) in `consume`."""
    return consume.sum() if sel is None else consume[sel].sum()


def _sensor_step(cfg, model, subs, state: EnvState, phys: PhysicsState, fk2, ftc_t2, frame,
                 progress, finger_forces_ema, gen, gan=None, dp=None):
    """Render the sensor modalities that are on and push them into their
    queues → (the five queues, dropped consumers this step [scalar], rows the
    tactile and camera renderers drew as two host ints).

    Render-on-demand (`env.render_capacity` < 1): the decimation and delay
    pipeline discards most frames, so instead of rendering all N envs and
    masking, the ceil(capacity·N) env rows that consume a fresh frame this
    step (lowest priority rank first) are gathered, rendered and scattered
    back. Consumers past capacity keep their stale frame one more step; the
    tie-break rotates with global_step so a burst of equal-rank rows drains
    across consecutive steps instead of starving the high indices. With `dp`
    the selection is global (`render_selection`) and a rank that owns none of
    the selected rows renders nothing."""
    e = cfg.env
    params = state.params
    n = progress.shape[0]
    dev = progress.device
    queues = {k: getattr(state, k) for k in SENSOR_QUEUES}
    render_overflow = torch.zeros((), device=dev)
    render_rows = [0, 0]
    use_sel = 0.0 < e.render_capacity < 1.0
    rand = lambda: torch.rand((n,), generator=gen, device=dev)

    def render_sel(prio):
        return render_selection(prio, e.render_capacity, state.global_step, dp)

    def overflow_of(sel, consume):
        in_sel = torch.zeros((n,), dtype=torch.bool, device=dev)
        in_sel[sel] = True
        return torch.sum((consume & ~in_sel).float())

    def latest_of(sel, upd, new_rows, prev):
        """Frames at queue slot 0 after this step: fresh where `upd`, else kept."""
        if sel is None:
            return _where(upd, new_rows, prev)
        out = prev.clone()
        out[sel] = _where(upd[sel], new_rows, prev[sel])
        return out

    if e.tactile:
        with profiling.span("sensors.tactile"):
            t_refresh = ((frame + state.tactile_refresh_offset) % state.tactile_refresh_rate) == 0
            t_upd = t_refresh & (rand() > e.tactile_delay_prob)
            tip_q3, tip_t3 = engine.fingertip_poses(model, fk2)
            # the gel-scene plug is scaled by the asset's scale column
            psc = params.plug_scale
            sel_t = render_sel(torch.where(t_upd, 0, 1)) if use_sel else None
            if use_sel:
                render_overflow = render_overflow + overflow_of(sel_t, t_upd)
            gt = (lambda x: x[sel_t]) if use_sel else (lambda x: x)
            tq = state.tactile_queue
            render_rows[0] = n if sel_t is None else sel_t.shape[0]
            profiling.count("sensors.rows_rendered", render_rows[0])
            profiling.count("sensors.rows_consumed", lambda: _rows_consumed(t_upd, sel_t))
            if render_rows[0] == 0:   # a rank that owns none of the selected rows
                queues["tactile_queue"] = _push(tq[:, 0], tq)
            else:
                timg = tact_mod.render_tactile(
                    tact_mod.TactileConfig(), gt(tip_q3), gt(tip_t3), gt(phys.plug_quat), gt(phys.plug_pos),
                    gt(params.kind_onehot), gt(params.plug_hx * psc), gt(params.plug_hy * psc),
                    gt(params.plug_length * psc), gt(finger_forces_ema), generator=gen, noise_std=0.01)
                if gan is not None:
                    # CycleGAN sim→real on the rendered frames; the generator is tanh-ranged
                    out_g = gan(timg.reshape((-1,) + timg.shape[2:]) * 2.0 - 1.0)
                    timg = (out_g.reshape(timg.shape) + 1.0) * 0.5
                queues["tactile_queue"] = _push(latest_of(sel_t, t_upd, timg.to(tq.dtype), tq[:, 0]), tq)
    if e.external_cam:
        with profiling.span("sensors.camera"):
            ccfg = cam_mod.CameraConfig()
            i_refresh = ((frame + state.img_refresh_offset) % state.img_refresh_rate) == 0
            initial = progress < 10
            i_upd = i_refresh & (initial | (rand() > e.img_delay_prob))
            s_upd = i_refresh & (initial | (rand() > e.seg_delay_prob))
            # one gathered row set serves depth+seg+pcl (all consume on i_refresh);
            # `initial` rows rank first: they must render at least once inside the
            # 10-step post-reset window for the frozen socket-pcl capture
            sel_c = render_sel(torch.where(initial, 0, torch.where(i_refresh, 1, 2))) if use_sel else None
            if use_sel:
                render_overflow = render_overflow + overflow_of(sel_c, initial | i_upd | s_upd)
            render_rows[1] = n if sel_c is None else sel_c.shape[0]
            profiling.count("sensors.rows_rendered", render_rows[1])
            profiling.count("sensors.rows_consumed", lambda: _rows_consumed(initial | i_upd | s_upd, sel_c))
            if render_rows[1] == 0:   # a rank that owns none of the selected rows
                for name, on in (("img_queue", e.depth_cam), ("seg_queue", e.seg_cam),
                                 ("pcl_queue", e.pcl_cam)):
                    if on:
                        queues[name] = _push(queues[name][:, 0], queues[name])
            else:
                gc = (lambda x: x[sel_c]) if use_sel else (lambda x: x)
                # the descending hand occludes the scene in the depth/seg frames: proxy
                # it as 3 fingertip spheres (12 mm) + a wrist→palm capsule (32 mm) that
                # ends at the palm, 55% of the way from the fingertips to the wrist, so
                # the grasped plug reads through the finger gaps
                cam_tips = engine.fingertip_poses(model, fk2)[1]
                cam_wrist = fk2.body_t[..., 6, :]
                cam_palm = ftc_t2 + 0.55 * (cam_wrist - ftc_t2)
                depth_n, seg_im, depth_raw = cam_mod.render_depth_seg(
                    ccfg, gc(phys.plug_quat), gc(phys.plug_pos), gc(params.socket_quat),
                    gc(params.socket_pos), gc(params.kind_onehot), gc(params.plug_hx), gc(params.plug_hy),
                    gc(params.plug_length), gc(params.hole_hx), gc(params.hole_hy),
                    gc(params.socket_height), gc(params.table_height), generator=gen,
                    tip_pos=gc(cam_tips), wrist_pos=gc(cam_wrist), hand_pos=gc(cam_palm),
                    tip_radius=0.012, hand_radius=0.032)
                nr = seg_im.shape[0]
                if e.depth_cam:
                    iq = state.img_queue
                    queues["img_queue"] = _push(latest_of(sel_c, i_upd, depth_n.to(iq.dtype), iq[:, 0]), iq)
                if e.seg_cam:
                    sq = state.seg_queue
                    noisy = gc(~initial) & (torch.rand((nr,), generator=gen, device=dev) > 1 - e.seg_prob_noise)
                    seg_noisy = torch.where(noisy[:, None, None],
                                            cam_mod.seg_noise(seg_im, gen, e.seg_prob_noise), seg_im)
                    queues["seg_queue"] = _push(latest_of(sel_c, s_upd, seg_noisy.to(sq.dtype), sq[:, 0]), sq)
                if e.pcl_cam:
                    pq = state.pcl_queue
                    dense = const(subs.dense_points, dev)[gc(state.sub_idx)]
                    goal_pts = gc(params.socket_pos)[:, None, :] + rot.quat_apply(
                        gc(params.socket_quat)[:, None, :], dense)
                    merged = pcl_mod.assemble_scene_pcl(
                        ccfg, depth_raw, seg_im, goal_pts, gen, num_plug=e.num_points,
                        num_socket=e.num_points_socket, num_goal=e.num_points_goal,
                        include_plug=e.include_plug_pcl, merge_socket=e.merge_socket_pcl,
                        merge_goal=e.merge_goal_pcl, include_all=e.include_all_pcl)
                    if e.merge_socket_pcl and e.include_plug_pcl:
                        # the socket slice is captured once per episode (progress < 10,
                        # before the descending plug occludes it) and then frozen
                        s0, s1 = e.num_points, e.num_points + e.num_points_socket
                        sock = _where(gc(initial), merged[:, s0:s1], gc(pq[:, 0, s0:s1]))
                        merged = torch.cat([merged[:, :s0], sock, merged[:, s1:]], dim=1)
                    p_noise_on = gc(~initial) & (torch.rand((nr,), generator=gen, device=dev)
                                                 > 1 - e.pcl_prob_noise)
                    merged = pcl_mod.augment_pcl(merged, gen, pcl_mod.PclAugmentConfig(), p_noise_on)
                    queues["pcl_queue"] = _push(latest_of(sel_c, i_upd, merged, pq[:, 0]), pq)
    if e.compute_contact_gt:
        dense = const(subs.dense_points, dev)[state.sub_idx]
        contacts = cgt_mod.extrinsic_contact(
            dense, phys.plug_quat, phys.plug_pos, params.socket_quat, params.socket_pos,
            params.kind_onehot, params.hole_hx, params.hole_hy, params.socket_height, gen)
        queues["contact_queue"] = _push(contacts, state.contact_queue)
    return queues, render_overflow, tuple(render_rows)


def _check_close(cfg, phys, socket_tip):
    return torch.linalg.norm(phys.plug_pos[:, :2] - socket_tip[:, :2], dim=-1) < cfg.rl.close_error_thresh


def _check_inserted(cfg, phys, params, socket_tip):
    """Plug below the socket tip − 5 mm AND within 5 mm in XY."""
    below = phys.plug_pos[:, 2] <= (socket_tip[:, 2] - cfg.rl.success_height_thresh)
    return below & _check_close(cfg, phys, socket_tip)


def _check_engaged(cfg, phys, socket_tip):
    return (phys.plug_pos[:, 2] < socket_tip[:, 2]) & _check_close(cfg, phys, socket_tip)


def _compute_reward(cfg, params, phys, actions, prev_actions, socket_tip, success, degrasp, far):
    dev = actions.device
    action_pen = torch.linalg.norm(actions, dim=-1)
    action_delta_pen = torch.linalg.norm(actions - prev_actions, dim=-1)
    ori_pen = torch.linalg.norm(phys.plug_quat - params.socket_quat, dim=-1)

    # keypoints along +z of the plug/socket frames, scaled by socket height
    offs = _f32(np.linspace(0.0, 1.0, cfg.rl.num_keypoints), dev) * params.socket_height[:, None]
    offs3 = _z_offset(offs)                                           # [N, K, 3]
    kp_plug = phys.plug_pos[:, None, :] + rot.quat_apply(phys.plug_quat[:, None, :], offs3)
    kp_sock = params.socket_pos[:, None, :] + rot.quat_apply(params.socket_quat[:, None, :], offs3)
    keypoint_dist = torch.sum(torch.linalg.norm(kp_sock - kp_plug, dim=-1), dim=-1)
    keypoint_rew = keypoint_dist * cfg.rl.keypoint_reward_scale

    engaged = _check_engaged(cfg, phys, socket_tip)
    height_dist = phys.plug_pos[:, 2] - params.socket_pos[:, 2]
    height_rew = 1.0 / ((height_dist - cfg.rl.success_height_thresh) + 0.1)
    quat_diff = rot.quat_mul(phys.plug_quat, rot.quat_conjugate(params.socket_quat))
    rot_dist = 2.0 * torch.asin(torch.clamp(torch.linalg.norm(quat_diff[:, :3], dim=-1), 0.0, 1.0))
    ori_engagement = 1.0 / (torch.abs(rot_dist) + 0.1)
    engagement = torch.where(engaged, height_rew + ori_engagement, 0.0)
    engagement_rew = engagement * cfg.rl.engagement_reward_scale

    early_reset_rew = (far | degrasp).float() * cfg.rl.early_reset_reward_scale
    ori_rew = ori_pen * cfg.rl.ori_reward_scale
    succ_f = success.float()
    rew = (keypoint_rew + engagement_rew + ori_rew
           + action_pen * cfg.rl.action_penalty_scale * succ_f
           + action_delta_pen * cfg.rl.action_delta_scale * succ_f
           + early_reset_rew)
    return rew, {"keypoint": keypoint_rew, "engagement": engagement_rew, "ori": ori_rew}


# --------------------------------------------------------------------------- #
# state conversion
# --------------------------------------------------------------------------- #


def _fields(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def env_state_from_numpy(tree, device) -> EnvState:
    """The port's EnvState from the reference's EnvState given as host
    (numpy) arrays: a NamedTuple or a mapping with nested `phys`, `params`
    and `params.contact`. The reference's `rng` key is dropped (the port
    draws from a torch.Generator); float16 queues stay float16."""
    dev = torch.device(device)

    def t(a):
        a = np.array(a)  # a writable host copy
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=dev)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int64), device=dev)
        if a.dtype == np.float16:
            return torch.as_tensor(a, device=dev)
        return torch.as_tensor(a.astype(np.float32), device=dev)

    src = _fields(tree)
    pf = _fields(src["params"])
    params = PhysicsParams(**{k: (MaterialParams(**{c: t(v) for c, v in _fields(pf[k]).items()})
                                  if k == "contact" else t(pf[k]))
                              for k in PhysicsParams._fields})
    phys = PhysicsState(**{k: t(v) for k, v in _fields(src["phys"]).items()})
    rest = {k: t(src[k]) for k in EnvState._fields if k not in ("phys", "params", "global_step")}
    return EnvState(phys=phys, params=params, global_step=int(np.asarray(src["global_step"])),
                    **rest)
