"""Task configuration tree (parity with cfg/task/FactoryTaskInsertionTactile.yaml).

A snapshot of the port's module, itself a copy of `isaacgyminsertion_tpu/envs/config.py` with the same fields and
defaults. Key names follow the reference's Hydra tree so the shell recipes
translate 1:1. Plain frozen dataclasses, read on the host by the env step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .dr import NoiseSpec


@dataclass(frozen=True)
class SimConfig:
    # FactoryBaseTactile.yaml sim block
    dt: float = 1.0 / 60.0
    substeps: int = 3          # + solver_iters Jacobi iters (parity: PhysX substeps 3, TGS 16)
    solver_iters: int = 16     # Jacobi velocity-solver iterations per substep
    gravity: float = -9.81
    disable_gravity: bool = True   # FactoryTaskInsertionTactile.yaml sim.disable_gravity
    table_height: float = 0.001
    kuka_friction: float = 1.0
    table_friction: float = 0.3


@dataclass(frozen=True)
class OpenhandConfig:
    # env.openhand block
    distal_open: float = 0.1
    distal_close: float = 0.4
    proximal_open: float = 1.0
    proximal_close: float = 2.4
    proximal_noise: float = 0.1
    distal_noise: float = 0.2
    base_angle: float = 0.7


@dataclass(frozen=True)
class EnvConfig:
    num_envs: int = 128
    num_observations: int = 15
    num_obs_student: int = 15
    num_states: int = 64
    num_actions: int = 6
    num_obs_hist: int = 1
    num_obs_stud_hist: int = 1
    img_history_len: int = 1
    tactile_history_len: int = 1
    ft_history_len: int = 1
    smooth_force: bool = True
    openhand: OpenhandConfig = field(default_factory=OpenhandConfig)
    # action pipeline
    action_latency_max: int = 15          # queue capacity
    action_latency_cur_max: int = 10      # env.actionLatencyMax (annealed cap)
    action_latency_scheduled_steps: int = 10_000_000
    action_delay_prob_max: float = 0.2
    # DEVIATION from reference (documented): the reference computes this EMA
    # schedule scalar but never blends with it (factory_task_insertion.py:
    # 585-600 only logs it). With action_ema=True we apply the DeXtreme-style
    # smoothing the schedule exists for — a deliberate training lever that
    # measurably reduced degrasp collapse (ROUND2_NOTES §3). Set False for
    # exact reference action dynamics. All banked round-2+ teacher/student
    # checkpoints were trained AND evaluated with it on, so their
    # authoritative numbers assume the default.
    action_ema: bool = True
    actions_moving_average_range: tuple = (0.15, 0.35)
    actions_moving_average_schedule_steps: int = 1_000_000
    actions_moving_average_schedule_freq: int = 500
    # obs delay/decimation
    plug_obs_delay_prob: float = 0.2
    img_delay_prob: float = 0.1
    pcl_prob_noise: float = 0.7
    seg_delay_prob: float = 0.1
    seg_prob_noise: float = 0.1
    tactile_delay_prob: float = 0.1
    scale_pos_prob: float = 0.3
    scale_rot_prob: float = 0.3
    max_object_skip_obs: int = 2
    max_skip_img: int = 2
    max_skip_tactile: int = 2
    # reset control loops
    num_gripper_move_sim_steps: int = 120
    num_gripper_close_sim_steps: int = 50
    num_gripper_lift_sim_steps: int = 25
    # socket obs noise
    socket_priv_obs_noise: tuple = (0.0, 0.0, 0.0)
    socket_pos_obs_noise: tuple = (0.005, 0.005, 0.005)
    socket_rot_obs_noise: tuple = (0.0, 0.0, 0.0)
    socket_base_height: float = 0.003
    plug_grasp_threshold: float = 0.01
    # render-on-demand: when < 1.0, each step renders tactile/camera frames
    # only for a gathered subset of ceil(capacity·N) envs, prioritized by
    # whether the env consumes a fresh frame this step (decimation refresh ∧
    # delay draw). With max_skip=2 an expected 0.675 of envs consume per step,
    # so 0.75 loses nothing; consumers beyond capacity (vanishing binomial
    # tail) keep their stale frame. 1.0 = render all envs (reference
    # semantics; frames that miss the refresh window are discarded).
    render_capacity: float = 1.0
    # modality flags
    tactile: bool = False
    compute_contact_gt: bool = False
    external_cam: bool = False
    pcl_cam: bool = False
    seg_cam: bool = False
    depth_cam: bool = False
    # pcl sizes (task cfg env block)
    total_points: int = 2048
    num_points: int = 400
    num_points_socket: int = 400
    num_points_goal: int = 400
    merge_goal_pcl: bool = False
    merge_socket_pcl: bool = True
    include_all_pcl: bool = False
    include_plug_pcl: bool = True
    relative_pcl: bool = False


@dataclass(frozen=True)
class RandomizeConfig:
    # randomize block
    domain_randomize: bool = True
    force_scale: float = 0.0
    # randomization_params entries (envs/dr.py engine; vec_task.py:664-748
    # parity: white + correlated components, linear/constant schedules).
    # Defaults = FactoryEnvInsertionTactile.yaml randomize block.
    observations: "NoiseSpec" = field(
        default_factory=lambda: NoiseSpec(range=(0.0, 0.002)))
    actions: "NoiseSpec" = field(
        default_factory=lambda: NoiseSpec(range=(0.0, 0.02),
                                          range_correlated=(0.0, 0.01)))
    gravity: "NoiseSpec" = field(
        default_factory=lambda: NoiseSpec(range=(0.0, 0.4)))
    frequency: int = 499              # randomization window (steps); 499 ⇒ every episode
    plug_mass_scale: tuple = (0.5, 1.1)
    plug_friction_scale: tuple = (0.9, 1.3)
    socket_friction_scale: tuple = (0.3, 0.9)
    socket_scale: tuple = (1.0, 1.1)
    # clearance curriculum (training recipe, no reference counterpart): an
    # EXTRA socket-scale factor that decays linearly from (1 + extra) at
    # global_step 0 to 1 at `clearance_curriculum_steps`, making early
    # insertions low-risk (counters the hover-collapse: insertion attempts
    # are rational when the hole is loose) and annealing to the true fit.
    # 0.0 disables (default: exact reference distribution).
    # `steps` is in global_step units (env-step calls, like NoiseSpec
    # schedules): 40k calls at 1024 envs = ~41M agent steps
    clearance_curriculum_extra: float = 0.0
    clearance_curriculum_steps: float = 40_000.0
    friction_num_buckets: int = 250
    kuka_arm_initial_dof_pos: tuple = (0.0064, 0.2375, -0.0075, -1.2022, 0.0015, 1.69, -1.5699)
    fingertip_midpoint_rot_initial: tuple = (-3.14159265359, 0.0, -1.57079632679)
    same_socket: bool = False
    grasp_plug_noise: float = 0.003
    plug_pos_xy_noise: tuple = (0.01, 0.01)
    plug_rot_noise: tuple = (0.3, 0.3, 0.3)
    plug_pos_z_noise_bounds: tuple = (0.05, 0.08)
    socket_pos_xy_initial: tuple = (0.5, 0.0)
    socket_pos_xy_noise: tuple = (0.05, 0.05)
    socket_pos_z_noise_bounds: tuple = (0.0, 0.05)
    socket_rot_euler_noise: tuple = (0.0, 0.0, 0.0872665)
    scale_noise_pos: tuple = (0.002, 0.002, 0.002)
    scale_noise_rot: tuple = (0.01, 0.01, 0.01)


@dataclass(frozen=True)
class RLConfig:
    pos_action_scale: tuple = (0.01, 0.01, 0.01)
    rot_action_scale: tuple = (0.05, 0.05, 0.05)
    force_action_scale: tuple = (1.0, 1.0, 1.0)
    torque_action_scale: tuple = (1.0, 1.0, 1.0)
    unidirectional_rot: bool = True
    unidirectional_force: bool = False
    clamp_rot: bool = True
    clamp_rot_thresh: float = 1.0e-6
    num_keypoints: int = 4
    keypoint_scale: float = 1.0
    max_episode_length: int = 500
    orientation_threshold: float = 0.1
    far_error_thresh: float = 0.100
    close_error_thresh: float = 0.005
    success_height_thresh: float = 0.005
    keypoint_reward_scale: float = -0.9
    action_penalty_scale: float = -0.1
    action_delta_scale: float = -0.2
    ori_reward_scale: float = -0.5
    eef_ori_reward_scale: float = -0.0
    early_reset_reward_scale: float = -1.0
    engagement_reward_scale: float = 0.4
    success_bonus: float = 5.0


@dataclass(frozen=True)
class TaskConfig:
    name: str = "FactoryTaskInsertionTactile"
    # NOTE: resets always perform the analytic grasp-at-init (per-finger
    # contact-aware closure bisection in envs/insertion.py); this flag is kept
    # for recipe compatibility — the reference's alternative (replaying
    # recorded grasp rows) is selected by passing `grasp_data` instead.
    grasp_at_init: bool = False
    collect_rotate: bool = False
    reset_at_success: bool = False
    reset_at_fails: bool = False
    rand_inits: bool = False
    ctrl_type: str = "gym_default"
    sim: SimConfig = field(default_factory=SimConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    randomize: RandomizeConfig = field(default_factory=RandomizeConfig)
    rl: RLConfig = field(default_factory=RLConfig)

    def replace(self, **kw) -> "TaskConfig":
        return dataclasses.replace(self, **kw)


def default_task_config(**overrides) -> TaskConfig:
    cfg = TaskConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
