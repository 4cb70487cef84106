"""Robot-side device layer (parity: reference algo/deploy/env/*, ~3k LoC).

The reference wraps each hardware unit in a ROS node object — OpenhandEnv
(openhand_env.py), HandROSSubscriberFinger tactile (finger_ros.py),
ZedCameraSubscriber depth/seg (zed_camera.py), ZedPointCloudSubscriber
(pcl_camera.py), apriltag Tracker (apriltag_tracker.py), RobotWithFtEnv /
MoveIt arm (robots.py, moveit_manipulator_wrap.py) — and aggregates them in
ExperimentEnv (env.py:17-298) whose get_obs/align_and_grasp/move methods the
HardwarePlayer drives.

Here the same architecture is transport-agnostic instead of ROS-specific:

- `Device` gives every driver the subscriber semantics the reference gets
  from rospy: a background polling thread samples the driver at `rate_hz`,
  `latest()` returns the freshest sample, and a staleness watchdog flags a
  dead driver (the reference's `init_success` + wait_for_message pattern).
- Concrete device classes define the driver hook (`_read`/command methods).
  The provided implementations are kinematic: they integrate commands
  through the framework's own FK/IK (physics.robot model), so the entire
  robot-side stack runs — and is tested — without hardware. A real robot
  replaces `_read`/`_send` with driver calls (serial, ZED SDK, …); nothing
  above the device layer changes.
- `CompositeEnv` mirrors ExperimentEnv: builds the enabled devices, exposes
  get_obs/get_ft/get_frames/get_img/get_info_for_control/move_to_init_state/
  grasp/release/align_and_grasp/set_random_init_error, and implements the
  HardwareInterface protocol (reset/get_observation/apply_action) expected
  by deploy.hardware_player players — so `serve_hardware(CompositeEnv(...))`
  publishes a whole robot to a training-side RemoteInterface.
- `SafetyLimits` is the layer the ROS stack leaves to MoveIt: workspace
  clamp, per-step delta clamp, and a wrench abort that latches `fault`.

Port of `isaacgyminsertion_tpu/deploy/devices.py`: numpy, threads and the
port's torch FK/IK. `KinematicArm` runs its FK, point Jacobian and DLS step
through `physics.kinematics` and `ops.control` on its `device`, CUDA unless
`device="cpu"` is given.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..envs.config import OpenhandConfig, TaskConfig, default_task_config
from ..ops import rotations as rot
from ..ops.control import _get_delta_dof_pos
from ..physics.kinematics import forward_kinematics, point_jacobian, site_pose
from ..physics.robot import SITE_FINGERTIP_CENTERED


# --------------------------------------------------------------------------- #
# device base
# --------------------------------------------------------------------------- #


class Device:
    """Polled driver with freshest-sample semantics (rospy subscriber analog).

    Subclasses implement `_read() -> dict[str, np.ndarray]`; `start()` spins
    a daemon thread sampling it at `rate_hz`. `latest(max_age)` returns the
    newest sample or None if it is older than `max_age` seconds (driver
    died / cable pulled) — the reference's wait_for_message timeout pattern.
    """

    def __init__(self, rate_hz: float = 60.0, name: str = "device"):
        self.rate_hz = rate_hz
        self.name = name
        self.init_success = False
        self._lock = threading.Lock()
        self._sample: dict | None = None
        self._stamp = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # driver hook ----------------------------------------------------------
    def _read(self) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    # lifecycle ------------------------------------------------------------
    def start(self, timeout: float = 2.0) -> bool:
        """Begin polling; blocks until the first sample (init_success)."""
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"dev-{self.name}")
        self._thread.start()
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if self._stamp > 0.0:
                self.init_success = True
                return True
            time.sleep(0.001)
        return False

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def _loop(self):
        period = 1.0 / self.rate_hz
        while not self._stop.is_set():
            try:
                sample = self._read()
            except Exception:  # driver hiccup: keep last sample, stay alive
                sample = None
            if sample is not None:
                with self._lock:
                    self._sample = sample
                    self._stamp = time.monotonic()
            self._stop.wait(period)

    # consumer API ---------------------------------------------------------
    def latest(self, max_age: float | None = None) -> dict | None:
        with self._lock:
            sample, stamp = self._sample, self._stamp
        if sample is None:
            return None
        if max_age is not None and time.monotonic() - stamp > max_age:
            return None
        return sample

    @property
    def stale_for(self) -> float:
        return time.monotonic() - self._stamp if self._stamp else float("inf")


# --------------------------------------------------------------------------- #
# arm
# --------------------------------------------------------------------------- #


class ArmDevice(Device):
    """Manipulator + wrist F/T (robots.py RobotWithFtEnv + MoveIt analog).

    Command surface: `servo_delta` (the 60 Hz deploy loop), `move_to_joints`
    (reset moves, MoveIt plan-and-execute analog), read via `latest()`:
    {'joints' [7], 'ee_pos' [3], 'ee_quat' [4] wxyz, 'wrench' [6]}.
    """

    def move_to_joints(self, q: np.ndarray, wait: bool = True):  # pragma: no cover
        raise NotImplementedError

    def servo_delta(self, dpos: np.ndarray, drot: np.ndarray):  # pragma: no cover
        raise NotImplementedError


class KinematicArm(ArmDevice):
    """Arm driver that integrates commands through the framework FK/IK.

    Doubles as the hardware mock and as the base class for a real driver
    (override move_to_joints/servo_delta/_read with controller calls; keep
    the IK helpers)."""

    def __init__(self, rate_hz: float = 120.0, device=None):
        super().__init__(rate_hz, "arm")
        from .. import resolve_device
        from ..envs.insertion import nominal_grasp_arm_q
        from ..physics.robot import build_kuka_openhand

        self.device = resolve_device(device)
        self.model = build_kuka_openhand()
        self._init_q = np.asarray(nominal_grasp_arm_q(self.model))
        self._q = self._init_q.copy()
        self._wrench = np.zeros(6, np.float32)

    @torch.no_grad()
    def _fk(self, q7: np.ndarray):
        """(eef pos [3], quat [4], point Jacobian [6, 7]) at arm joints q7, as tensors."""
        q = torch.zeros((1, 15), device=self.device)
        q[0, :7] = torch.as_tensor(np.asarray(q7, np.float32), device=self.device)
        fk = forward_kinematics(self.model, q)
        quat, pos = site_pose(self.model, fk, SITE_FINGERTIP_CENTERED)
        J = point_jacobian(self.model, fk, pos, 6)[..., :7]
        return pos[0], quat[0], J[0]

    def _fk_pose(self, q7: np.ndarray):
        """(eef pos [3], quat [4], point Jacobian [6, 7]) at arm joints q7, as numpy."""
        return tuple(x.cpu().numpy() for x in self._fk(q7))

    @torch.no_grad()
    def _ik_step(self, q7: np.ndarray, dpos: np.ndarray, drot_aa: np.ndarray) -> np.ndarray:
        """One damped-least-squares step of the joints toward a metric eef delta."""
        _, _, J = self._fk(q7)
        delta = torch.as_tensor(np.concatenate([dpos, drot_aa]).astype(np.float32), device=self.device)
        dq = _get_delta_dof_pos(delta, J, "dls")
        return (torch.as_tensor(np.asarray(q7, np.float32), device=self.device) + dq).cpu().numpy()

    def _read(self) -> dict:
        pos, quat, _ = self._fk_pose(np.asarray(self._q, np.float32))
        return {
            "joints": np.asarray(self._q, np.float32),
            "ee_pos": np.asarray(pos, np.float32),
            "ee_quat": np.asarray(quat, np.float32),
            "wrench": self._wrench.copy(),
        }

    def move_to_joints(self, q: np.ndarray, wait: bool = True):
        self._q = np.asarray(q, np.float32)[:7].copy()

    def move_to_init(self):
        self.move_to_joints(self._init_q)

    def servo_delta(self, dpos: np.ndarray, drot: np.ndarray):
        """Servo the eef by a metric delta (axis-angle rotation)."""
        self._q = self._ik_step(np.asarray(self._q, np.float32), np.asarray(dpos, np.float32),
                                np.asarray(drot, np.float32))

    def jacobian(self) -> np.ndarray:
        return np.asarray(self._fk_pose(np.asarray(self._q, np.float32))[2])


# --------------------------------------------------------------------------- #
# hand
# --------------------------------------------------------------------------- #


class HandDevice(Device):
    """OpenHand 3-finger hand (openhand_env.py analog).

    Joint layout matches the sim gripper rows (dofs 7:15): base angle +
    per-finger [proximal, distal]-style packing is abstracted to the 8-dim
    gripper vector the sim model uses. Motor state normalization maps
    [open, close] → [0, 1] per the openhand config constants — the
    reference's get_hand_motor_state(normalized=True) (env.py:139-146).
    """

    def __init__(self, oh: OpenhandConfig | None = None, rate_hz: float = 60.0):
        super().__init__(rate_hz, "hand")
        self.oh = oh or OpenhandConfig()
        o = self.oh
        # 8-dim gripper vector: [base, (proximal, distal) × 3, spread]
        self._open = np.array([o.base_angle] + [o.proximal_open, o.distal_open] * 3
                              + [0.0], np.float32)
        self._close = np.array([o.base_angle] + [o.proximal_close, o.distal_close] * 3
                               + [0.0], np.float32)
        self._q = self._open.copy()

    def _read(self) -> dict:
        return {"motors": self._q.copy()}

    def _command(self, q: np.ndarray):
        self._q = np.asarray(q, np.float32).copy()

    def set_init(self):
        self._command(self._open)

    def release(self):
        self._command(self._open)

    def grasp(self, staged: bool = True, stages: int = 10):
        """Close; staged = the reference's incremental 10%-gap close loop
        (factory_task_insertion.py:1955-1973) so gel contact settles."""
        if not staged:
            self._command(self._close)
            return
        for i in range(1, stages + 1):
            self._command(self._open + (self._close - self._open) * (i / stages))
            time.sleep(1.0 / self.rate_hz)

    def motor_state(self, normalized: bool = True) -> np.ndarray:
        if not normalized:
            return self._q.copy()
        span = np.where(np.abs(self._close - self._open) < 1e-8, 1.0,
                        self._close - self._open)
        return (self._q - self._open) / span


# --------------------------------------------------------------------------- #
# sensors
# --------------------------------------------------------------------------- #


class TactileDevice(Device):
    """3 AllSight fingertip cameras (finger_ros.py analog): frames() →
    [3, H, W, C] float32 in [0, 1]."""

    def __init__(self, shape=(3, 64, 64, 3), rate_hz: float = 30.0):
        super().__init__(rate_hz, "tactile")
        self.shape = shape

    def _read(self) -> dict:
        return {"frames": np.zeros(self.shape, np.float32)}

    def frames(self) -> np.ndarray:
        s = self.latest()
        return s["frames"] if s else np.zeros(self.shape, np.float32)


class CameraDevice(Device):
    """External depth+seg camera (zed_camera.py / seg_camera.py analog)."""

    def __init__(self, shape=(54, 96), rate_hz: float = 30.0):
        super().__init__(rate_hz, "camera")
        self.shape = shape

    def _read(self) -> dict:
        return {"img": np.zeros(self.shape, np.float32),
                "seg": np.zeros(self.shape, np.float32)}

    def frame(self) -> tuple[np.ndarray, np.ndarray]:
        s = self.latest()
        if s is None:
            z = np.zeros(self.shape, np.float32)
            return z, z
        return s["img"], s["seg"]


class PclDevice(Device):
    """Point-cloud source (pcl_camera.py analog): fixed-size [P, 3] cloud in
    the [plug | socket | goal | scene] slice order contract (SURVEY §8.3)."""

    def __init__(self, num_points: int = 1200, rate_hz: float = 15.0):
        super().__init__(rate_hz, "pcl")
        self.num_points = num_points

    def _read(self) -> dict:
        return {"pcl": np.zeros((self.num_points, 3), np.float32)}

    def cloud(self) -> np.ndarray:
        s = self.latest()
        return s["pcl"] if s else np.zeros((self.num_points, 3), np.float32)


class TrackerDevice(Device):
    """Fiducial tracker (apriltag_tracker.py analog): socket pose estimate in
    the robot base frame."""

    def __init__(self, socket_pos=(0.5, 0.0, 0.0), socket_quat=(1, 0, 0, 0),
                 rate_hz: float = 10.0):
        super().__init__(rate_hz, "tracker")
        self._pos = np.asarray(socket_pos, np.float32)
        self._quat = np.asarray(socket_quat, np.float32)

    def _read(self) -> dict:
        return {"socket_pos": self._pos.copy(), "socket_quat": self._quat.copy()}

    def object_pose(self) -> tuple[np.ndarray, np.ndarray]:
        s = self.latest()
        if s is None:
            return self._pos.copy(), self._quat.copy()
        return s["socket_pos"], s["socket_quat"]


# --------------------------------------------------------------------------- #
# safety
# --------------------------------------------------------------------------- #


@dataclass
class SafetyLimits:
    """The envelope the reference delegates to MoveIt planning scenes."""

    workspace_lo: tuple = (0.2, -0.3, 0.003)
    workspace_hi: tuple = (0.8, 0.3, 0.5)
    max_dpos: float = 0.005        # m per step
    max_drot: float = 0.05         # rad per step
    max_wrench: float = 50.0       # N, latches fault

    def clamp(self, ee_pos: np.ndarray, dpos: np.ndarray,
              drot: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        dpos = np.clip(dpos, -self.max_dpos, self.max_dpos)
        drot = np.clip(drot, -self.max_drot, self.max_drot)
        target = np.clip(ee_pos + dpos, self.workspace_lo, self.workspace_hi)
        return target - ee_pos, drot


# --------------------------------------------------------------------------- #
# composite env
# --------------------------------------------------------------------------- #


@dataclass
class CompositeEnvConfig:
    with_arm: bool = True
    with_hand: bool = True
    with_tactile: bool = False
    with_ext_cam: bool = False
    with_depth: bool = False
    with_pcl: bool = False
    safety: SafetyLimits = field(default_factory=SafetyLimits)
    obs_max_age: float = 0.5       # s before a device reading counts as dead


class CompositeEnv:
    """ExperimentEnv mirror (env.py:17-298) + HardwareInterface.

    Aggregates the enabled devices; `ready` only if every enabled device
    produced its first sample (the reference's chained init_success). Device
    instances can be injected (real drivers); defaults are the kinematic /
    zero-frame implementations so the stack runs hardware-free (the default
    arm on `device`).
    """

    def __init__(self, cfg: CompositeEnvConfig | None = None,
                 task_cfg: TaskConfig | None = None, *,
                 arm: ArmDevice | None = None, hand: HandDevice | None = None,
                 tactile: TactileDevice | None = None,
                 camera: CameraDevice | None = None, pcl: PclDevice | None = None,
                 tracker: TrackerDevice | None = None, device=None):
        self.cfg = cfg or CompositeEnvConfig()
        self.task_cfg = task_cfg or default_task_config()
        self.fault = False
        self._regularize = False
        self._last_action = np.zeros(self.task_cfg.env.num_actions, np.float32)
        c = self.cfg
        self.arm = arm or (KinematicArm(device=device) if c.with_arm else None)
        self.hand = hand or (HandDevice(self.task_cfg.env.openhand) if c.with_hand else None)
        self.tactile = tactile or (TactileDevice() if c.with_tactile else None)
        self.camera = camera or (CameraDevice() if c.with_ext_cam or c.with_depth else None)
        self.pcl = pcl or (PclDevice() if c.with_pcl else None)
        self.tracker = tracker or (TrackerDevice() if c.with_ext_cam else None)
        self.devices = [d for d in (self.arm, self.hand, self.tactile,
                                    self.camera, self.pcl, self.tracker) if d]
        self.ready = all(d.start() for d in self.devices)
        e = self.task_cfg.env
        self._obs_queue = np.zeros((e.num_obs_hist, e.num_observations), np.float32)
        self._stud_queue = np.zeros((e.num_obs_stud_hist, e.num_obs_student), np.float32)

    def close(self):
        for d in self.devices:
            d.stop()

    # ExperimentEnv surface ------------------------------------------------
    def regularize_force(self, status: bool):
        self._regularize = bool(status)

    def get_ft(self) -> np.ndarray:
        s = self.arm.latest(self.cfg.obs_max_age) if self.arm else None
        return s["wrench"] if s else np.zeros(6, np.float32)

    def get_frames(self):
        f = self.tactile.frames()
        return f[0], f[1], f[2]

    def get_img(self):
        return self.camera.frame()

    def get_hand_motor_state(self, normalized: bool = True) -> np.ndarray:
        return self.hand.motor_state(normalized)

    def get_info_for_control(self) -> dict:
        s = self.arm.latest(self.cfg.obs_max_age)
        if s is None:
            raise RuntimeError("arm device stale")
        return {"joints": s["joints"], "ee_pose": np.concatenate(
            [s["ee_pos"], s["ee_quat"]]), "jacob": self.arm.jacobian()}

    def move_to_init_state(self):
        if self.arm is not None:
            self.arm.move_to_init()
        if self.hand is not None:
            self.hand.set_init()

    def grasp(self):
        if self.hand is not None:
            self.hand.grasp()

    def release(self):
        if self.hand is not None:
            self.hand.release()

    def align_and_grasp(self):
        """Reset motion: open → init pose → staged close (env.py:148-186)."""
        self.release()
        self.move_to_init_state()
        self.grasp()

    def set_random_init_error(self, noise_pos: float = 0.01, rng=None):
        """Perturb the arm init around the tracked socket (env.py:242-288)."""
        rng = rng or np.random.default_rng()
        self.move_to_init_state()
        d = rng.uniform(-noise_pos, noise_pos, 3).astype(np.float32)
        d[2] = abs(d[2])
        if self.arm is not None:
            self.arm.servo_delta(d, np.zeros(3, np.float32))

    # HardwareInterface ----------------------------------------------------
    def reset(self):
        self.fault = False
        self._last_action[:] = 0.0
        self._obs_queue[:] = 0.0
        self._stud_queue[:] = 0.0
        self.align_and_grasp()

    def _obs_vector(self) -> np.ndarray:
        """15-dim teacher obs: eef pos + rot6d (robot base frame) + prev
        action — compute_observations parity (factory_task_insertion.py:735)."""
        s = self.arm.latest(self.cfg.obs_max_age)
        if s is None:
            raise RuntimeError("arm device stale")
        r6 = rot.quat_to_rot6d(torch.as_tensor(s["ee_quat"])).numpy()
        return np.concatenate([s["ee_pos"], r6, self._last_action]).astype(np.float32)

    def get_observation(self) -> dict:
        ov = self._obs_vector()
        self._obs_queue = np.concatenate([ov[None], self._obs_queue[:-1]], 0)
        self._stud_queue = np.concatenate(
            [ov[None, : self._stud_queue.shape[1]], self._stud_queue[:-1]], 0)
        # flat [hist*dim] vectors — the obs_queue layout SimInterface returns
        # and the players' actor input contract
        d = {"obs": self._obs_queue.reshape(-1).copy(),
             "student_obs": self._stud_queue.reshape(-1).copy(),
             "ft": self.get_ft()}
        d["tactile"] = (self.tactile.frames()[None]
                        if self.tactile else np.zeros((0,), np.float32))
        if self.camera is not None:
            img, seg = self.camera.frame()
            d["img"], d["seg"] = img[None], seg[None]
        else:
            d["img"] = d["seg"] = np.zeros((0,), np.float32)
        d["pcl"] = (self.pcl.cloud()[None]
                    if self.pcl else np.zeros((0,), np.float32))
        if self.tracker is not None:
            d["socket_pos"], d["socket_quat"] = self.tracker.object_pose()
        return d

    def apply_action(self, delta_pos: np.ndarray, delta_rot: np.ndarray):
        if self.fault:
            return
        wrench = self.get_ft()
        if float(np.linalg.norm(wrench[:3])) > self.cfg.safety.max_wrench:
            self.fault = True  # latched: operator must reset()
            return
        s = self.arm.latest(self.cfg.obs_max_age)
        if s is None:
            raise RuntimeError("arm device stale")
        dpos, drot = self.cfg.safety.clamp(
            s["ee_pos"], np.asarray(delta_pos, np.float32),
            np.asarray(delta_rot, np.float32))
        self.arm.servo_delta(dpos, drot)
        pa = np.concatenate([dpos, drot])
        self._last_action = np.resize(pa, self._last_action.shape).astype(np.float32)
