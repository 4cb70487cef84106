"""Hardware driver examples behind the `deploy.devices` seam.

Port of `isaacgyminsertion_tpu/deploy/drivers.py`: the numpy and cv2 code
is the port's own copy, on the port's `devices.py`. `EkiIiwaArm` inherits
the port's torch `KinematicArm`, so its `servo_delta` runs FK and the IK step
on the arm's `device` (CUDA unless `device="cpu"` is given).

The kinematic devices in `devices.py` prove the *architecture* (polled
drivers + CompositeEnv + transport); this module proves the *seam*: each
class here is a real-driver implementation that talks to actual hardware
SDKs, import-guarded so the framework runs (and tests) without them
installed. Reference shapes:

- `ZedCamera`        ← algo/deploy/env/zed_camera.py (ROS-topic ZED depth
  subscriber, 320×180, clip [0.1, 0.5] m) — here via the ZED SDK (pyzed)
  directly instead of a ROS relay.
- `SerialOpenhand`   ← algo/deploy/env/openhand_env.py + hand.py (Dynamixel
  servos behind /gripper/pos, /gripper/load topics and TargetAngles
  services) — here via the dynamixel_sdk / pyserial port directly.
- `UsbAllsight`      ← algo/deploy/env/finger.py (cv2.VideoCapture fingertip
  cameras with a circle mask and background differencing).
- `EkiIiwaArm`, `ApriltagTracker`, `SegTracker`: the arm over KUKA's EKI
  XML/TCP endpoint, the AprilTag socket tracker and the annotate-once plug
  mask tracker (below).

Every class subclasses its `devices.py` abstract and only overrides the
driver hooks (`_read`, command methods), so `CompositeEnv(arm=..., hand=
SerialOpenhand(...), camera=ZedCamera(...))` is a drop-in robot: nothing
above the device layer changes, which is the "same config tree drives sim
and robot" property the reference keeps (SURVEY §8.4).

Each constructor raises `DriverUnavailable` if its SDK is missing, so
callers can fall back to the kinematic devices explicitly.
"""

from __future__ import annotations

import time

import numpy as np

from .devices import (CameraDevice, HandDevice, KinematicArm, TactileDevice,
                      TrackerDevice)


class DriverUnavailable(RuntimeError):
    """The hardware SDK this driver needs is not importable on this host."""


def _resize_nn(img: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize (numpy-only; avoids a cv2 dependency on the
    ZED path). Sensor frames are small (≤320×180 → 96×54)."""
    h, w = shape
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64)
    return np.ascontiguousarray(img[ys][:, xs])


# --------------------------------------------------------------------------- #
# ZED depth (+ neural seg hook) camera
# --------------------------------------------------------------------------- #


class ZedCamera(CameraDevice):
    """ZED stereo camera through the ZED SDK (pyzed.sl).

    Produces the reference pipeline's camera contract
    (zed_camera.py:16-21 + DepthImageProcessor, factory_utils.py:55-72):
    depth in meters clipped to [near_clip, far_clip] then normalized to
    [0, 1], resized to the training resolution, plus a segmentation channel.
    Segmentation on hardware comes from a separate tracker (the reference
    runs SAM in seg_camera.py); pass `seg_fn(rgb) -> [H, W] ids` to plug one
    in, else seg is all-zero (background id).
    """

    def __init__(self, shape=(54, 96), rate_hz: float = 30.0,
                 near_clip: float = 0.1, far_clip: float = 0.5,
                 seg_fn=None, camera_fps: int = 30):
        try:
            import pyzed.sl as sl  # ZED SDK python bindings
        except ImportError as e:  # pragma: no cover - requires ZED SDK
            raise DriverUnavailable("pyzed (ZED SDK) not installed") from e
        super().__init__(shape=shape, rate_hz=rate_hz)
        self._sl = sl
        self.near_clip, self.far_clip = near_clip, far_clip
        self.seg_fn = seg_fn
        self.zed = sl.Camera()
        init = sl.InitParameters()
        init.camera_resolution = sl.RESOLUTION.VGA
        init.camera_fps = camera_fps
        init.depth_mode = sl.DEPTH_MODE.NEURAL
        init.coordinate_units = sl.UNIT.METER
        init.depth_minimum_distance = near_clip
        status = self.zed.open(init)
        if status != sl.ERROR_CODE.SUCCESS:  # pragma: no cover - hardware
            raise DriverUnavailable(f"ZED open failed: {status}")
        self._depth = sl.Mat()
        self._rgb = sl.Mat()
        self._runtime = sl.RuntimeParameters()

    def _read(self) -> dict | None:  # pragma: no cover - requires hardware
        sl = self._sl
        if self.zed.grab(self._runtime) != sl.ERROR_CODE.SUCCESS:
            return None  # keep last sample; the staleness watchdog flags death
        self.zed.retrieve_measure(self._depth, sl.MEASURE.DEPTH)
        depth = np.asarray(self._depth.get_data(), np.float32)
        # DepthImageProcessor parity: NaN/inf → far, clip, normalize to [0,1]
        depth = np.nan_to_num(depth, nan=self.far_clip, posinf=self.far_clip,
                              neginf=self.near_clip)
        depth = np.clip(depth, self.near_clip, self.far_clip)
        depth = (depth - self.near_clip) / (self.far_clip - self.near_clip)
        depth = _resize_nn(depth, self.shape)
        if self.seg_fn is not None:
            self.zed.retrieve_image(self._rgb, sl.VIEW.LEFT)
            rgb = np.asarray(self._rgb.get_data())[..., :3]
            seg = _resize_nn(np.asarray(self.seg_fn(rgb), np.float32), self.shape)
        else:
            seg = np.zeros(self.shape, np.float32)
        return {"img": depth, "seg": seg}

    def stop(self):  # release the camera handle with the polling thread
        super().stop()
        try:  # pragma: no cover - requires hardware
            self.zed.close()
        except Exception:
            pass


# --------------------------------------------------------------------------- #
# OpenHand over Dynamixel serial
# --------------------------------------------------------------------------- #

# Dynamixel XM-series control table (protocol 2.0)
_ADDR_TORQUE_ENABLE = 64
_ADDR_GOAL_POSITION = 116
_ADDR_PRESENT_POSITION = 132
_ADDR_PRESENT_LOAD = 126
_TICKS_PER_RAD = 4096.0 / (2.0 * np.pi)


class SerialOpenhand(HandDevice):
    """OpenHand Model-O style 3-finger hand on a Dynamixel bus.

    The reference drives this through hand_control ROS services
    (openhand_env.py: TargetAngles/close services, /gripper/pos + /gripper/load
    topics); here the same motor surface is the dynamixel_sdk directly. The
    8-dim gripper vector and the normalized motor-state convention are
    inherited from HandDevice, so CompositeEnv.get_hand_motor_state() is
    unchanged.
    """

    def __init__(self, port: str = "/dev/ttyUSB0", baud: int = 57600,
                 motor_ids=(1, 2, 3, 4), oh=None, rate_hz: float = 60.0,
                 load_limit: float = 0.6):
        try:
            from dynamixel_sdk import PacketHandler, PortHandler
        except ImportError as e:  # pragma: no cover - requires SDK
            raise DriverUnavailable("dynamixel_sdk not installed") from e
        super().__init__(oh=oh, rate_hz=rate_hz)
        self.motor_ids = tuple(motor_ids)
        self.load_limit = load_limit
        self.port = PortHandler(port)
        self.packet = PacketHandler(2.0)
        if not self.port.openPort() or not self.port.setBaudRate(baud):
            raise DriverUnavailable(f"cannot open Dynamixel bus on {port}")
        for mid in self.motor_ids:  # pragma: no cover - requires hardware
            self.packet.write1ByteTxRx(self.port, mid, _ADDR_TORQUE_ENABLE, 1)

    # motor mapping: 4 servos → 8-dim gripper vector. Model-O couples each
    # finger's proximal+distal through one tendon servo; servo 0 is the
    # base/spread. The sim-side vector is [base, (prox, dist) × 3, spread].
    #
    # CAVEAT (sim2real): the 0.4 proximal→distal tendon ratio and the
    # *_open offsets are NOMINAL Model-O values, not measured ones. On a
    # real hand, calibrate before trusting tactile-conditioned policies:
    # command a slow close sweep, record (servo ticks, distal joint angle)
    # from vision/encoders, and fit the ratio+offset; the round-trip test
    # in tests/test_drivers_hw.py pins the MAPPING's self-consistency, not
    # its physical accuracy.
    def _servo_to_vec(self, ticks: np.ndarray) -> np.ndarray:
        rad = ticks / _TICKS_PER_RAD
        o = self.oh
        vec = np.empty(8, np.float32)
        vec[0] = o.base_angle
        for f in range(3):
            t = rad[1 + f]
            vec[1 + 2 * f] = o.proximal_open + t          # proximal tracks tendon
            vec[2 + 2 * f] = o.distal_open + 0.4 * t      # distal lags (tendon ratio)
        vec[7] = rad[0]
        return vec

    def _vec_to_servo(self, vec: np.ndarray) -> np.ndarray:
        o = self.oh
        ticks = np.empty(len(self.motor_ids), np.float32)
        ticks[0] = vec[7] * _TICKS_PER_RAD
        for f in range(3):
            ticks[1 + f] = (vec[1 + 2 * f] - o.proximal_open) * _TICKS_PER_RAD
        return ticks

    def _read(self) -> dict:  # pragma: no cover - requires hardware
        ticks = np.zeros(len(self.motor_ids), np.float32)
        loads = np.zeros(len(self.motor_ids), np.float32)
        for i, mid in enumerate(self.motor_ids):
            pos, rc, err = self.packet.read4ByteTxRx(
                self.port, mid, _ADDR_PRESENT_POSITION)
            load, _, _ = self.packet.read2ByteTxRx(
                self.port, mid, _ADDR_PRESENT_LOAD)
            if rc != 0 or err != 0:
                return None  # bus hiccup: keep last sample
            ticks[i] = pos
            loads[i] = np.int16(load) / 1000.0  # signed percent of stall
        self._q = self._servo_to_vec(ticks)
        return {"motors": self._q.copy(), "load": loads}

    def _command(self, q: np.ndarray):  # pragma: no cover - requires hardware
        self._q = np.asarray(q, np.float32).copy()
        ticks = self._vec_to_servo(self._q)
        for mid, t in zip(self.motor_ids, ticks):
            self.packet.write4ByteTxRx(self.port, mid, _ADDR_GOAL_POSITION,
                                       int(t))

    def grasp(self, staged: bool = True, stages: int = 10):
        """Staged close with a load abort: stop tightening once any tendon
        load passes load_limit (the reference's close service watches
        /gripper/load the same way)."""
        if not staged:  # pragma: no cover - requires hardware
            self._command(self._close)
            return
        for i in range(1, stages + 1):  # pragma: no cover - requires hardware
            s = self.latest()
            if s is not None and "load" in s and np.any(
                    np.abs(s["load"]) > self.load_limit):
                break
            self._command(self._open + (self._close - self._open) * (i / stages))
            time.sleep(1.0 / self.rate_hz)

    def stop(self):
        super().stop()
        try:  # pragma: no cover - requires hardware
            for mid in self.motor_ids:
                self.packet.write1ByteTxRx(self.port, mid, _ADDR_TORQUE_ENABLE, 0)
            self.port.closePort()
        except Exception:
            pass


# --------------------------------------------------------------------------- #
# AllSight fingertip cameras over USB/UVC
# --------------------------------------------------------------------------- #


class UsbAllsight(TactileDevice):
    """3 AllSight fingertip cameras as UVC devices (finger.py analog).

    Applies the sensor-side half of the sim tactile pipeline so hardware
    frames match the training distribution (factory_task_insertion.py:546-574
    + allsight_render.py:214-219): circle mask, background difference
    against a calibration frame, resize to the encoder size, [0, 1] range.
    """

    def __init__(self, device_indices=(0, 1, 2), shape=(3, 64, 64, 3),
                 rate_hz: float = 30.0, diff_with_bg: bool = True):
        try:
            import cv2
        except ImportError as e:  # pragma: no cover
            raise DriverUnavailable("opencv (cv2) not installed") from e
        super().__init__(shape=shape, rate_hz=rate_hz)
        self._cv2 = cv2
        self.diff_with_bg = diff_with_bg
        self.caps = []
        for idx in device_indices:
            cap = cv2.VideoCapture(idx)
            if not cap.isOpened():
                for c in self.caps:
                    c.release()
                raise DriverUnavailable(f"tactile camera {idx} not available")
            self.caps.append(cap)
        self._bg = None  # calibration frames, captured on first read
        h, w = self.shape[1], self.shape[2]
        yy, xx = np.mgrid[0:h, 0:w]
        r = min(h, w) / 2.0
        self._mask = ((yy - h / 2.0) ** 2 + (xx - w / 2.0) ** 2
                      <= r * r).astype(np.float32)[..., None]

    def _grab(self) -> np.ndarray | None:  # pragma: no cover - hardware
        frames = []
        for cap in self.caps:
            ok, frame = cap.read()
            if not ok:
                return None
            frame = self._cv2.resize(frame, (self.shape[2], self.shape[1]))
            frames.append(frame[..., ::-1].astype(np.float32) / 255.0)  # BGR→RGB
        return np.stack(frames)

    def calibrate(self, n_frames: int = 10) -> bool:  # pragma: no cover - hw
        """Capture an explicit contact-free background (mean of n_frames),
        like the reference's background-calibration step (allsight_wrapper
        _calibrate). Call BEFORE the hand makes contact; falling back to the
        first polled frame bakes any startup contact into the background
        (round-3 ADVICE)."""
        acc = []
        for _ in range(n_frames):
            raw = self._grab()
            if raw is not None:
                acc.append(raw)
        if not acc:
            return False
        self._bg = np.mean(acc, axis=0)
        return True

    def _read(self) -> dict:  # pragma: no cover - requires hardware
        raw = self._grab()
        if raw is None:
            return None
        if self._bg is None:
            # last-resort background (no explicit calibrate() call); valid
            # only if the gel is contact-free at startup
            self._bg = raw.copy()
        out = raw - self._bg if self.diff_with_bg else raw
        out = np.clip(out * 0.5 + 0.5, 0.0, 1.0) if self.diff_with_bg else out
        return {"frames": out * self._mask}

    def stop(self):
        super().stop()
        for cap in self.caps:  # pragma: no cover - requires hardware
            try:
                cap.release()
            except Exception:
                pass


# --------------------------------------------------------------------------- #
# arm: KUKA iiwa via EKI-style XML-over-TCP position streaming
# --------------------------------------------------------------------------- #


class EkiIiwaArm(KinematicArm):
    """KUKA arm through an EKI (Ethernet KRL Interface) XML/TCP endpoint.

    Reference shape: algo/deploy/env/moveit_manipulator_wrap.py — a ROS
    relay to MoveIt planning services plus a joint-velocity streaming API.
    Here the controller is driven directly over the EKI socket KUKA
    controllers expose (no ROS): joint targets stream as
    `<RobotCommand><Joints A1=".." ... A7=".."/></RobotCommand>` and the
    controller replies `<RobotState><Joints .../>[<Wrench .../>]</RobotState>`.

    Inherits the framework FK/IK from KinematicArm, so `servo_delta` (the
    60 Hz deploy-loop surface) converts metric eef deltas to joint targets
    with the same damped-least-squares IK the sim controller uses
    (ops/control.py), on the arm's `device`, then streams them; `_read`
    returns the MEASURED joints/pose, not the commanded ones.
    """

    def __init__(self, host: str, port: int = 54600, rate_hz: float = 120.0,
                 timeout_s: float = 1.0, device=None):
        import socket

        super().__init__(rate_hz=rate_hz, device=device)
        self.name = "arm"
        try:
            self._sock = socket.create_connection((host, port), timeout=timeout_s)
            self._sock.settimeout(timeout_s)
        except OSError as e:
            raise DriverUnavailable(f"EKI endpoint {host}:{port} unreachable") from e
        self._rx = b""

    # -- wire format -------------------------------------------------------

    @staticmethod
    def _encode_command(q7: np.ndarray) -> bytes:
        attrs = " ".join(f'A{i + 1}="{float(q7[i]):.6f}"' for i in range(7))
        return f"<RobotCommand><Joints {attrs}/></RobotCommand>\n".encode()

    @staticmethod
    def _parse_state(xml_text: str):
        """→ (q7, wrench[6] | None); raises on malformed XML."""
        import xml.etree.ElementTree as ET

        root = ET.fromstring(xml_text)
        j = root.find("Joints")
        q = np.array([float(j.attrib[f"A{i + 1}"]) for i in range(7)], np.float32)
        w = root.find("Wrench")
        wrench = None
        if w is not None:
            wrench = np.array([float(w.attrib[k])
                               for k in ("Fx", "Fy", "Fz", "Tx", "Ty", "Tz")],
                              np.float32)
        return q, wrench

    def _transact(self, q7: np.ndarray) -> None:  # pragma: no cover - network
        """One stream cycle: send the joint target, consume one state reply."""
        self._sock.sendall(self._encode_command(q7))
        while b"\n" not in self._rx:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise DriverUnavailable("EKI connection closed by controller")
            self._rx += chunk
        line, self._rx = self._rx.split(b"\n", 1)
        q, wrench = self._parse_state(line.decode())
        self._q = q
        if wrench is not None:
            self._wrench = wrench

    # -- device surface ----------------------------------------------------

    def servo_delta(self, dpos, drot):  # pragma: no cover - network
        q_target = self._ik_step(np.asarray(self._q, np.float32), np.asarray(dpos, np.float32),
                                 np.asarray(drot, np.float32))
        self._transact(q_target)

    def move_to_joints(self, q, wait: bool = True):  # pragma: no cover - network
        """Plan-free point-to-point: stream interpolated waypoints (the EKI
        analog of the reference's MoveItMoveJointPosition service call)."""
        q = np.asarray(q, np.float32)[:7]
        start = np.asarray(self._q, np.float32)
        n = max(int(np.max(np.abs(q - start)) / 0.01), 1) if wait else 1
        for i in range(1, n + 1):
            self._transact(start + (q - start) * (i / n))

    def stop(self):
        super().stop()
        try:
            self._sock.close()
        except Exception:
            pass


# --------------------------------------------------------------------------- #
# tracker: AprilTag socket-pose estimation (cv2.aruco)
# --------------------------------------------------------------------------- #


class ApriltagTracker(TrackerDevice):
    """Socket-pose tracker from AprilTag detections (cv2.aruco, 36h11).

    Reference shape: algo/deploy/env/apriltag_tracker.py — a ROS relay that
    republishes `/hand_control/obj_*` pose topics and debounces a drop flag
    over 10 consecutive detections. Here the detection itself runs in-driver:
    frames come from `frame_fn() -> HxW[x3] uint8` (or a cv2.VideoCapture
    index), the tag pose is recovered with solvePnP from the tag's physical
    size + camera intrinsics, then mapped to the robot base frame through a
    fixed camera extrinsic.

    Pose math is original; only the topic contract (socket_pos/socket_quat +
    debounced `drop`) mirrors the reference Tracker.
    """

    def __init__(self, frame_fn=None, camera_index: int = 0,
                 tag_size_m: float = 0.03, fx: float = 600.0, fy: float = 600.0,
                 cx: float = 320.0, cy: float = 240.0,
                 cam_pos=(0.5, 0.0, 0.5), cam_quat=(1.0, 0.0, 0.0, 0.0),
                 tag_to_socket=(0.0, 0.0, -0.02), rate_hz: float = 10.0,
                 drop_count: int = 10):
        try:
            import cv2
        except ImportError as e:  # pragma: no cover - requires opencv
            raise DriverUnavailable("opencv (cv2) not installed") from e
        super().__init__(rate_hz=rate_hz)
        self._cv2 = cv2
        self._dict = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11)
        self._detector = cv2.aruco.ArucoDetector(self._dict,
                                                 cv2.aruco.DetectorParameters())
        if frame_fn is None:  # pragma: no cover - requires hardware
            cap = cv2.VideoCapture(camera_index)
            if not cap.isOpened():
                raise DriverUnavailable(f"camera index {camera_index} unavailable")
            frame_fn = lambda: cap.read()[1]
            self._cap = cap
        self.frame_fn = frame_fn
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        s = tag_size_m / 2.0
        # tag corner order as cv2.aruco returns it: TL, TR, BR, BL (tag frame:
        # +x right, +y down on the printed face, +z out of the tag)
        self._obj_pts = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]],
                                 np.float64)
        self._cam_pos = np.asarray(cam_pos, np.float64)
        self._cam_rot = self._quat_to_mat(np.asarray(cam_quat, np.float64))
        self._tag_to_socket = np.asarray(tag_to_socket, np.float64)
        self.drop = False
        self._drop_counter = 0
        self._drop_count = drop_count

    @staticmethod
    def _quat_to_mat(q):
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    @staticmethod
    def _mat_to_quat(R):
        w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2.0
        if w < 1e-8:  # pragma: no cover - degenerate rotation
            return np.array([1.0, 0, 0, 0])
        return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                         (R[0, 2] - R[2, 0]) / (4 * w),
                         (R[1, 0] - R[0, 1]) / (4 * w)])

    def _read(self) -> dict | None:
        cv2 = self._cv2
        frame = self.frame_fn()
        if frame is None:
            return self._miss()
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
        corners, ids, _ = self._detector.detectMarkers(gray)
        if ids is None or len(corners) == 0:
            return self._miss()
        # IPPE (planar) — not IPPE_SQUARE, which requires OpenCV's own
        # TL(-s,+s) corner convention and silently degenerates on ours
        ok, rvec, tvec = cv2.solvePnP(self._obj_pts, corners[0][0].astype(np.float64),
                                      self.K, None, flags=cv2.SOLVEPNP_IPPE)
        if not ok:
            return self._miss()
        self._drop_counter = 0
        self.drop = False
        R_ct, _ = cv2.Rodrigues(rvec)
        # camera frame → base frame
        R_bt = self._cam_rot @ R_ct
        p_tag = self._cam_rot @ tvec.ravel() + self._cam_pos
        p_socket = p_tag + R_bt @ self._tag_to_socket
        return {"socket_pos": p_socket.astype(np.float32),
                "socket_quat": self._mat_to_quat(R_bt).astype(np.float32)}

    def _miss(self):
        """Debounced drop flag (reference _object_drop_callback: 10 strikes)."""
        self._drop_counter += 1
        if self._drop_counter >= self._drop_count:
            self.drop = True
        return None  # keep the last good pose; staleness watchdog sees age

    def stop(self):
        super().stop()
        cap = getattr(self, "_cap", None)
        if cap is not None:  # pragma: no cover - requires hardware
            try:
                cap.release()
            except Exception:
                pass


class SegTracker:
    """Annotate-once plug-mask tracker — the SAM-pipeline analog.

    Reference shape: algo/deploy/env/tracking_SAM.py (SegCameraSubscriber):
    a ZED RGB stream is segmented once by SAM/GroundingDINO
    ("annotate first img"), then the mask is PROPAGATED per frame by an AOT
    video tracker; the output contract is a 180x320 mask with plug pixels =
    plug_id (2), plus a shrink_mask() erosion utility used before
    back-projecting the plug point cloud. That stack hinges on ~3 GB of
    pretrained weights the deploy host must carry.

    Here the same contract is met with an on-host tracker that needs no
    weights: `annotate_init_frame(frame, mask|bbox)` seeds an HSV color
    histogram of the object; each subsequent frame is histogram
    back-projected (cv2.calcBackProject), the object window is re-localized
    with CamShift, and the mask is the thresholded back-projection inside
    the (slightly inflated) window, morphologically cleaned. Output:
    uint8 [180, 320] mask in {0, plug_id}, same as the reference.

    API parity: is_tracking() / annotate_init_frame() / propagate_one_frame()
    mirror tracking_SAM.main_tracker; get_frame() returns the latest mask,
    shrink_mask() the erosion-to-target-area utility
    (tracking_SAM.py:96-117).
    """

    def __init__(self, w: int = 320, h: int = 180, plug_id: int = 2,
                 bins: int = 24, bp_thresh: int = 50):
        try:
            import cv2
        except ImportError as e:  # pragma: no cover - requires opencv
            raise DriverUnavailable("opencv (cv2) not installed") from e
        self._cv2 = cv2
        self.w, self.h = w, h
        self.plug_id = plug_id
        self._bins = bins
        self._bp_thresh = bp_thresh
        self._hist = None
        self._window = None  # (x, y, w, h)
        self.last_mask = None

    # ------------------------------------------------------------- contract
    def is_tracking(self) -> bool:
        return self._hist is not None

    def annotate_init_frame(self, frame_rgb: np.ndarray,
                            mask: np.ndarray | None = None,
                            bbox: tuple | None = None):
        """Seed the tracker from an initial mask or bbox (the reference gets
        this from SAM; callers here pass a click-box or a seg-camera mask)."""
        cv2 = self._cv2
        frame = self._fit(frame_rgb)
        if mask is None:
            if bbox is None:
                raise ValueError("annotate_init_frame needs mask= or bbox=")
            x, y, bw, bh = [int(v) for v in bbox]
            mask = np.zeros(frame.shape[:2], np.uint8)
            mask[y:y + bh, x:x + bw] = 1
        else:
            mask = (self._fit_mask(mask) > 0).astype(np.uint8)
        hsv = cv2.cvtColor(frame, cv2.COLOR_RGB2HSV)
        # 2D hue-saturation histogram over the annotated pixels only
        self._hist = cv2.calcHist([hsv], [0, 1], mask, [self._bins, self._bins],
                                  [0, 180, 0, 256])
        cv2.normalize(self._hist, self._hist, 0, 255, cv2.NORM_MINMAX)
        ys, xs = np.nonzero(mask)
        self._window = (int(xs.min()), int(ys.min()),
                        int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1))
        self.last_mask = mask.astype(np.uint8) * self.plug_id
        return self.last_mask

    def propagate_one_frame(self, frame_rgb: np.ndarray) -> np.ndarray:
        """Track the annotated object into the next frame; returns the
        {0, plug_id} mask (reference propagate_one_frame contract)."""
        if not self.is_tracking():
            raise RuntimeError("annotate first img")
        cv2 = self._cv2
        frame = self._fit(frame_rgb)
        hsv = cv2.cvtColor(frame, cv2.COLOR_RGB2HSV)
        bp = cv2.calcBackProject([hsv], [0, 1], self._hist,
                                 [0, 180, 0, 256], scale=1)
        crit = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 10, 1.0)
        try:
            _, self._window = cv2.CamShift(bp, self._window, crit)
        except cv2.error:  # degenerate window: keep previous
            pass
        x, y, ww, wh = self._window
        # inflate the window 20% and mask = thresholded backprojection inside
        pad_x, pad_y = int(0.2 * ww) + 2, int(0.2 * wh) + 2
        x0, y0 = max(x - pad_x, 0), max(y - pad_y, 0)
        x1, y1 = min(x + ww + pad_x, self.w), min(y + wh + pad_y, self.h)
        gate = np.zeros_like(bp)
        gate[y0:y1, x0:x1] = 1
        m = ((bp >= self._bp_thresh) & (gate > 0)).astype(np.uint8)
        kernel = np.ones((3, 3), np.uint8)
        m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel, iterations=2)
        m = cv2.morphologyEx(m, cv2.MORPH_OPEN, kernel, iterations=1)
        self.last_mask = m * self.plug_id
        return self.last_mask

    def get_frame(self) -> np.ndarray | None:
        """Latest {0, plug_id} mask (SegCameraSubscriber.get_frame parity)."""
        return self.last_mask

    def shrink_mask(self, mask: np.ndarray, shrink_percentage: float = 10.0
                    ) -> np.ndarray:
        """Erode until the object area drops by shrink_percentage
        (tracking_SAM.py:96-117 parity, used before pcl backprojection)."""
        cv2 = self._cv2
        target = float((mask > 0).sum()) * (1.0 - shrink_percentage / 100.0)
        kernel = np.ones((3, 3), np.uint8)
        out = (mask > 0).astype(np.uint8)
        while out.sum() > target and out.any():
            out = cv2.erode(out, kernel, iterations=1)
        return out * self.plug_id

    # ------------------------------------------------------------- helpers
    def _fit(self, frame: np.ndarray) -> np.ndarray:
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        if frame.shape[:2] != (self.h, self.w):
            frame = _resize_nn(frame, (self.h, self.w))
        return np.ascontiguousarray(frame[..., :3].astype(np.uint8))

    def _fit_mask(self, mask: np.ndarray) -> np.ndarray:
        if mask.shape != (self.h, self.w):
            mask = _resize_nn(mask.astype(np.uint8), (self.h, self.w))
        return mask
