"""The real-robot drivers (`deploy/drivers.py`) against the JAX package's on
the same inputs, without hardware: the AprilTag tracker on a synthetic tag,
the EKI arm's wire format and a loopback transaction against a fake
controller (its IK step on the port's torch `KinematicArm`), the OpenHand
servo mapping, the plug-mask tracker on a moving object, and the guarded SDK
imports."""

import socket
import sys
import threading
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from isaacgyminsertion_tpu.deploy import devices as j_devices  # noqa: E402
from isaacgyminsertion_tpu.deploy import drivers as j_drivers  # noqa: E402
from isaacgyminsertion_tpu_torch.deploy import drivers  # noqa: E402
from isaacgyminsertion_tpu_torch.envs.config import OpenhandConfig  # noqa: E402

torch.set_num_threads(1)


def _render_tag(K, tag_size, cam_from_tag_t, px=900):
    """Tag 0 fronto-parallel at a known camera-frame offset, its corners
    projected with the tracker's intrinsics (tests/test_drivers_hw.py's)."""
    marker = cv2.aruco.generateImageMarker(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11), 0, 200)
    s = tag_size / 2.0
    pts = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float64) + cam_from_tag_t
    uv = (K @ pts.T).T
    uv = (uv[:, :2] / uv[:, 2:]).astype(np.float32)
    src = np.array([[0, 0], [200, 0], [200, 200], [0, 200]], np.float32)
    H, _ = cv2.findHomography(src, uv)
    warped = cv2.warpPerspective(marker, H, (px, px), flags=cv2.INTER_NEAREST, borderValue=255)
    return np.minimum(np.full((px, px), 255, np.uint8), warped)


def test_apriltag_tracker_recovers_the_reference_pose():
    fx = fy = 800.0
    cx = cy = 450.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    offset = np.array([0.02, -0.01, 0.35])
    img = _render_tag(K, 0.04, offset)
    kw = dict(frame_fn=lambda: img, tag_size_m=0.04, fx=fx, fy=fy, cx=cx, cy=cy,
              cam_pos=(0.4, -0.1, 0.6), cam_quat=(0.9238795, 0.0, 0.3826834, 0.0),
              tag_to_socket=(0.0, 0.0, -0.02))
    ours, ref = drivers.ApriltagTracker(**kw)._read(), j_drivers.ApriltagTracker(**kw)._read()
    assert ours is not None and ref is not None
    for k in ("socket_pos", "socket_quat"):
        assert ours[k].dtype == np.float32
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, err_msg=k)
    # with the identity extrinsic the socket sits at the tag's known offset
    tr = drivers.ApriltagTracker(**{**kw, "cam_pos": (0, 0, 0), "cam_quat": (1, 0, 0, 0),
                                    "tag_to_socket": (0, 0, 0)})
    s = tr._read()
    assert np.allclose(s["socket_pos"], offset, atol=5e-3) and tr.drop is False


def test_apriltag_tracker_drop_debounce():
    blank = np.full((64, 64), 255, np.uint8)
    tr = drivers.ApriltagTracker(frame_fn=lambda: blank, drop_count=3)
    for _ in range(2):
        assert tr._read() is None
    assert tr.drop is False  # below the debounce threshold
    assert tr._read() is None and tr.drop is True
    tr.frame_fn = lambda: None   # a dead camera counts as a miss too
    assert tr._read() is None and tr._drop_counter == 4


def test_eki_wire_format_is_the_reference_bytes():
    rng = np.random.default_rng(0)
    for q in (np.linspace(-1.0, 1.0, 7), rng.uniform(-3, 3, 7), np.array([0, -0.0, 1e-7, 2.5, -1, 3, 4e3])):
        q = q.astype(np.float32)
        assert drivers.EkiIiwaArm._encode_command(q) == j_drivers.EkiIiwaArm._encode_command(q)
        joints = " ".join(f'A{i + 1}="{q[i]:.6f}"' for i in range(7))
        for wrench in ("", '<Wrench Fx="1" Fy="2.5" Fz="-3" Tx="4" Ty="5" Tz="6e-3"/>'):
            state = f"<RobotState><Joints {joints}/>{wrench}</RobotState>"
            (qa, wa), (qb, wb) = drivers.EkiIiwaArm._parse_state(state), j_drivers.EkiIiwaArm._parse_state(state)
            np.testing.assert_array_equal(qa, qb)
            assert qa.dtype == np.float32 and (wa is None) == (wb is None) == (wrench == "")
            if wa is not None:
                np.testing.assert_array_equal(wa, wb)
    with pytest.raises(ET.ParseError):
        drivers.EkiIiwaArm._parse_state("<RobotState><Joints")


def _echo_controller(srv, commanded, n):
    """A fake EKI controller: for each of `n` commands, record the joints and
    echo them back as the measured state, with a 9.8 N wrench."""
    conn, _ = srv.accept()
    conn.settimeout(10.0)
    buf = b""
    try:
        for _ in range(n):
            while b"\n" not in buf:
                buf += conn.recv(4096)
            line, buf = buf.split(b"\n", 1)
            commanded.append(line)
            j = ET.fromstring(line.decode()).find("Joints").attrib
            attrs = " ".join(f'A{i + 1}="{j[f"A{i + 1}"]}"' for i in range(7))
            conn.sendall(f'<RobotState><Joints {attrs}/><Wrench Fx="0" Fy="0" Fz="9.8" Tx="0" Ty="0" '
                         f'Tz="0"/></RobotState>\n'.encode())
    finally:
        conn.close()


def test_eki_arm_loopback_servo_follows_the_reference_ik():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10.0)
    commanded = []
    steps = [(np.array([0.002, 0.0, 0.0]), np.zeros(3)), (np.array([0.0, -0.003, 0.001]), np.array([0.0, 0.0, 0.02]))]
    t = threading.Thread(target=_echo_controller, args=(srv, commanded, len(steps)), daemon=True)
    t.start()
    arm = drivers.EkiIiwaArm("127.0.0.1", port=srv.getsockname()[1], device="cpu")
    ref = j_devices.KinematicArm()
    try:
        np.testing.assert_allclose(arm._init_q, ref._init_q, atol=1e-5)   # the IK of the nominal grasp
        q = np.asarray(arm._q, np.float32)
        for dpos, drot in steps:
            want = np.asarray(ref._ik_step(q, dpos.astype(np.float32), drot.astype(np.float32)))
            arm.servo_delta(dpos, drot)
            np.testing.assert_allclose(arm._q, want, atol=1e-5)
            q = np.asarray(arm._q, np.float32)
        assert np.isclose(arm._wrench[2], 9.8)
        # the wire carried the reference's encoding of what the arm commanded
        assert commanded[-1] + b"\n" == j_drivers.EkiIiwaArm._encode_command(arm._q)
        assert arm._read()["joints"].tolist() == arm._q.tolist()
    finally:
        t.join(timeout=5)
        assert not t.is_alive()
        arm.stop()
        srv.close()


def test_openhand_servo_mapping_is_the_reference():
    o = OpenhandConfig()
    ours, ref = (cls.__new__(cls) for cls in (drivers.SerialOpenhand, j_drivers.SerialOpenhand))
    for hand in (ours, ref):
        hand.oh, hand.motor_ids = o, (1, 2, 3, 4)
    vec = np.array([o.base_angle, o.proximal_open + 0.3, o.distal_open + 0.12, o.proximal_open + 0.5,
                    o.distal_open + 0.20, o.proximal_open + 0.1, o.distal_open + 0.04, 0.25], np.float32)
    ticks = ours._vec_to_servo(vec)
    np.testing.assert_array_equal(ticks, ref._vec_to_servo(vec))
    back = ours._servo_to_vec(ticks)
    np.testing.assert_array_equal(back, ref._servo_to_vec(ticks))
    assert np.allclose(back[[1, 3, 5, 7]], vec[[1, 3, 5, 7]], atol=1e-5)
    for f in range(3):
        assert np.isclose(back[2 + 2 * f] - o.distal_open, 0.4 * (vec[1 + 2 * f] - o.proximal_open), atol=1e-5)


def test_seg_tracker_masks_are_the_reference():
    def frames():
        rng = np.random.default_rng(0)
        x = y = 60
        for i in range(11):
            f = np.full((180, 320, 3), 30, np.uint8)
            f += rng.integers(0, 8, f.shape, dtype=np.uint8)
            f[y:y + 40, x:x + 40] = (200, 60, 60)
            yield f, (x, y)
            x, y = x + 6, y + 3

    ours, ref = drivers.SegTracker(), j_drivers.SegTracker()
    seq = list(frames())
    m0 = np.zeros((180, 320), np.uint8)
    m0[60:100, 60:100] = 1
    np.testing.assert_array_equal(ours.annotate_init_frame(seq[0][0], mask=m0),
                                  ref.annotate_init_frame(seq[0][0], mask=m0))
    for f, _ in seq[1:]:
        a, b = ours.propagate_one_frame(f), ref.propagate_one_frame(f)
        np.testing.assert_array_equal(a, b)
    x, y = seq[-1][1]
    gt = np.zeros((180, 320), bool)
    gt[y:y + 40, x:x + 40] = True
    iou = (gt & (a > 0)).sum() / max((gt | (a > 0)).sum(), 1)
    assert iou > 0.5 and a.max() == 2
    np.testing.assert_array_equal(ours.shrink_mask(a, 20.0), ref.shrink_mask(b, 20.0))
    # a bbox seed and a half-size frame (resized to 320 x 180) as the reference's
    small = seq[3][0][::2, ::2]
    np.testing.assert_array_equal(drivers.SegTracker().annotate_init_frame(small, bbox=(40, 40, 30, 30)),
                                  j_drivers.SegTracker().annotate_init_frame(small, bbox=(40, 40, 30, 30)))


@pytest.mark.parametrize("module,make", [
    ("pyzed", lambda: drivers.ZedCamera()),
    ("dynamixel_sdk", lambda: drivers.SerialOpenhand()),
    ("cv2", lambda: drivers.UsbAllsight()),
    ("cv2", lambda: drivers.ApriltagTracker(frame_fn=lambda: None)),
    ("cv2", lambda: drivers.SegTracker()),
])
def test_each_driver_raises_driver_unavailable_without_its_sdk(module, make, monkeypatch):
    monkeypatch.setitem(sys.modules, module, None)   # the import fails as if it were not installed
    with pytest.raises(drivers.DriverUnavailable, match="not installed"):
        make()


def test_eki_arm_raises_driver_unavailable_when_the_controller_is_unreachable():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()   # nothing listens there
    with pytest.raises(drivers.DriverUnavailable, match="unreachable"):
        drivers.EkiIiwaArm("127.0.0.1", port=port, timeout_s=0.5, device="cpu")
