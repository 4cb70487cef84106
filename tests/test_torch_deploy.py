"""The port's deploy stack (`deploy/`) against the reference on the CPU: the
transport's bytes with either codec, the players' actions on the same
observation dicts (banked r2b, student_r5 and student_r3), the kinematic
arm's joints, `SafetyLimits`, and the loop over loopback TCP and over a CPU
`SimInterface`. Only small jits are compiled on the JAX side (the actor, the
student, the arm's FK/IK); no JAX env step."""

import os
import time

import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.algo.ext_adapt import DAggerConfig as JDAggerConfig
from isaacgyminsertion_tpu.deploy import devices as j_devices
from isaacgyminsertion_tpu.deploy import hardware_player as j_hp
from isaacgyminsertion_tpu.deploy import transport as j_tr
from isaacgyminsertion_tpu.envs.config import default_task_config as j_default_task_config
from isaacgyminsertion_tpu_torch.algo.ext_adapt import DAggerConfig
from isaacgyminsertion_tpu_torch.data.logger import DataLoggerReal
from isaacgyminsertion_tpu_torch.deploy import devices, hardware_player as hp
from isaacgyminsertion_tpu_torch.deploy import transport as tr
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.utils import host_build

torch.set_num_threads(1)

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
TEACHER = os.path.join(CKPTS, "teacher_r2b", "best_success")
R5 = dict(use_obs=True, use_pcl=True, only_bc=True)
R3 = dict(use_obs=True, use_tactile=True, use_seg=True, use_pcl=True, only_bc=False)


def _message():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "i64": np.asarray([2**40, -3], np.int64),
        "u8": np.arange(255, dtype=np.uint8),
        "flag": np.asarray([True, False, True]),
        "scalar": np.asarray(3.5, np.float32),
        "empty": np.zeros((0, 3), np.float64),
        "_op": np.frombuffer(b"obs", dtype=np.uint8),
        "strided": np.arange(12, dtype=np.int32).reshape(3, 4)[:, ::2],
    }


def _same(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch, capsys):
    """The port's transport with its native codec, or with the build failing
    (the Python codec); the choice is announced once, with its reason."""
    monkeypatch.setattr(tr, "_native_tried", False)
    monkeypatch.setattr(tr, "_native", None)
    if request.param == "python":
        def fail(*a, **k):
            raise RuntimeError("g++ not found")
        monkeypatch.setattr(host_build, "build_shared", fail)
    lib = tr._load_native()
    out = capsys.readouterr().out
    if request.param == "native" and lib is None:
        pytest.skip(f"the native codec cannot be built here: {tr.CODEC_NOTE}")
    assert out == f"transport: codec {tr.CODEC} ({tr.CODEC_NOTE})\n" and tr.CODEC == request.param
    if lib is not None:
        assert os.path.dirname(tr.CODEC_NOTE) == os.path.realpath(host_build.BUILD_DIR)
    else:
        assert "g++ not found" in tr.CODEC_NOTE
    tr.pack({"x": np.zeros(1, np.float32)})
    assert capsys.readouterr().out == ""          # said once
    return request.param


def test_codec_bytes_equal_the_reference_both_ways(codec):
    msg = _message()
    ref = j_tr._py_pack(msg)
    assert j_tr.pack(msg) == ref
    buf = tr.pack(msg)
    assert buf == ref and tr._py_pack(msg) == ref
    for decode in (tr.unpack, tr._py_unpack):
        _same(decode(ref), msg)
    for decode in (j_tr.unpack, j_tr._py_unpack):
        _same(decode(buf), msg)


@pytest.mark.parametrize("bad", ["truncated", "magic", "overrun", "dtype", "short"])
def test_malformed_message_raises_codec_error(codec, bad):
    buf = bytearray(tr.pack({"a": np.arange(4, dtype=np.float32), "b": np.ones(2, np.int64)}))
    if bad == "truncated":
        buf = buf[:-5]
    elif bad == "magic":
        buf[0] ^= 0xFF
    elif bad == "overrun":
        buf[4:8] = (3).to_bytes(4, "little")          # claims a third array
    elif bad == "dtype":
        buf[13:17] = (9).to_bytes(4, "little")        # array "a": an unknown dtype code
    else:
        buf = buf[:6]
    for decode in (tr.unpack, tr._py_unpack):
        with pytest.raises(tr.CodecError):
            decode(bytes(buf))
    with pytest.raises(tr.CodecError):
        tr.pack({"x" * 300: np.zeros(1, np.float32)})


class ReplayHardware:
    """Hands out fixed observation dicts and records the commanded deltas."""

    def __init__(self, obs):
        self.obs, self.t, self.deltas = obs, 0, []

    def reset(self):
        self.t = 0

    def get_observation(self):
        ob = self.obs[min(self.t, len(self.obs) - 1)]
        self.t += 1
        return {k: v.copy() for k, v in ob.items()}

    def apply_action(self, delta_pos, delta_rot):
        self.deltas.append(np.concatenate([np.asarray(delta_pos), np.asarray(delta_rot)]))


def _observations(n=3, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return [{"obs": f32(rng.normal(size=15) * 0.5), "student_obs": f32(rng.normal(size=15) * 0.5),
             "tactile": f32(rng.uniform(0, 1, (1, 3, 64, 64, 3))),
             "img": np.zeros((0,), np.float32),
             "seg": f32(rng.integers(0, 4, (1, 54, 96))),
             "pcl": f32(rng.normal(size=(1, 800, 3)) * 0.05)} for _ in range(n)]


def _actions(player, obs):
    hw = ReplayHardware(obs)
    assert player.deploy(hw, num_steps=len(obs)) == len(obs)
    d = np.stack(hw.deltas)
    return np.concatenate([d[:, :3] / 0.002, d[:, 3:] / 0.01], axis=1)


@pytest.mark.parametrize("which", ["teacher_r2b", "student_r5", "student_r3"])
def test_players_act_as_the_reference_players(which):
    obs = _observations()
    if which == "teacher_r2b":
        ref = j_hp.HardwarePlayer(TEACHER, j_default_task_config())
        port = hp.HardwarePlayer(TEACHER, default_task_config(), device="cpu")
    else:
        flags = R5 if which == "student_r5" else R3
        student = os.path.join(CKPTS, which, "best_success")
        ref = j_hp.StudentHardwarePlayer(TEACHER, student, JDAggerConfig(**flags), j_default_task_config())
        port = hp.StudentHardwarePlayer(TEACHER, student, DAggerConfig(**flags), default_task_config(),
                                        device="cpu")
    a_ref, a = _actions(ref, obs), _actions(port, obs)
    assert np.abs(a_ref).max() > 1e-2 and np.abs(a).max() <= 1.0
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=1e-5)


def test_diffusion_player_acts_as_the_reference_player(tmp_path):
    """The reference's diffusion player and the port's on one flax UNet (EMA
    weights saved by the reference's Checkpointer), each DDIM plan started
    from the x_T the reference draws from its key: the same actions."""
    import jax

    from isaacgyminsertion_tpu.models.diffusion import DiffusionPolicy as JDiffusionPolicy
    from isaacgyminsertion_tpu.utils.checkpoint import Checkpointer as JCheckpointer

    cfg = default_task_config()
    params = JDiffusionPolicy(act_dim=6, obs_dim=15).init(jax.random.PRNGKey(3))
    JCheckpointer(str(tmp_path)).save_last({"ema_params": params}, 0)
    obs = _observations(3, seed=4)
    ref = j_hp.DiffusionHardwarePlayer(str(tmp_path / "last"), j_default_task_config(), execute_horizon=2)
    port = hp.DiffusionHardwarePlayer(str(tmp_path / "last"), cfg, execute_horizon=2, device="cpu")
    key, xs = jax.random.PRNGKey(0), []
    for _ in range(3):                                  # the reference's key for each plan
        key, k = jax.random.split(key)
        xs.append(torch.as_tensor(np.asarray(jax.random.normal(k, (1, 8, 6)))))
    sample, it = port.policy.sample_ddim, iter(xs)
    port.policy.sample_ddim = lambda net, o, generator=None: sample(net, o, x=next(it))
    hw_ref, hw = ReplayHardware(obs), ReplayHardware(obs)
    assert ref.deploy(hw_ref, num_steps=5) == port.deploy(hw, num_steps=5) == 5
    np.testing.assert_allclose(np.stack(hw.deltas), np.stack(hw_ref.deltas), rtol=0, atol=1e-7)
    assert np.abs(np.stack(hw_ref.deltas)).max() > 1e-4


def test_position_player_acts_on_the_reference_regressor(tmp_path):
    """The port's position player on a flax regressor saved by the reference's
    Checkpointer: its prediction is the reference network's (1e-5) and its
    action the P-controller of the reference player on that prediction."""
    import jax

    from isaacgyminsertion_tpu.algo.tactile_runner import TactileRegressionRunner, TactileRunnerConfig
    from isaacgyminsertion_tpu.utils.checkpoint import Checkpointer as JCheckpointer

    runner = TactileRegressionRunner(TactileRunnerConfig(), out_dir=str(tmp_path / "runner"))
    obs = _observations(2, seed=5)
    params = runner.net.init(jax.random.PRNGKey(1), obs[0]["tactile"])
    JCheckpointer(str(tmp_path)).save_last({"params": params}, 0)
    port = hp.PosPredHardwarePlayer(str(tmp_path / "last"), default_task_config(), device="cpu")
    hw = ReplayHardware(obs)
    assert port.deploy(hw, num_steps=2) == 2
    for ob, delta in zip(obs, hw.deltas):
        pred = np.asarray(runner.net.apply(params, ob["tactile"][None, -1]))[0]
        np.testing.assert_allclose(port.predict(ob["tactile"][None, -1])[0], pred, rtol=0, atol=1e-5)
        act = np.clip((np.asarray([0.5, 0.0, 0.0]) - pred[:3]) / 0.002, -1.0, 1.0)
        np.testing.assert_allclose(delta[:3] / 0.002, act, rtol=0, atol=1e-4)
        assert not delta[3:].any()


@pytest.fixture(scope="module")
def sim():
    return hp.SimInterface(default_task_config(), seed=0, device="cpu")


def test_teacher_player_on_a_cpu_sim_logs_the_schema(sim, tmp_path):
    player = hp.HardwarePlayer(TEACHER, sim.cfg, device="cpu")
    logger = DataLoggerReal(str(tmp_path))
    assert player.deploy(sim, num_steps=3, logger=logger) == 3
    logger.close()
    with np.load(tmp_path / "traj_000000.npz") as z:
        assert z["actions"].shape == (3, 6) and z["eef_pos"].shape == (3, 3) and z["eef_quat"].shape == (3, 4)
        assert z["obs"].shape == (3, 15) and bool(z["done"][-1])
    pos, quat = sim.eef_pose
    assert pos.shape == (3,) and abs(float(np.linalg.norm(quat)) - 1.0) < 1e-5


def test_loopback_player_matches_the_local_run(sim):
    """A serve and a 4-step player over RemoteInterface on a CPU SimInterface:
    the actions of the same player on a local SimInterface of the same seed
    (within 1e-5), and to the bit those of a local run fed the deltas as the
    wire carries them (4 steps: there the plain local run first differs)."""
    player = hp.HardwarePlayer(TEACHER, sim.cfg, device="cpu")
    steps = 4
    local = []

    class Recorder:
        def add_step(self, ob, act, done=False):
            local.append(act)

    sim.generator.manual_seed(0)
    player.deploy(sim, num_steps=steps, logger=Recorder())
    remote_acts = []

    class RemoteRecorder:
        def add_step(self, ob, act, done=False):
            remote_acts.append(act)

    served = hp.SimInterface(sim.cfg, seed=0, device="cpu")
    served.generator.manual_seed(0)
    thread = tr.serve_hardware(served, port=0)
    try:
        remote = tr.RemoteInterface(port=thread.server.server_address[1])
        assert player.deploy(remote, num_steps=steps, logger=RemoteRecorder()) == steps
        ob = remote.get_observation()
        assert ob["obs"].dtype == np.float32 and ob["eef_pos"].shape == (3,)
        remote.close()
    finally:
        thread.server.shutdown()
        thread.server.server_close()
    np.testing.assert_allclose(np.stack(remote_acts), np.stack(local), rtol=0, atol=1e-5)
    # the wire carries the deltas as float32 (RemoteInterface.apply_action): a local run fed
    # float32 deltas takes the served run's actions to the bit
    local32 = []

    class Recorder32:
        def add_step(self, ob, act, done=False):
            local32.append(act)

    wire = hp.SimInterface(sim.cfg, seed=0, device="cpu")
    wire.generator.manual_seed(0)
    assert player.deploy(tr.WireDeltas(wire), num_steps=steps, logger=Recorder32()) == steps
    assert np.array_equal(np.stack(remote_acts), np.stack(local32))


def test_diffusion_and_position_players_run_on_a_cpu_sim(tmp_path):
    """Checkpoints in the flax layout (a fresh UNet's EMA weights, a fresh
    regressor); the position player on the tactile flag renders a frame a step."""
    import dataclasses

    from isaacgyminsertion_tpu_torch.models import student as st
    from isaacgyminsertion_tpu_torch.models.diffusion import DiffusionPolicy
    from isaacgyminsertion_tpu_torch.models.zoo import to_jax_params
    from isaacgyminsertion_tpu_torch.utils.checkpoint import Checkpointer

    cfg = default_task_config()
    unet = DiffusionPolicy().init(torch.Generator().manual_seed(0))
    Checkpointer(str(tmp_path / "diff")).save_last({"ema_params": to_jax_params(unet)}, 0)
    head = st.init_student_like_flax(st.TactileHead(9, 7), torch.Generator().manual_seed(0))
    Checkpointer(str(tmp_path / "reg")).save_last({"params": st.student_to_jax_params(head.state_dict())}, 0)
    diff = hp.DiffusionHardwarePlayer(str(tmp_path / "diff" / "last"), cfg, execute_horizon=2, device="cpu")
    hw = ReplayHardware(_observations(1))
    assert diff.deploy(hw, num_steps=3) == 3 and len(hw.deltas) == 3   # two plans of 2, cut at 3
    d = np.stack(hw.deltas)
    assert np.isfinite(d).all() and np.abs(d[:, :3]).max() <= 0.002 and np.abs(d[:, 3:]).max() <= 0.01
    tact = hp.SimInterface(cfg.replace(env=dataclasses.replace(cfg.env, tactile=True)), device="cpu")
    pos = hp.PosPredHardwarePlayer(str(tmp_path / "reg" / "last"), tact.cfg, device="cpu")
    assert pos.deploy(tact, num_steps=2) == 2
    assert tact.get_observation()["tactile"].shape == (1, 3, 64, 64, 3)


def test_kinematic_arm_follows_the_reference_arm():
    ref, arm = j_devices.KinematicArm(), devices.KinematicArm(device="cpu")
    np.testing.assert_allclose(arm._init_q, ref._init_q, rtol=0, atol=1e-5)
    arm._q = np.asarray(ref._q, np.float32).copy()
    rng = np.random.default_rng(0)
    for _ in range(10):
        dpos = rng.uniform(-2e-3, 2e-3, 3).astype(np.float32)
        drot = rng.uniform(-1e-2, 1e-2, 3).astype(np.float32)
        ref.servo_delta(dpos, drot)
        arm.servo_delta(dpos, drot)
    np.testing.assert_allclose(arm._q, np.asarray(ref._q), rtol=0, atol=1e-5)
    for a, b in zip(arm._read().values(), ref._read().values()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(arm.jacobian(), ref.jacobian(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ee,dpos,drot", [
    ([0.5, 0.0, 0.1], [0.05, 0.0, 0.0], [0.5, 0.0, 0.0]),
    ([0.8, 0.0, 0.1], [0.002, 0.0, 0.0], [0.0, 0.0, 0.0]),
    ([0.2, -0.3, 0.003], [-0.004, -0.001, -0.006], [-0.2, 0.03, 0.07]),
    ([0.79, 0.29, 0.49], [0.004, 0.004, 0.004], [0.01, -0.01, 0.0]),
])
def test_safety_limits_equal_the_reference(ee, dpos, drot):
    for lim, j_lim in ((devices.SafetyLimits(), j_devices.SafetyLimits()),
                       (devices.SafetyLimits(max_dpos=0.002, max_drot=0.01),
                        j_devices.SafetyLimits(max_dpos=0.002, max_drot=0.01))):
        args = (np.asarray(ee), np.asarray(dpos), np.asarray(drot))
        out, ref = lim.clamp(*args), j_lim.clamp(*args)
        assert all(np.array_equal(a, b) for a, b in zip(out, ref))


def test_composite_env_servos_clamps_and_latches():
    """The composite env on a CPU arm: the observation layout, a servo along
    +x moves the eef along +x, the workspace wall clamps a step, and a wrench
    spike latches the fault."""
    env = devices.CompositeEnv(devices.CompositeEnvConfig(with_tactile=True, with_pcl=True), device="cpu")
    try:
        assert env.ready
        env.reset()
        ob = env.get_observation()
        assert ob["obs"].shape == (15,) and ob["tactile"].shape == (1, 3, 64, 64, 3) and ob["ft"].shape == (6,)
        p0 = env.arm._read()["ee_pos"].copy()
        for _ in range(5):
            env.apply_action(np.array([0.002, 0, 0]), np.zeros(3))
            time.sleep(0.01)
        p1 = env.arm._read()["ee_pos"]
        assert p1[0] - p0[0] > 0.005 and abs(p1[1] - p0[1]) < 2e-3 and abs(p1[2] - p0[2]) < 2e-3
        assert abs(env.get_observation()["obs"][9] - 0.002) < 1e-6
        time.sleep(0.02)
        env.cfg.safety.workspace_hi = (float(env.arm.latest()["ee_pos"][0]) + 1e-3, 0.3, 0.5)
        env.apply_action(np.array([0.005, 0, 0]), np.zeros(3))
        assert abs(env._last_action[0] - 1e-3) < 1e-6               # the wall, not the command
        env.arm._wrench = np.array([100.0, 0, 0, 0, 0, 0], np.float32)
        time.sleep(0.05)
        env.apply_action(np.array([0.001, 0, 0]), np.zeros(3))
        q = env.arm._read()["joints"].copy()
        env.apply_action(np.array([0.001, 0, 0]), np.zeros(3))
        assert env.fault and np.array_equal(env.arm._read()["joints"], q)
    finally:
        env.close()


def test_device_polls_and_detects_staleness():
    class Counting(devices.Device):
        def __init__(self):
            super().__init__(rate_hz=200.0, name="count")
            self.n = 0

        def _read(self):
            self.n += 1
            return {"n": np.int64(self.n)}

    d = Counting()
    assert d.start() and d.init_success
    time.sleep(0.05)
    assert int(d.latest(max_age=0.5)["n"]) >= 1
    d.stop()
    time.sleep(0.02)
    assert d.latest(max_age=0.01) is None and d.latest() is not None
