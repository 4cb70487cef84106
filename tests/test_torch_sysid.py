"""The port's sys-id (`sysid.py`, `vec_env.SysIdTask`) and deploy-scale
calibration (`deploy/calib.py`) against the reference on the CPU. The TPE and
the calibration are numpy code: the same seed gives the same history to the
bit. The replay objective runs on the port's env only (no JAX env step is
compiled): one env, T = 4 steps."""

import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu import sysid as j_sysid
from isaacgyminsertion_tpu.deploy import calib as j_calib
from isaacgyminsertion_tpu_torch import sysid
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.deploy import calib
from isaacgyminsertion_tpu_torch.envs import insertion, vec_env
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand

torch.set_num_threads(1)

TRUE_SCALES = {"mu_scale": 1.5, "kp_scale": 1.0, "kd_scale": 1.0, "mass_scale": 1.2}


def _space(mod):
    return {"x": mod.Uniform(-2.0, 2.0), "y": mod.Uniform(-1.0, 3.0), "z": mod.Uniform(0.5, 1.5)}


@pytest.mark.parametrize("n_trials,seed", [(12, 0), (30, 5)])
def test_tpe_history_matches_the_reference_to_the_bit(n_trials, seed):
    """Both the random start (< 8 trials) and the KDE branch."""
    f = lambda p: (p["x"] - 0.7) ** 2 + abs(p["y"] + 0.3) + np.sin(3 * p["z"])
    j_best, j_hist = j_sysid.tpe_minimize(f, _space(j_sysid), n_trials=n_trials, seed=seed)
    best, hist = sysid.tpe_minimize(f, _space(sysid), n_trials=n_trials, seed=seed)
    assert hist == j_hist and best == j_best
    assert sysid.DEFAULT_SPACE == {k: sysid.Uniform(v.lo, v.hi) for k, v in j_sysid.DEFAULT_SPACE.items()}


class StubArm:
    """A numpy hardware stand-in: the eef integrates the commanded deltas
    through a fixed skew and a soft saturation."""

    def __init__(self):
        self.skew = np.asarray([[1.0, 0.1, 0.0], [0.0, 0.8, 0.05], [0.02, 0.0, 1.2]])
        self.reset()

    def reset(self):
        self.pos = np.asarray([0.5, 0.0, 0.2])

    def apply_action(self, delta_pos, delta_rot):
        self.pos = self.pos + np.tanh(200.0 * self.skew @ np.asarray(delta_pos)) / 200.0 \
            + 1e-3 * np.asarray(delta_rot)

    @property
    def eef_pose(self):
        return self.pos.copy(), np.asarray([0.0, 0.0, 0.0, 1.0])


def test_calibration_matches_the_reference_on_a_stub_arm(tmp_path):
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (12, 6)).astype(np.float32)
    arm = StubArm()
    trail = calib.replay_trajectory(arm, actions, [1e-3, 2e-3, 5e-4], [1e-3, 1e-3, 1e-3])
    np.savez(tmp_path / "traj_000000.npz", actions=actions, eef_pos=trail,
             eef_quat=np.tile([0, 0, 0, 1.0], (12, 1)), done=np.zeros(12, bool))
    trajs = calib.load_sim_trajectories(str(tmp_path / "*.npz"))
    j_trajs = j_calib.load_sim_trajectories(str(tmp_path / "*.npz"))
    assert len(trajs) == 1 and all(np.array_equal(trajs[0][k], j_trajs[0][k]) for k in j_trajs[0])
    out = calib.calibrate_deploy_scales(StubArm(), trajs, n_trials=10, max_steps=10, seed=2)
    ref = j_calib.calibrate_deploy_scales(StubArm(), j_trajs, n_trials=10, max_steps=10, seed=2)
    assert out == ref                  # best, best loss and history, to the bit
    assert np.isfinite(out[1]) and len(out[2]) == 10


@pytest.fixture(scope="module")
def recording():
    """T = 4 steps of one env under the true scales, from the reset every
    trial starts from (a generator seeded 0)."""
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    gen = insertion.make_generator(0, "cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, gen, 1)
        state = state._replace(params=sysid.scale_params(state.params, TRUE_SCALES))
        acts, pos, quat = [], [], []
        for _ in range(4):
            a = torch.as_tensor(rng.uniform(-0.5, 0.5, (1, 6)), dtype=torch.float32)
            state, _ = insertion.step(cfg, model, subs, state, a, gen)
            acts.append(a[0].numpy())
            pos.append(state.phys.plug_pos[0].numpy())
            quat.append(state.phys.plug_quat[0].numpy())
    return cfg, model, subs, {"actions": np.stack(acts), "plug_pos": np.stack(pos), "plug_quat": np.stack(quat)}


def test_replay_objective_scores_the_true_scales_below_far_ones(recording):
    cfg, model, subs, rec = recording
    obj = sysid.make_replay_objective(cfg, model, subs, rec, device="cpu")
    true = obj(TRUE_SCALES)
    far = obj({"mu_scale": 0.5, "kp_scale": 0.5, "kd_scale": 2.0, "mass_scale": 0.5})
    ones = obj({})
    assert true == 0.0                 # the replay repeats the recording exactly on the CPU
    assert far > true and ones > true and np.isfinite(far)


def test_sysid_task_and_cli_run_two_trials(recording, tmp_path, capsys):
    cfg, _, _, rec = recording
    task = vec_env.make("FactoryTaskOptimizeTactile", device="cpu")
    assert isinstance(task, vec_env.SysIdTask) and task.device == torch.device("cpu")
    best, hist = task.run(rec, n_trials=2, seed=1)
    assert len(hist) == 2 and set(best) == set(sysid.DEFAULT_SPACE)
    assert all(np.isfinite(loss) for _, loss in hist)
    np.savez(tmp_path / "rec.npz", **rec)
    best2, hist2 = sysid.main(["--traj", str(tmp_path / "rec.npz"), "--trials", "2", "--seed", "1",
                               "--device", "cpu"])
    assert hist2 == hist and best2 == best   # the same trials: each starts from the same reset
    assert "best sim params:" in capsys.readouterr().out
