"""Deploy-control calibration (reference algo/deploy/calib.py mirror).

Port of `isaacgyminsertion_tpu/deploy/calib.py`: numpy code over the port's
`sysid` TPE, unchanged.

The reference's `HardwarePlayer` + `hyper_param_tune` (calib.py:23-266)
replays recorded sim trajectories on the real arm and TPE-tunes the deploy
action scales (`pos_scale_deploy`/`rot_scale_deploy`, calib.py:27-28) until
the hardware end-effector trail matches the sim trail. Here the same loop
runs against any `HardwareInterface` (ROS out of scope: the `SimInterface`
exercises it end to end), and the TPE is the self-contained numpy
implementation shared with sys-id (sysid.py).
"""

from __future__ import annotations

import glob as _glob

import numpy as np

from ..sysid import Uniform, tpe_minimize


def load_sim_trajectories(pattern: str, max_files: int = 16) -> list[dict]:
    """Load recorded sim trajectories (npz with eef_pos/eef_quat/actions —
    the logger schema, data/logger.py) for replay (calib.py:39-101)."""
    out = []
    for path in sorted(_glob.glob(pattern))[:max_files]:
        with np.load(path) as z:
            out.append({k: np.asarray(z[k]) for k in ("eef_pos", "eef_quat", "actions")
                        if k in z})
    return [t for t in out if "actions" in t and "eef_pos" in t]


def replay_trajectory(hw, actions: np.ndarray, pos_scale, rot_scale,
                      max_steps: int | None = None) -> np.ndarray:
    """Replay an action sequence through the interface with candidate deploy
    scales; returns the achieved eef positions [T, 3]."""
    hw.reset()
    trail = []
    T = len(actions) if max_steps is None else min(len(actions), max_steps)
    for t in range(T):
        a = np.clip(actions[t], -1.0, 1.0)
        hw.apply_action(a[:3] * np.asarray(pos_scale), a[3:] * np.asarray(rot_scale))
        trail.append(np.asarray(hw.eef_pose[0]))
    return np.stack(trail)


def calibrate_deploy_scales(
    hw,
    sim_trajectories: list[dict],
    n_trials: int = 20,
    max_steps: int = 50,
    seed: int = 0,
    pos_range=(5.0e-5, 3.0e-3),
    rot_range=(5.0e-5, 3.0e-3),
) -> tuple[dict, float]:
    """TPE-minimize mean eef position error between the replayed trail and
    the recorded sim trail (hyper_param_tune objective, calib.py:208-266).

    Returns (best params dict with pos_scale_{x,y,z} / rot_scale_{r,p,y},
    best loss in meters, history).

    Every candidate is scored on the mean error over ALL loaded trajectories
    (not one sampled per trial) so the optimizer compares scales on the same
    objective instead of conflating scale quality with trajectory difficulty."""
    space = {
        "pos_scale_x": Uniform(*pos_range), "pos_scale_y": Uniform(*pos_range),
        "pos_scale_z": Uniform(*pos_range), "rot_scale_r": Uniform(*rot_range),
        "rot_scale_p": Uniform(*rot_range), "rot_scale_y": Uniform(*rot_range),
    }

    def objective(params: dict) -> float:
        errs = []
        for traj in sim_trajectories:
            T = min(max_steps, len(traj["actions"]))
            trail = replay_trajectory(
                hw, traj["actions"][:T],
                [params["pos_scale_x"], params["pos_scale_y"], params["pos_scale_z"]],
                [params["rot_scale_r"], params["rot_scale_p"], params["rot_scale_y"]],
            )
            ref = traj["eef_pos"][:T]
            # compare displacement trails from the (different) start poses
            d = (trail - trail[0]) - (ref - ref[0])
            errs.append(float(np.mean(np.linalg.norm(d, axis=-1))))
        return float(np.mean(errs))

    best, history = tpe_minimize(objective, space, n_trials=n_trials, seed=seed)
    return best, min(loss for _, loss in history), history
