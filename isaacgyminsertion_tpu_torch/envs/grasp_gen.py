"""Grasp-pose dataset generation and loading.

Port of `isaacgyminsertion_tpu/envs/grasp_gen.py`: the FactoryTaskGraspTactile
product. Each round resets a batch of envs to the analytic grasp, settles it
under simulation with gravity forced on (−9.81), keeps the envs whose plug
stayed held (its base within 5 cm of its starting height) and stores the
self-consistent triple (dof_pos, socket pose, plug pose in the
fingertip-centered hand frame). Insertion resets replay those rows
(`envs/insertion.py`, `grasp_data=`).

The file is one `np.savez_compressed` with the reference's six keys and
dtypes: sub_idx int32 [S], dof_pos [S, 15], socket_pos [S, 3], socket_quat
[S, 4], plug_pos_hand [S, 3], plug_quat_hand [S, 4] (float32), so the two
packages read each other's files.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import rotations as rot
from ..physics import engine
from ..physics.kinematics import forward_kinematics, site_pose
from ..physics.robot import SITE_FINGERTIP_CENTERED
from .config import TaskConfig

KEYS = ("sub_idx", "dof_pos", "socket_pos", "socket_quat", "plug_pos_hand", "plug_quat_hand")


class GraspData(NamedTuple):
    """Padded per-subassembly grasp table (numpy); rows past `count` hold the
    reference's fill values."""

    dof_pos: np.ndarray         # [n_sub, S, 15]
    socket_pos: np.ndarray      # [n_sub, S, 3]
    socket_quat: np.ndarray     # [n_sub, S, 4]
    plug_pos_hand: np.ndarray   # [n_sub, S, 3] plug base pos in the hand frame
    plug_quat_hand: np.ndarray  # [n_sub, S, 4]
    count: np.ndarray           # [n_sub] valid rows per subassembly


def generate_grasp_dataset(cfg: TaskConfig, model, subs, n_envs: int, n_rounds: int, out_path: str,
                           seed: int = 0, settle_steps: int = 30, device=None) -> int:
    """Simulate `n_rounds` grasp-settling rounds of `n_envs` envs and write
    the npz dataset → the number of rows written."""
    from . import insertion

    dev = resolve_device(device)
    rows: dict[str, list] = {k: [] for k in KEYS}
    gen = insertion.make_generator(seed, dev)
    with torch.no_grad():
        for _ in range(n_rounds):
            state = insertion.reset_all(cfg, model, subs, gen, n_envs)
            phys, params = state.phys, state.params
            # gravity on, so only genuinely held plugs survive settling
            params = params._replace(gravity=torch.full_like(params.gravity, -9.81))
            ctrl = engine.ControlInput(q_target=phys.q, tau_cmd=torch.zeros_like(phys.q),
                                       torque_mode_mask=torch.zeros((15,), device=dev),
                                       plug_wrench=torch.zeros((n_envs, 6), device=dev))
            for _ in range(settle_steps):
                phys = engine.step(model, params, phys, ctrl, dt=cfg.sim.dt, n_substeps=cfg.sim.substeps)
            held = torch.abs(phys.plug_pos[:, 2] - state.phys.plug_pos[:, 2]) < 0.05
            hand_q, hand_t = site_pose(model, forward_kinematics(model, phys.q), SITE_FINGERTIP_CENTERED)
            inv_q, inv_t = rot.tf_inverse(hand_q, hand_t)
            rel_q, rel_t = rot.tf_combine(inv_q, inv_t, phys.plug_quat, phys.plug_pos)
            keep = held.cpu().numpy()
            host = lambda x: x.cpu().numpy()[keep]
            rows["sub_idx"].append(host(state.sub_idx).astype(np.int32))
            rows["dof_pos"].append(host(phys.q))
            rows["socket_pos"].append(host(params.socket_pos))
            rows["socket_quat"].append(host(params.socket_quat))
            rows["plug_pos_hand"].append(host(rel_t))
            rows["plug_quat_hand"].append(host(rel_q))
    widths = dict(sub_idx=None, dof_pos=15, socket_pos=3, socket_quat=4, plug_pos_hand=3, plug_quat_hand=4)
    out = {}
    for k, w in widths.items():
        cat = np.concatenate(rows[k]) if rows[k] else np.zeros((0,) if w is None else (0, w))
        out[k] = cat.astype(np.int32 if w is None else np.float32)
    np.savez_compressed(out_path, **out)
    return int(out["sub_idx"].shape[0])


def load_grasp_data(path: str, n_sub: int, max_rows: int = 512, model=None,
                    max_ang: float = 0.4) -> GraspData:
    """Pack the npz rows into the padded per-subassembly table (the first
    `max_rows` rows of each subassembly). With a robot `model`, rows whose
    world-frame plug Euler angles exceed `max_ang` rad are dropped first:
    they would degrasp-reset at once. The world orientation is rebuilt from
    the stored dof_pos by FK (on the CPU, float32)."""
    with np.load(path) as d:
        sub_idx, dof = d["sub_idx"], d["dof_pos"]
        spos, squat = d["socket_pos"], d["socket_quat"]
        pos, quat = d["plug_pos_hand"], d["plug_quat_hand"]
    if model is not None and len(sub_idx):
        fk = forward_kinematics(model, torch.as_tensor(np.asarray(dof, np.float32)))
        hand_q, _ = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
        world_q = rot.quat_mul(hand_q, torch.as_tensor(np.asarray(quat, np.float32)))
        eul = rot.euler_xyz_signed(world_q).numpy()
        keep = ~np.any(np.abs(eul) > max_ang, axis=-1)
        n_removed = int((~keep).sum())
        if n_removed:
            print(f"removed: {n_removed} grasp rows (Euler outliers > {max_ang} rad)")
        sub_idx, dof = sub_idx[keep], dof[keep]
        spos, squat, pos, quat = spos[keep], squat[keep], pos[keep], quat[keep]

    out_dof = np.zeros((n_sub, max_rows, 15), np.float32)
    out_spos = np.tile(np.asarray([0.5, 0.0, 0.001], np.float32), (n_sub, max_rows, 1))
    out_squat = np.tile(np.asarray([0, 0, 0, 1], np.float32), (n_sub, max_rows, 1))
    out_pos = np.zeros((n_sub, max_rows, 3), np.float32)
    out_quat = np.tile(np.asarray([0, 0, 0, 1], np.float32), (n_sub, max_rows, 1))
    count = np.zeros((n_sub,), np.int32)
    for s in range(n_sub):
        rows = np.where(sub_idx == s)[0][:max_rows]
        c = len(rows)
        count[s] = c
        if c:
            out_dof[s, :c] = dof[rows]
            out_spos[s, :c] = spos[rows]
            out_squat[s, :c] = squat[rows]
            out_pos[s, :c] = pos[rows]
            out_quat[s, :c] = quat[rows]
    return GraspData(dof_pos=out_dof, socket_pos=out_spos, socket_quat=out_squat,
                     plug_pos_hand=out_pos, plug_quat_hand=out_quat, count=count)
