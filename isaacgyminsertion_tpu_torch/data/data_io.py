"""Dataset inspection / merge utilities (parity: isaacgyminsertion/data_io/*:
pull_grasping_poses.py grasp-dataset merge/inspect, failed-file cleanup,
frame extraction).

Port of `isaacgyminsertion_tpu/data/data_io.py` (numpy only, unchanged)."""

from __future__ import annotations

import glob
import os

import numpy as np

from .dataset import list_trajectory_files, open_traj


def merge_grasp_datasets(paths: list[str], out_path: str) -> int:
    """Concatenate grasp npz files (pull_grasping_poses.py merge parity)."""
    keys = ("sub_idx", "dof_pos", "socket_pos", "socket_quat",
            "plug_pos_hand", "plug_quat_hand")
    acc: dict[str, list] = {k: [] for k in keys}
    for p in paths:
        with np.load(p) as d:
            for k in keys:
                acc[k].append(np.asarray(d[k]))
    merged = {k: np.concatenate(v) for k, v in acc.items()}
    np.savez_compressed(out_path, **merged)
    return len(merged["sub_idx"])


def inspect_trajectories(data_dir: str) -> dict:
    """Summary stats over a trajectory dataset directory."""
    files = list_trajectory_files(data_dir)
    lengths, successes = [], []
    for p in files:
        try:
            with open_traj(p) as d:
                lengths.append(int(d["done_idx"]) + 1)
                if "success" in d:
                    successes.append(bool(np.asarray(d["success"]).any()))
        except Exception:
            continue
    return {
        "num_trajectories": len(lengths),
        "mean_length": float(np.mean(lengths)) if lengths else 0.0,
        "success_rate": float(np.mean(successes)) if successes else float("nan"),
    }


def cleanup_corrupt_files(data_dir: str) -> int:
    """Remove unreadable npz files (data_io failed-file cleanup parity)."""
    removed = 0
    for p in list_trajectory_files(data_dir):
        try:
            with open_traj(p) as d:
                _ = list(d.keys())
        except Exception:
            os.remove(p)
            removed += 1
    return removed


def extract_frames(traj_path: str, out_dir: str, key: str = "img") -> int:
    """Dump per-step sensor frames from one trajectory npz (frame extraction)."""
    os.makedirs(out_dir, exist_ok=True)
    with np.load(traj_path) as d:
        if key not in d:
            return 0
        arr = np.asarray(d[key])
    for t in range(arr.shape[0]):
        np.save(os.path.join(out_dir, f"{key}_{t:04d}.npy"), arr[t])
    return arr.shape[0]
