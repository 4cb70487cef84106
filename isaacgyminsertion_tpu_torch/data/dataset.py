"""Offline trajectory dataset + normalization (parity: transformer/data.py).

Port of `isaacgyminsertion_tpu/data/dataset.py`, numpy only and unchanged
but for its `.itraj` reader, the port's own (`native.read_trajectory`).

`DataNormalizer` builds/loads per-key mean/std stats (normalization.pkl,
data.py:129-271) and removes failed trajectories; `TactileDataset` indexes
fixed-length sub-sequences (stride 1) of every trajectory up to its done
index (data.py:318-329) and yields numpy batches. No torch DataLoader — batches
are assembled with numpy and fed to the train steps; shuffling is a
permutation over the global index table.
"""

from __future__ import annotations

import glob
import os
import pickle
from contextlib import contextmanager

import numpy as np

NORM_KEYS = ("student_obs", "obs", "eef_pos", "plug_pos", "socket_pos", "pcl")


def split_trajectory_files(data_dir: str, val_fraction: float,
                           seed: int = 0) -> tuple[list[str], list[str]]:
    """Honest held-out split BY TRAJECTORY (before any sub-sequence batching),
    so validation loss is measured on trajectories the model never trained on
    (the reference draws "val" batches from the same shuffled pool —
    runner.py:470-572 — which this consciously fixes)."""
    files = list_trajectory_files(data_dir)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(files))
    n_val = max(int(round(val_fraction * len(files))), 1) if len(files) > 1 else 0
    val_idx = set(order[:n_val].tolist())
    train = [f for i, f in enumerate(files) if i not in val_idx]
    val = [f for i, f in enumerate(files) if i in val_idx]
    return train, val


def list_trajectory_files(data_dir: str) -> list[str]:
    """Trajectory files of either format (.npz numpy / .itraj native writer)."""
    return sorted(
        glob.glob(os.path.join(data_dir, "*.npz"))
        + glob.glob(os.path.join(data_dir, "*.itraj"))
    )


@contextmanager
def open_traj(path: str):
    """Uniform reader over .npz and native .itraj files."""
    if path.endswith(".itraj"):
        from ..native import read_trajectory

        yield read_trajectory(path)
    else:
        with np.load(path) as d:
            yield d


class DataNormalizer:
    def __init__(self, data_dir: str, stats_path: str | None = None):
        self.data_dir = data_dir
        self.stats_path = stats_path or os.path.join(data_dir, "normalization.pkl")
        self.stats: dict = {}

    def run(self, max_files: int | None = None) -> dict:
        if os.path.exists(self.stats_path):
            with open(self.stats_path, "rb") as f:
                self.stats = pickle.load(f)
            return self.stats
        files = list_trajectory_files(self.data_dir)[:max_files]
        acc: dict[str, list] = {}
        for path in files:
            with open_traj(path) as d:
                for k in NORM_KEYS:
                    if k in d:
                        acc.setdefault(k, []).append(np.asarray(d[k], np.float64))
        for k, chunks in acc.items():
            flat = np.concatenate([c.reshape(-1, c.shape[-1]) for c in chunks])
            self.stats[k] = {
                "mean": flat.mean(0).astype(np.float32),
                "std": (flat.std(0) + 1e-6).astype(np.float32),
            }
        with open(self.stats_path, "wb") as f:
            pickle.dump(self.stats, f)
        return self.stats

    def normalize(self, key: str, x: np.ndarray) -> np.ndarray:
        s = self.stats.get(key)
        if s is None:
            return x
        return (x - s["mean"]) / s["std"]

    @staticmethod
    def remove_failed_trajectories(data_dir: str, min_len: int = 10) -> int:
        """data.py:145 parity: drop trajectories that ended in failure/too short."""
        removed = 0
        for path in list_trajectory_files(data_dir):
            try:
                with open_traj(path) as d:
                    ok = int(d["done_idx"]) >= min_len
                    if "success" in d:
                        ok = ok and bool(np.asarray(d["success"]).any())
            except Exception:
                ok = False
            if not ok:
                os.remove(path)
                removed += 1
        return removed


class TrajectoryDataset:
    """Sub-sequence sampler over npz trajectories (data.py:273-460)."""

    def __init__(self, data_dir: str, seq_len: int = 1,
                 keys=("student_obs", "actions", "latent"),
                 normalizer: DataNormalizer | None = None,
                 files: list[str] | None = None,
                 tactile_diff: bool = False):
        self.files = files if files is not None else list_trajectory_files(data_dir)
        if not self.files:
            raise FileNotFoundError(f"no trajectories in {data_dir}")
        self.seq_len = seq_len
        self.keys = keys
        self.normalizer = normalizer
        # tactile frames differenced against the trajectory's frame 1
        # (reference _load_and_preprocess_tactile, data.py:337-347)
        self.tactile_diff = tactile_diff
        self._trajs = []
        self._index: list[tuple[int, int]] = []
        for fi, path in enumerate(self.files):
            with open_traj(path) as d:
                traj = {k: np.asarray(d[k]) for k in keys if k in d}
                done_idx = (int(np.asarray(d["done_idx"]).reshape(-1)[0])
                            if "done_idx" in d
                            else len(next(iter(traj.values()))) - 1)
            if tactile_diff and "tactile" in traj:
                ref = traj["tactile"][min(1, len(traj["tactile"]) - 1)]
                traj["tactile"] = (traj["tactile"].astype(np.float32)
                                   - ref.astype(np.float32))
            self._trajs.append(traj)
            for t in range(max(done_idx - seq_len + 1, 1)):  # stride 1 (data.py:318-329)
                self._index.append((fi, t))

    def __len__(self):
        return len(self._index)

    def batches(self, batch_size: int, rng: np.random.Generator, epochs: int = 1):
        for _ in range(epochs):
            order = rng.permutation(len(self._index))
            for s in range(0, len(order) - batch_size + 1, batch_size):
                idxs = order[s:s + batch_size]
                out: dict[str, list] = {k: [] for k in self.keys}
                for j in idxs:
                    fi, t = self._index[j]
                    traj = self._trajs[fi]
                    for k in self.keys:
                        if k not in traj:
                            continue
                        seq = traj[k][t:t + self.seq_len]
                        if self.normalizer is not None:
                            seq = self.normalizer.normalize(k, seq)
                        out[k].append(seq)
                yield {k: np.stack(v) for k, v in out.items() if v}
