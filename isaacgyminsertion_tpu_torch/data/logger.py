"""Trajectory data logger → compressed trajectory files.

Parity: algo/ppo/experience.py `DataLoggerSim`/`SimLogger` (experience.py:
352-489, 634-755): per-env [T, ·] buffers; when an env finishes, its
trajectory ships to background writer threads that store one compressed file
per trajectory (keys: eef/socket/plug poses in the robot frame, obs
histories, actions, latents, done index, physics params; sensor frames in
side arrays). The logger only sees host copies of whole rollout chunks, so
logging never stalls the device's step stream.

Port of `isaacgyminsertion_tpu/data/logger.py`: the same files for the same
chunks. `DataLoggerSim` writes `.itraj` through the port's native writer and
falls back to the numpy `.npz` writer where that cannot be built, as the
reference does; unlike the reference it prints which writer it took, and
why, so a fallback cannot pass unnoticed (`writer_name`, `writer_note`).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any

import numpy as np

from .. import native


class TrajectoryWriter:
    """Background npz writer pool (reference uses 8 mp workers,
    experience.py:352-489; threads suffice since np.savez_compressed releases
    the GIL in zlib)."""

    def __init__(self, out_dir: str, num_workers: int = 4):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.q: queue.Queue = queue.Queue(maxsize=256)
        self.workers = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(num_workers)
        ]
        self.count = 0
        self._lock = threading.Lock()
        for w in self.workers:
            w.start()

    def _worker(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            path, data = item
            try:
                np.savez_compressed(path, **data)
            finally:
                self.q.task_done()

    def submit(self, data: dict[str, np.ndarray]):
        with self._lock:
            idx = self.count
            self.count += 1
        path = os.path.join(self.out_dir, f"traj_{idx:06d}.npz")
        self.q.put((path, data))

    def close(self):
        self.q.join()
        for _ in self.workers:
            self.q.put(None)
        for w in self.workers:
            w.join(timeout=5)


class DataLoggerSim:
    """Accumulates per-env buffers across rollout chunks and emits finished
    trajectories to the writer (graceful-shutdown parity experience.py:388-395)."""

    LOGGED_KEYS = (
        "obs", "student_obs", "priv_info", "actions", "rewards",
        "plug_pos", "plug_quat", "socket_pos", "socket_quat", "eef_pos",
        "eef_quat", "latent", "done",
    )

    def __init__(self, out_dir: str, num_envs: int, max_len: int = 512,
                 total_trajectories: int = 20000, use_native: bool = True):
        self.writer = None
        self.writer_note = "use_native=False"
        if use_native:
            try:
                self.writer = native.NativeTrajectoryWriter(out_dir)
                self.writer_note = native.LIB_PATH
            except Exception as e:
                self.writer_note = f"native writer unavailable: {e}"
        if self.writer is None:
            self.writer = TrajectoryWriter(out_dir)
        self.writer_name = "numpy .npz" if isinstance(self.writer, TrajectoryWriter) else "native .itraj"
        print(f"DataLoggerSim: writer {self.writer_name} ({self.writer_note})", flush=True)
        self.num_envs = num_envs
        self.max_len = max_len
        self.total_trajectories = total_trajectories
        self.buffers: dict[str, list] = {i: [] for i in range(num_envs)}

    @property
    def done(self) -> bool:
        return self.writer.count >= self.total_trajectories

    def add_chunk(self, chunk: dict[str, np.ndarray]):
        """chunk: key → [T, N, ...] host arrays incl. 'done' [T, N] bools."""
        T = chunk["done"].shape[0]
        for t in range(T):
            step = {k: v[t] for k, v in chunk.items()}
            for i in range(self.num_envs):
                self.buffers[i].append({k: v[i] for k, v in step.items()})
                if step["done"][i] or len(self.buffers[i]) >= self.max_len:
                    self._flush_env(i)

    def _flush_env(self, i: int):
        traj = self.buffers[i]
        self.buffers[i] = []
        if len(traj) < 2 or self.done:
            return
        data = {k: np.stack([s[k] for s in traj]) for k in traj[0]}
        data["done_idx"] = np.asarray(len(traj) - 1)
        self.writer.submit(data)

    def close(self):
        self.writer.close()


class DataLoggerReal:
    """Hardware-rollout logger (parity: DataLoggerReal/RealLogger,
    experience.py:492-866): single-stream step accumulation from the deploy
    loop, same npz trajectory schema as DataLoggerSim so offline training
    consumes sim and real recordings interchangeably. Feed it from
    HardwarePlayer.deploy via `logger.add_step(...)`."""

    def __init__(self, out_dir: str, max_len: int = 1024):
        self.writer = TrajectoryWriter(out_dir)
        self.max_len = max_len
        self.buffer: list[dict[str, np.ndarray]] = []

    def add_step(self, obs: dict[str, Any], action: np.ndarray,
                 done: bool = False, **extra):
        step = {k: np.asarray(v) for k, v in obs.items() if np.asarray(v).size}
        step["actions"] = np.asarray(action)
        step["done"] = np.asarray(done)
        for k, v in extra.items():
            step[k] = np.asarray(v)
        self.buffer.append(step)
        if done or len(self.buffer) >= self.max_len:
            self.flush()

    def flush(self):
        import warnings

        traj, self.buffer = self.buffer, []
        if len(traj) < 2:
            if traj:
                warnings.warn(
                    f"DataLoggerReal: discarding {len(traj)}-step trajectory "
                    "(< 2 steps)", stacklevel=2)
            return
        keys = set(traj[0]).intersection(*[set(s) for s in traj])
        dropped = set().union(*[set(s) for s in traj]) - keys
        if dropped:
            # a modality missing on any single step drops it for the whole
            # trajectory — make hardware recording gaps visible
            warnings.warn(
                f"DataLoggerReal: keys {sorted(dropped)} missing on some steps; "
                "dropped from the whole trajectory", stacklevel=2)
        data = {k: np.stack([s[k] for s in traj]) for k in keys}
        data["done_idx"] = np.asarray(len(traj) - 1)
        self.writer.submit(data)

    def close(self):
        self.flush()
        self.writer.close()
