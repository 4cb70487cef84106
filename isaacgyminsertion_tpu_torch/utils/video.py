"""Rollout video / FT-trace capture (parity: factory_env_insertion.py:1211-1265
record_video/record_ft + frozen_ppo.py:791-851 mp4 logging).

Port of `isaacgyminsertion_tpu/utils/video.py`. Captures depth-camera frames
during an evaluation rollout of one env (`capture_eval_rollout`) and writes
them as a gif/mp4 via imageio, plus matplotlib action / fingertip-force trace
plots (`write_eval_video`; `record_eval_video` does both): the observability
surface the reference attaches to its TensorBoard runs. imageio and
matplotlib are imported only when a file is written.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def frames_to_video(frames: np.ndarray, path: str, fps: int = 30):
    """frames: [T, H, W] float depth/gray or [T, H, W, 3] rgb in [0, 1]."""
    import imageio

    f = np.asarray(frames)
    if f.ndim == 3:
        f = np.stack([f] * 3, axis=-1)
    f = (np.clip(f, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gif"):
        imageio.mimsave(path, list(f), fps=fps)
    else:
        imageio.mimwrite(path, list(f), fps=fps)
    return path


def plot_traces(traces: dict[str, np.ndarray], path: str, title: str = ""):
    """Action / fingertip-force trace plot (record_ft parity)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(traces), 1, figsize=(8, 2.2 * len(traces)), squeeze=False)
    for ax, (name, arr) in zip(axes[:, 0], traces.items()):
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        for i in range(arr.shape[1]):
            ax.plot(arr[:, i], lw=0.8)
        ax.set_ylabel(name)
        ax.grid(alpha=0.3)
    if title:
        axes[0, 0].set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def video_task_config(cfg_task):
    """The rollout's config: the depth and seg cameras on."""
    return cfg_task.replace(env=dataclasses.replace(
        cfg_task.env, external_cam=True, depth_cam=True, seg_cam=True))


@torch.no_grad()
def capture_eval_rollout(cfg_task, model, subs, act_fn, n_steps: int = 120, seed: int = 0, device=None):
    """Run one env with the depth and seg cameras on for `n_steps`, the
    actions from `act_fn(env_state)` ([1, 6]) → (depth frames [T, H, W] in
    [0, 1] (the env's `-out.img[0, 0]`: depth is negative-normalized),
    actions [T, 6], `finger_forces_ema` [T, 3]) as host arrays."""
    from .. import resolve_device
    from ..envs import insertion

    dev = resolve_device(device)
    cfg = video_task_config(cfg_task)
    gen = insertion.make_generator(seed, dev)
    state = insertion.reset_all(cfg, model, subs, gen, 1)
    frames, actions, forces = [], [], []
    for _ in range(n_steps):
        a = act_fn(state)
        state, out = insertion.step(cfg, model, subs, state, a, gen)
        frames.append(-out.img[0, 0])
        actions.append(a[0])
        forces.append(state.finger_forces_ema[0])
    return tuple(torch.stack(x).cpu().numpy() for x in (frames, actions, forces))


def write_eval_video(frames, actions, forces, out_dir: str):
    """Encode a captured rollout as `rollout.gif` and `traces.png` in
    `out_dir` → their paths."""
    return [
        frames_to_video(frames, os.path.join(out_dir, "rollout.gif")),
        plot_traces({"actions": actions, "finger_forces": forces}, os.path.join(out_dir, "traces.png")),
    ]


def record_eval_video(cfg_task, model, subs, act_fn, n_steps: int = 120, out_dir: str = "videos",
                      seed: int = 0, device=None):
    """Capture a one-env rollout, then encode it (`write_eval_video`) → the
    paths of `rollout.gif` and `traces.png` in `out_dir`."""
    frames, actions, forces = capture_eval_rollout(cfg_task, model, subs, act_fn, n_steps, seed, device)
    return write_eval_video(frames, actions, forces, out_dir)
