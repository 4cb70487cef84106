"""Teacher rollout data collection → trajectory datasets, and the
rotating-plug tactile collection.

Port of `isaacgyminsertion_tpu/algo/collect.py` (scripts/collect_s1.sh +
the reference's data_logger block): roll the frozen teacher in the env in
chunks of `chunk` control steps and log per-env trajectories (obs,
student_obs, priv, actions, teacher latent, poses, done) for offline
student training. A chunk's records are stacked on the device and reach the
host in one copy; the logger consumes them at chunk boundaries only.

Within a step, `obs`, `student_obs`, `priv_info` and `eef_pos/quat` (FK of
the pre-step joint state) are read before `insertion.step`; `plug_pos/quat`
and `socket_pos/quat` after it; `rewards`, `done` and `success` are its
output. The sensor side arrays are the newest queue slot: `tactile` and
`img` float16, `seg` int8, `pcl` float16.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import list_trajectory_files
from ..data.logger import DataLoggerSim
from ..envs import insertion
from ..models.running_mean_std import rms_normalize, rms_to
from ..physics.kinematics import forward_kinematics, site_pose
from ..physics.robot import SITE_FINGERTIP_CENTERED

# the side arrays of a sensors-on collection: (env flag, StepOutput field, dtype)
SIDE_ARRAYS = (("tactile", "tactile", torch.float16), ("depth_cam", "img", torch.float16),
               ("seg_cam", "seg", torch.int8), ("pcl_cam", "pcl", torch.float16))


def host_copy(recs: dict) -> dict:
    """{name: device tensor} → {name: numpy array} through ONE device → host
    copy: every tensor's bytes packed into one buffer on the device."""
    names = list(recs)
    flat = [recs[k].contiguous().reshape(-1).view(torch.uint8) for k in names]
    host = torch.cat(flat).cpu().numpy()
    out, ofs = {}, 0
    for k, f in zip(names, flat):
        t = recs[k]
        dt = np.dtype(str(t.dtype).replace("torch.", "")) if t.dtype != torch.bool else np.dtype(bool)
        out[k] = host[ofs:ofs + f.numel()].view(dt).reshape(tuple(t.shape))
        ofs += f.numel()
    return out


def collect_teacher_rollouts(
    cfg_task, model, subs, net, obs_rms, priv_rms, n_envs: int, out_dir: str,
    total_trajectories: int = 100, chunk: int = 32, seed: int = 0, deterministic: bool = True,
    device=None, stats: dict | None = None,
):
    """Roll the teacher `net` (an `ActorCriticSplit` on the device, with its
    normalizers) until the logger has written `total_trajectories`
    trajectories into `out_dir`, then write `manifest.json` → the count
    written. `stats`, where given, receives the seconds of the rollout, the
    host copies and the logger (each chunk's `add_chunk`, and the final
    drain), the steps, the writer, the files and bytes
    written, and the records' schema ({name: (dtype, per-step shape)})."""
    dev = resolve_device(device)
    obs_rms, priv_rms = rms_to(obs_rms, dev), rms_to(priv_rms, dev)
    env_gen = insertion.make_generator(seed, dev)
    act_gen = insertion.make_generator(int(seed) + 1, dev)
    e = cfg_task.env
    side = [(field, dtype) for flag, field, dtype in SIDE_ARRAYS if getattr(e, flag)]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t = dict(rollout_s=0.0, host_copy_s=0.0, logger_s=0.0, logger_chunk_s=[], steps=0)

    def chunk_fn(env_state):
        recs = []
        for _ in range(chunk):
            obs = env_state.obs_queue
            priv = insertion.priv_info_of(cfg_task, model, env_state)
            mu, log_std, _, latent, _ = net(rms_normalize(obs_rms, obs), rms_normalize(priv_rms, priv))
            if deterministic:
                act = mu
            else:
                act = mu + torch.exp(log_std) * torch.randn(mu.shape, generator=act_gen, device=dev)
            act = torch.clamp(act, -1.0, 1.0)
            eef_q, eef_t = site_pose(model, forward_kinematics(model, env_state.phys.q),
                                     SITE_FINGERTIP_CENTERED)
            rec = dict(obs=obs, student_obs=env_state.obs_stud_queue, priv_info=priv, actions=act,
                       latent=latent, eef_pos=eef_t, eef_quat=eef_q)
            env_state, out = insertion.step(cfg_task, model, subs, env_state, act, env_gen)
            rec.update(rewards=out.rew, done=out.reset, success=out.extras["successes"],
                       plug_pos=env_state.phys.plug_pos, plug_quat=env_state.phys.plug_quat,
                       socket_pos=env_state.params.socket_pos, socket_quat=env_state.params.socket_quat)
            for field, dtype in side:
                rec[field] = getattr(out, field)[:, 0].to(dtype)
            recs.append(rec)
        return env_state, {k: torch.stack([r[k] for r in recs]) for k in recs[0]}

    with torch.no_grad():
        env_state = insertion.reset_all(cfg_task, model, subs, env_gen, n_envs)
        logger = DataLoggerSim(out_dir, n_envs, total_trajectories=total_trajectories)
        while not logger.done:
            t0 = time.perf_counter()
            env_state, recs = chunk_fn(env_state)
            sync()
            t1 = time.perf_counter()
            host = host_copy(recs)
            t2 = time.perf_counter()
            t.setdefault("schema", {k: (str(v.dtype), v.shape[2:]) for k, v in host.items()})
            logger.add_chunk(host)
            t["logger_chunk_s"].append(time.perf_counter() - t2)
            t["logger_s"] += t["logger_chunk_s"][-1]
            t["rollout_s"] += t1 - t0
            t["host_copy_s"] += t2 - t1
            t["steps"] += chunk
        t0 = time.perf_counter()
        logger.close()
        # the drain: waiting on the writer's threads (compression and file writes)
        t["logger_drain_s"] = time.perf_counter() - t0
        t["logger_s"] += t["logger_drain_s"]
    # manifest: the generation is deterministic in (seed, n_envs, config), so
    # a lost dataset is exactly reproducible from this record
    files = [os.path.basename(f) for f in list_trajectory_files(out_dir)]
    manifest = dict(
        seed=seed, n_envs=n_envs, deterministic=deterministic, chunk=chunk,
        total_trajectories=total_trajectories, count=logger.writer.count,
        modalities=dict(tactile=e.tactile, depth=e.depth_cam, seg=e.seg_cam, pcl=e.pcl_cam),
        files=files,
    )
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if stats is not None:
        t.update(writer=logger.writer_name, files=len(files),
                 bytes=sum(os.path.getsize(os.path.join(out_dir, f)) for f in files))
        stats.update(t)
    return logger.writer.count


def collect_rotating_plug(cfg_task, model, subs, n_envs: int, out_path: str, n_steps: int = 60,
                          rot_per_step: float = 0.05, seed: int = 0, device=None):
    """Plug-rotation tactile data collection (the reference's collect_rotate
    mode, `rotate_plug`): spin the grasped plug about its axis in-hand and
    save `tactile` [N, T, F, H, W, C], `plug_quat` [N, T, 4] and `plug_pos`
    [N, 3] to `out_path` (npz): the dataset behind the tactile pose regressor
    (`algo/tactile_runner.py`) → the number of frames. Frame t turns the
    plug by `rot_per_step · t` about the world z axis; the three gels are
    rendered at a pad force of 5.0."""
    from ..ops import rotations as rot
    from ..physics.engine import fingertip_poses
    from ..sensors.tactile import TactileConfig, render_tactile

    dev = resolve_device(device)
    cfg = cfg_task.replace(env=dataclasses.replace(cfg_task.env, tactile=True))
    tcfg = TactileConfig()
    tactile, quats = [], []
    with torch.no_grad():
        env_state = insertion.reset_all(cfg, model, subs, insertion.make_generator(seed, dev), n_envs)
        phys, params = env_state.phys, env_state.params
        tip_q, tip_t = fingertip_poses(model, forward_kinematics(model, phys.q))
        axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n_envs, 3)
        force = torch.full((n_envs, 3), 5.0, device=dev)
        for t in range(n_steps):   # one renderer launch a frame
            dq = rot.quat_from_angle_axis(torch.full((n_envs,), rot_per_step * t, device=dev), axis)
            plug_q = rot.quat_mul(dq, phys.plug_quat)
            tactile.append(render_tactile(tcfg, tip_q, tip_t, plug_q, phys.plug_pos, params.kind_onehot,
                                          params.plug_hx, params.plug_hy, params.plug_length, force=force))
            quats.append(plug_q)
    np.savez_compressed(out_path, tactile=torch.stack(tactile, 1).cpu().numpy(),
                        plug_quat=torch.stack(quats, 1).cpu().numpy(), plug_pos=phys.plug_pos.cpu().numpy())
    return n_steps * n_envs
