"""Headless teacher-data collection and offline student training (the
reference's train_supervised.py; port of the repo's root
`train_supervised.py`, with the same `key=value` arguments and defaults).

    python -m isaacgyminsertion_tpu_torch.train_supervised collect=True \
        checkpoint=checkpoints/teacher_r2b/best_success data_dir=outputs/traj \
        num_envs=256 total_trajectories=768 depth_cam=True seg_cam=True pcl_cam=True

rolls the frozen teacher and writes one `.itraj` per trajectory and
`manifest.json` into `data_dir` (`tactile=` adds the tactile frames);

    python -m isaacgyminsertion_tpu_torch.train_supervised data_dir=outputs/traj \
        output=outputs/offline epochs=60 only_bc=True pcl_info=True \
        teacher_checkpoint=checkpoints/teacher_r2b/best_success \
        offline_training_w_env=True num_envs=256

trains the offline student (`obs_info= tactile_info= img_info= seg_info=
pcl_info= only_bc= batch_size= learning_rate=`; `restore=<ckpt>` starts
from a student checkpoint, `epochs=0` trains nothing) and, with
`offline_training_w_env=True`, replays it in the live env and prints
`Replay Success Rate: x`. Everything runs on CUDA unless `device=cpu` is
given.
"""

from __future__ import annotations

import dataclasses
import sys

from . import resolve_device


def main(argv=None):
    """Collect (→ the collection's stats: count, writer, seconds, bytes) or
    train and replay (→ the `OfflineRunner`)."""
    kv = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = resolve_device(kv.get("device"))
    data_dir = kv.get("data_dir", "outputs/trajectories")
    out = kv.get("output", "outputs/offline")
    flag = lambda k, default="False": kv.get(k, default).lower() == "true"

    from .envs.config import default_task_config

    if flag("collect"):
        from .algo.collect import collect_teacher_rollouts
        from .assets import build_subassembly_set
        from .models.actor_critic import actor_critic_from_jax_params
        from .physics.robot import build_kuka_openhand
        from .utils.checkpoint import restore_path

        cfg = default_task_config()
        # sensor modalities recorded into the trajectories (side arrays)
        cfg = cfg.replace(env=dataclasses.replace(
            cfg.env,
            tactile=flag("tactile"),
            external_cam=flag("depth_cam") or flag("seg_cam") or flag("pcl_cam"),
            depth_cam=flag("depth_cam"), seg_cam=flag("seg_cam"),
            pcl_cam=flag("pcl_cam"),
        ))
        tree = restore_path(kv["checkpoint"])
        stats: dict = {}
        n = collect_teacher_rollouts(
            cfg, build_kuka_openhand(), build_subassembly_set(),
            actor_critic_from_jax_params(tree["params"], device), tree["obs_rms"], tree["priv_rms"],
            n_envs=int(kv.get("num_envs", 16)), out_dir=data_dir,
            total_trajectories=int(kv.get("total_trajectories", 100)), device=device, stats=stats,
        )
        print(f"collected {n} trajectories → {data_dir}")
        return dict(count=n, **stats)

    from .algo.offline_runner import OfflineConfig, OfflineRunner

    cfg = OfflineConfig(
        epochs=int(kv.get("epochs", 10)),
        batch_size=int(kv.get("batch_size", 256)),
        only_bc=flag("only_bc"),
        use_obs=flag("obs_info", "True"),
        use_tactile=flag("tactile_info"),
        use_img=flag("img_info"),
        use_seg=flag("seg_info"),
        use_pcl=flag("pcl_info"),
        learning_rate=float(kv.get("learning_rate", 1e-4)),
    )
    runner = OfflineRunner(cfg, data_dir, out, teacher_ckpt=kv.get("teacher_checkpoint", ""),
                           device=device)
    if kv.get("restore"):
        runner.restore(kv["restore"])
    if cfg.epochs > 0:
        metrics = runner.run()
        print("offline training done:", metrics)
    if flag("offline_training_w_env"):
        # reference train.py:124-128: validate the offline student by
        # replaying it against the live env (first-episode success)
        task = default_task_config()
        task = task.replace(env=dataclasses.replace(
            task.env,
            tactile=cfg.use_tactile,
            external_cam=cfg.use_img or cfg.use_seg or cfg.use_pcl,
            depth_cam=cfg.use_img, seg_cam=cfg.use_seg or cfg.use_pcl,
            pcl_cam=cfg.use_pcl,
        ))
        runner.replay_eval(task, n_envs=int(kv.get("num_envs", 64)),
                           teacher_ckpt=kv.get("teacher_checkpoint", ""))
    return runner


if __name__ == "__main__":
    main()
