"""PBT sweep launcher (reference pbt/launcher/run_processes.py parity).

    python -m isaacgyminsertion_tpu_torch.pbt.run

Port of `scripts/run_pbt.py`, on the same environment variables.
Single host: the in-process population (`pbt/driver.py`). Multi-host: run it
on each host with POLICY_OFFSET / LOCAL_POLICIES, sharing WORKSPACE.

  RESTORE          teacher checkpoint every member starts from; also turns
                   on the fail resets (the fine-tune task)
  LR_SPREAD        comma-separated per-member initial learning rates
  EVAL_OBJECTIVE   1 = the objective is a full-episode eval at EVAL_ENVS envs
  MUTABLE          comma list of mutable hparams (learning_rate only when
                   RESTORE is set, else learning_rate,e_clip,grad_norm)
  NUM_ENVS, POLICIES, HORIZON, EPOCHS_PER_INTERVAL, INTERVALS,
  INTERVAL_STEPS, START_AFTER, INITIAL_DELAY, POLICY_OFFSET, WORKSPACE
  DEVICE           cuda (default) or cpu

At the end the global best (`best.pbt`) is exported as
`WORKSPACE/best_success.ckpt` in the `Checkpointer` layout, which the teacher
eval CLI runs (`checkpoint=WORKSPACE/best_success`).
"""

from __future__ import annotations

import os

from .. import resolve_device
from ..algo.ppo import PPOConfig
from ..assets import build_subassembly_set
from ..envs.config import default_task_config
from ..physics.robot import build_kuka_openhand
from ..utils.checkpoint import Checkpointer
from .driver import run_pbt_population
from .pbt import PbtParams, _load_member


def main(env=None):
    """Run the sweep on `env` (default: os.environ) → the members."""
    env = os.environ if env is None else env
    device = resolve_device(env.get("DEVICE") or None)
    cfg_task = default_task_config()
    model = build_kuka_openhand()
    subs = build_subassembly_set()
    restore = env.get("RESTORE") or None
    lr_spread = [float(x) for x in env["LR_SPREAD"].split(",")] if env.get("LR_SPREAD") else None
    mutable = tuple(env.get("MUTABLE", "learning_rate" if restore else "learning_rate,e_clip,grad_norm")
                    .split(","))
    ppo_cfg = PPOConfig(horizon=int(env.get("HORIZON", 64)))
    if restore:
        # fine-tune population: train on the full task (fail resets on), like
        # the r2b phase-B recipe the checkpoint came from
        cfg_task = cfg_task.replace(reset_at_fails=True)

    eval_fn = None
    if env.get("EVAL_OBJECTIVE", "0") == "1":
        from ..algo.trainer import eval_task_config, make_eval_fn

        eval_cfg, eval_envs = eval_task_config(cfg_task), int(env.get("EVAL_ENVS", 256))

        def eval_fn(net, obs_rms, priv_rms, seed):
            return make_eval_fn(eval_cfg, model, subs, net, eval_envs, device=device)(obs_rms, priv_rms, seed)

    workspace = env.get("WORKSPACE", "outputs/pbt")
    members = run_pbt_population(
        cfg_task, ppo_cfg, model, subs,
        n_envs=int(env.get("NUM_ENVS", 512)),
        pbt_params=PbtParams(num_policies=int(env.get("POLICIES", 4)), workspace=workspace,
                             interval_steps=float(env.get("INTERVAL_STEPS", 1e7)),
                             start_after_steps=float(env.get("START_AFTER", 1e7)),
                             initial_delay_steps=float(env.get("INITIAL_DELAY", 2e7))),
        epochs_per_interval=int(env.get("EPOCHS_PER_INTERVAL", 20)),
        intervals=int(env.get("INTERVALS", 50)),
        policy_offset=int(env.get("POLICY_OFFSET", 0)),
        local_policies=int(env["LOCAL_POLICIES"]) if "LOCAL_POLICIES" in env else None,
        restore=restore,
        lr_spread=lr_spread,
        eval_fn=eval_fn,
        mutable_hparams=mutable,
        device=device,
    )
    print("final objectives:", [m["objective"] for m in members])

    best_path = os.path.join(workspace, "best.pbt")
    if os.path.exists(best_path):
        best = _load_member(best_path)
        Checkpointer(workspace).save("best_success", best.weights)
        print(f"pbt global best: policy {best.policy_idx} objective {best.true_objective:.4f} -> "
              f"{os.path.join(workspace, 'best_success.ckpt')}")
    return members


if __name__ == "__main__":
    main()
