"""In-process PBT population driver over the PPO epoch.

Port of `isaacgyminsertion_tpu/pbt/driver.py`. One host drives the whole
population round-robin: each member has its own network, Adam optimizer, env
batch and `TrainEpoch` on the device, and exchanges `PbtMember` checkpoints
through the filesystem workspace (`pbt.py`), so process-per-policy launches
on other hosts still interoperate through the same directory.

As in the reference:
  - `restore`: every member starts from a banked teacher checkpoint (either
    package's);
  - `lr_spread`: per-member initial learning rates;
  - a mutation of the learning rate only is written into the optimizer's
    `param_groups` and keeps the Adam moments (the reference's
    inject_hyperparams slot); any other mutation (`e_clip`, `grad_norm`,
    `mini_epochs`) builds a new epoch and starts the Adam moments afresh (the
    reference's `tx.init`);
  - `eval_fn(net, obs_rms, priv_rms, seed)`: an optional full-episode
    evaluation as the objective (e.g. `trainer.make_eval_fn` on `net`), seeded
    1000 · interval + member; else the in-training success when it is above 0,
    the in-training reward otherwise;
  - one JSONL line in `pbt_log.jsonl` for each member and interval.
Each member's epochs also land in its `history` (env-steps/s, reward,
success, parameter norm) and on one printed line each.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..algo import ppo as ppo_mod
from ..models.actor_critic import convert_jax_params, to_jax_params
from ..models.running_mean_std import rms_to, rms_to_numpy
from .pbt import PbtMember, PbtParams, pbt_update

MUTABLE_HPARAMS = ("learning_rate", "e_clip", "grad_norm")


def member_weights(state: ppo_mod.PPOState) -> dict:
    """A member's weights as numpy, in the `Checkpointer` layout."""
    return {"params": to_jax_params(state.net.state_dict()), "obs_rms": rms_to_numpy(state.obs_rms),
            "priv_rms": rms_to_numpy(state.priv_rms), "value_rms": rms_to_numpy(state.value_rms)}


def load_weights(state: ppo_mod.PPOState, weights: dict) -> ppo_mod.PPOState:
    """Params (in place) and normalizers from a weights tree of either package."""
    dev = state.obs_rms.mean.device
    state.net.load_state_dict(convert_jax_params(weights["params"]))
    return state._replace(obs_rms=rms_to(weights["obs_rms"], dev), priv_rms=rms_to(weights["priv_rms"], dev),
                          value_rms=rms_to(weights["value_rms"], dev))


def _param_norm(net) -> float:
    return float(torch.sqrt(sum(torch.sum(p.detach() ** 2) for p in net.parameters())))


def run_pbt_population(
    cfg_task,
    base_ppo_cfg: ppo_mod.PPOConfig,
    model,
    subs,
    n_envs: int,
    pbt_params: PbtParams,
    epochs_per_interval: int = 4,
    intervals: int = 4,
    seed: int = 0,
    policy_offset: int = 0,
    local_policies: int | None = None,
    restore: str | None = None,
    lr_spread: list[float] | None = None,
    eval_fn=None,
    mutable_hparams: tuple = MUTABLE_HPARAMS,
    device=None,
):
    """Round-robin PBT over the local member slice; returns the members.

    Multi-host partitioning (reference run_slurm.py/run_processes.py parity):
    `pbt_params.num_policies` is the TOTAL population; this process trains
    `local_policies` members with global indices policy_offset..+local-1 and
    exchanges checkpoints with the rest through the shared workspace.
    """
    dev = resolve_device(device)
    num = local_policies if local_policies is not None else pbt_params.num_policies
    # the reference forces its inject_hyperparams optimizer this way; the
    # ladder itself lives in PPOTrainer and is not active here
    base_ppo_cfg = base_ppo_cfg.replace(anneal_ladder=True)
    restored = None
    if restore:
        from ..utils.checkpoint import restore_path

        restored = restore_path(restore)
    os.makedirs(pbt_params.workspace, exist_ok=True)
    log_path = os.path.join(pbt_params.workspace, "pbt_log.jsonl")

    members = []
    for i in range(num):
        hp = {k: getattr(base_ppo_cfg, k) for k in mutable_hparams}
        if lr_spread:
            hp["learning_rate"] = float(lr_spread[i % len(lr_spread)])
        cfg = base_ppo_cfg.replace(**hp)
        _, _, state, train_epoch = ppo_mod.build(cfg_task, cfg, model, subs, n_envs,
                                                 seed + policy_offset + i, device=dev)
        if restored is not None:
            state = load_weights(state, restored)
        members.append(dict(hparams=hp, cfg=cfg, state=state, train_epoch=train_epoch, objective=0.0,
                            steps_since_restart=0.0, iteration=0, history=[]))

    def rebuild(m, new_hp):
        """Apply mutated hparams: the learning rate into the optimizer (Adam
        moments kept); anything else through a new epoch and optimizer."""
        old_hp = m["hparams"]
        non_lr_changed = any(k != "learning_rate" and new_hp[k] != old_hp.get(k) for k in new_hp)
        m["hparams"] = new_hp
        if not non_lr_changed:
            m["cfg"] = m["cfg"].replace(learning_rate=new_hp["learning_rate"])
            ppo_mod.set_lr(m["state"].optimizer, new_hp["learning_rate"])
            return
        cfg = base_ppo_cfg.replace(**new_hp)
        m["cfg"] = cfg
        m["train_epoch"] = ppo_mod.TrainEpoch(cfg_task, cfg, model, subs)
        m["state"] = m["state"]._replace(
            optimizer=ppo_mod.make_optimizer(m["state"].net.parameters(), new_hp["learning_rate"]))

    for interval in range(intervals):
        for idx, m in enumerate(members):
            t0 = time.perf_counter()
            rewards, succ = [], []
            gidx = policy_offset + idx
            for e in range(epochs_per_interval):
                t_epoch = time.perf_counter()
                m["state"], metrics = m["train_epoch"](m["state"])
                fps = m["cfg"].horizon * n_envs / (time.perf_counter() - t_epoch)
                rewards.append(metrics["episode/reward"])
                succ.append(metrics["episode/success"])
                row = {"interval": interval, "epoch": e, "env_steps_per_s": fps,
                       "reward": metrics["episode/reward"], "success": metrics["episode/success"],
                       "loss": metrics["loss"], "param_norm": _param_norm(m["state"].net)}
                m["history"].append(row)
                print(f"[pbt] interval {interval} policy {gidx} epoch {e}: {fps:.1f} env-steps/s, "
                      f"reward {row['reward']:.4f}, success {row['success']:.4f}, loss {row['loss']:.5f}, "
                      f"param norm {row['param_norm']:.4f}", flush=True)
            m["steps_since_restart"] += epochs_per_interval * m["cfg"].horizon * n_envs
            m["iteration"] += 1
            if eval_fn is not None:
                m["objective"] = float(eval_fn(m["state"].net, m["state"].obs_rms, m["state"].priv_rms,
                                               1000 * interval + idx))
            else:
                m["objective"] = (float(np.mean(succ)) if np.mean(succ) > 0
                                  else float(np.mean(rewards)))

            p = dataclasses.replace(pbt_params, policy_idx=gidx)
            me = PbtMember(policy_idx=gidx, iteration=m["iteration"], true_objective=m["objective"],
                           hparams=m["hparams"], weights=member_weights(m["state"]))
            new_hp, new_weights, replaced = pbt_update(p, me, m["steps_since_restart"],
                                                       float(m["state"].agent_steps))
            with open(log_path, "a") as f:
                f.write(json.dumps({
                    "interval": interval, "policy": gidx,
                    "objective": m["objective"], "hparams": m["hparams"],
                    "replaced": bool(replaced),
                    "agent_steps": float(m["state"].agent_steps),
                    "train_success_mean": float(np.mean(succ)),
                    "secs": round(time.perf_counter() - t0, 1),
                }) + "\n")
            if replaced and new_weights is not None:
                m["state"] = load_weights(m["state"], new_weights)
                m["steps_since_restart"] = 0.0
            if new_hp != m["hparams"]:
                rebuild(m, new_hp)
            print(f"[pbt] interval {interval} policy {gidx} "
                  f"obj={m['objective']:.4f} hp={m['hparams']} "
                  f"replaced={replaced}", flush=True)
    return members
