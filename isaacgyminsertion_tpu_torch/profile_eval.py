"""Where the time of the teacher eval, the student eval or PPO training goes
on the card.

    python -m isaacgyminsertion_tpu_torch.profile_eval [--envs 1024] [--steps 20]
    python -m isaacgyminsertion_tpu_torch.profile_eval --student r5|r3 [--envs 256]
    python -m isaacgyminsertion_tpu_torch.profile_eval --train [--envs 8192] [--steps 10]
    python -m isaacgyminsertion_tpu_torch.profile_eval --dagger [--envs 256] [--steps 10]

Runs the banked r2b teacher's eval loop (policy + env step) at `--envs`
envs on CUDA, or with `--student` the eval loop of a banked student on the
sensors-on env (r5: obs + point cloud; r3: tactile + seg + point cloud), and
prints, as one JSON line:
  - ms per control step (host clock around synchronized steps);
  - a host-clock split of one control step: priv + policy, the env step,
    and inside one physics substep the pre-solve work (FK, dynamics, contact
    generation), the contact solve, and the rest;
  - with `--student`: the sensor step alone (rendering, queues, point cloud)
    and its share of the env step, and each renderer's launch count per step;
  - from torch.profiler over `--steps` steps: device-busy ms per step (sum of
    CUDA kernel times), the device's idle share, kernel launches per step,
    and the kernels with the most device time.
With `--train` it runs PPO teacher training from a fresh network with the
hyperparameters of scripts/train_s1.sh (horizon 64, 8 mini-epochs): one
epoch to warm up, then one epoch phase by phase, and prints host ms per
rollout control step (policy sampling + env step), host ms of each update
phase of that epoch (bootstrap value + GAE, normalizer updates, batch,
the mini-epochs of Adam steps), and from torch.profiler the device-busy ms,
idle share and kernel launches of `--steps` rollout steps and of one update
phase.
With `--dagger` it runs DAgger student training with the recipe of
scripts/retrain_student_r5.sh (train_s2.sh's obs + point-cloud student,
the stratified K = 400k reservoir) from the r2b teacher: one epoch to warm
up, then one epoch phase by phase, and prints host ms per rollout control
step (teacher + student forward + env step), the normalizer, reservoir
scatter and update ms of that epoch and ms per Adam step, and from
torch.profiler the device-busy ms, idle share and kernel launches of
`--steps` rollout steps and of one update phase.
The card's name and power limit come first, as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

from . import resolve_device
from .assets import build_subassembly_set
from .envs import insertion
from .envs.config import default_task_config
from .models.actor_critic import actor_critic_from_jax_params
from .models.running_mean_std import rms_normalize, rms_to
from .physics import engine
from .algo import ext_adapt as ea
from .algo import ppo
from .algo.trainer import StudentEvaluator
from .physics import solver_kernel as sk
from .physics.kinematics import forward_kinematics, site_pose
from .physics.robot import SITE_FINGERTIP_CENTERED, build_kuka_openhand
from .utils import profiling
from .utils.checkpoint import restore_path

CKPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
CKPT = os.path.join(CKPTS, "teacher_r2b", "best_success")
# the banked students: the env's sensor flags and the student's modality flags
STUDENTS = {
    "r5": (dict(external_cam=True, seg_cam=True, pcl_cam=True),
           dict(use_obs=True, use_pcl=True, only_bc=True)),
    "r3": (dict(tactile=True, external_cam=True, seg_cam=True, pcl_cam=True),
           dict(use_obs=True, use_tactile=True, use_seg=True, use_pcl=True, only_bc=False)),
}


def _timed(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=None, help="default 1024, or 256 with --student")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--student", choices=sorted(STUDENTS), default=None)
    ap.add_argument("--train", action="store_true", help="PPO teacher training (train_s1.sh)")
    ap.add_argument("--dagger", action="store_true",
                    help="DAgger student training (retrain_student_r5.sh)")
    args = ap.parse_args(argv)
    if args.envs is None:
        args.envs = 8192 if args.train else 256 if (args.student or args.dagger) else 1024
    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if args.train:
        return train_main(args, dev)
    if args.dagger:
        return dagger_main(args, dev)

    cfg = default_task_config()
    model, subs = build_kuka_openhand(), build_subassembly_set()
    gen = insertion.make_generator(0, dev)
    if args.student:
        env_flags, da_flags = STUDENTS[args.student]
        cfg = cfg.replace(env=dataclasses.replace(cfg.env, **env_flags))
        da_cfg = ea.DAggerConfig(**da_flags)
        runner = StudentEvaluator(cfg, da_cfg, model, subs, args.envs, CKPT,
                                  os.path.join(CKPTS, f"student_{args.student}", "best_success"),
                                  device=dev)
        student_act = ea.make_student_act(cfg, da_cfg, runner.teacher)

        def act(s):
            return student_act(runner.student, s.obs_stud_queue, ea._prev_out_of(s, cfg))[0]
    else:
        tree = restore_path(CKPT)
        net = actor_critic_from_jax_params(tree["params"], dev)
        o_rms, p_rms = rms_to(tree["obs_rms"], dev), rms_to(tree["priv_rms"], dev)

        def act(s):
            priv = insertion.priv_info_of(cfg, model, s)
            mu = net(rms_normalize(o_rms, s.obs_queue), rms_normalize(p_rms, priv))[0]
            return torch.clamp(mu, -1.0, 1.0)

    with torch.no_grad():
        t_reset, state = _timed(lambda: insertion.reset_all(cfg, model, subs, gen, args.envs), 1)

        def control_step():
            nonlocal state
            state, _ = insertion.step(cfg, model, subs, state, act(state), gen)

        for _ in range(3):
            control_step()
        t_step, _ = _timed(control_step, args.steps)
        t_act, a = _timed(lambda: act(state), args.steps)
        t_env, _ = _timed(lambda: insertion.step(cfg, model, subs, state, a, gen), args.steps)

        h = cfg.sim.dt / cfg.sim.substeps
        ctrl = engine.ControlInput(q_target=state.phys.q, tau_cmd=torch.zeros_like(state.phys.q),
                                   torque_mode_mask=torch.zeros((15,), device=dev),
                                   plug_wrench=torch.zeros((args.envs, 6), device=dev))
        t_sub, _ = _timed(lambda: engine.substep(model, state.params, state.phys, ctrl, h),
                          args.steps)
        t_prep, prob = _timed(lambda: engine.contact_problem(model, state.params, state.phys,
                                                             ctrl, h), args.steps)
        t_solve, _ = _timed(lambda: sk.solve_contacts_fused(*prob, h), args.steps)
        sensors = None
        if args.student:
            fk2 = forward_kinematics(model, state.phys.q)
            ftc_t2 = site_pose(model, fk2, SITE_FINGERTIP_CENTERED)[1]
            counts = profiling.launches()
            t_sens, _ = _timed(lambda: insertion._sensor_step(
                cfg, model, subs, state, state.phys, fk2, ftc_t2, state.frame + 1, state.progress + 1,
                state.finger_forces_ema, gen), args.steps)
            after = profiling.launches()
            sensors = {"sensor_step_ms": t_sens, "share_of_env_step": t_sens / t_env,
                       "tactile_launches_per_step": (after["tactile_render"] - counts["tactile_render"]) / args.steps,
                       "camera_launches_per_step": (after["camera_render"] - counts["camera_render"]) / args.steps}

        prof = _profile(control_step, args.steps)

    print(json.dumps({
        "path": f"student_{args.student}" if args.student else "teacher_r2b",
        "envs": args.envs, "steps": args.steps, "reset_ms": t_reset, "step_ms": t_step,
        "env_steps_per_s": args.envs / t_step * 1e3,
        "split_ms": {"priv_and_policy": t_act, "env_step": t_env, "substep": t_sub,
                     "substep_pre_solve": t_prep, "contact_solve": t_solve},
        "sensors": sensors,
        "profiled_step_ms": prof["wall_ms"], "device_busy_ms_per_step": prof["busy_ms"],
        "device_idle_share": prof["idle_share"], "kernel_launches_per_step": prof["launches"],
        "top_kernels_ms_per_step": prof["top_kernels_ms"],
    }), flush=True)


def _profile(fn, reps: int) -> dict:
    """fn run `reps` times under torch.profiler → per call: host wall ms,
    device-busy ms (sum of CUDA kernel times), idle share, kernel launches,
    and the kernels with the most device time."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # device kernels only: not the host ops above them, and not user annotations
    # (`Optimizer.step#Adam.step`), whose device-side span would count its kernels twice
    kernels = [e for e in events if dev_us(e) > 0 and not e.key.startswith(("cuda", "aten::"))
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                          "cudaLaunchKernelExC"))
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "launches": launches / reps,
            "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 / reps for e in top}}


def train_main(args, dev):
    """`--train`: where an epoch of PPO teacher training goes."""
    cfg = default_task_config()
    model, subs = build_kuka_openhand(), build_subassembly_set()
    c = ppo.PPOConfig(horizon=64, mini_epochs=8)       # scripts/train_s1.sh
    t_build, (_, _, state, te) = _timed(lambda: ppo.build(cfg, c, model, subs, args.envs, 0,
                                                          device=dev), 1)
    t_warm, (state, _) = _timed(lambda: te(state), 1)
    # one epoch, phase by phase, each closed by a synchronize
    t_roll, (env_state, traj, _) = _timed(lambda: te.rollout(state), 1)
    t_adv, (advs, returns) = _timed(lambda: te.advantages(state, env_state, traj), 1)
    t_rms, (obs_rms, priv_rms, value_rms) = _timed(lambda: te.normalizers(state, traj, returns), 1)
    t_batch, (batch, _) = _timed(lambda: te.batch(traj, advs, returns, value_rms), 1)
    t_upd, _ = _timed(lambda: te.update(state, obs_rms, priv_rms, batch), 1)
    n_mb = c.mini_epochs * c.mini_epochs    # mini_epochs passes of B // (B // mini_epochs) minibatches
    epoch_ms = t_roll + t_adv + t_rms + t_batch + t_upd

    def control_step():
        nonlocal env_state
        env_state, _, _ = te.rollout_step(state, env_state)

    roll = _profile(control_step, args.steps)
    upd = _profile(lambda: te.update(state, obs_rms, priv_rms, batch), 1)
    print(json.dumps({
        "path": "teacher_training", "envs": args.envs, "horizon": c.horizon,
        "mini_epochs": c.mini_epochs, "minibatch_rows": batch["obs"].shape[0] // c.mini_epochs,
        "build_and_reset_ms": t_build, "first_epoch_ms": t_warm, "epoch_ms": epoch_ms,
        "env_steps_per_s": c.horizon * args.envs / epoch_ms * 1e3,
        "host_ms": {"control_step": t_roll / c.horizon, "rollout": t_roll,
                    "advantages": t_adv, "normalizers": t_rms, "batch": t_batch, "update": t_upd,
                    "adam_step": t_upd / n_mb},
        "rollout_profile": {"steps": args.steps, "profiled_step_ms": roll["wall_ms"],
                            "device_busy_ms_per_step": roll["busy_ms"],
                            "device_idle_share": roll["idle_share"],
                            "kernel_launches_per_step": roll["launches"],
                            "top_kernels_ms_per_step": roll["top_kernels_ms"]},
        "update_profile": {"profiled_ms": upd["wall_ms"], "device_busy_ms": upd["busy_ms"],
                           "device_idle_share": upd["idle_share"], "kernel_launches": upd["launches"],
                           "top_kernels_ms": upd["top_kernels_ms"]},
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }), flush=True)



def dagger_main(args, dev):
    """`--dagger`: where an epoch of DAgger student training goes."""
    cfg = default_task_config()
    env_flags, da_flags = STUDENTS["r5"]
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, render_capacity=0.75, **env_flags),
                      reset_at_success=True, reset_at_fails=True, rand_inits=True)   # train_s2.sh
    da = ea.DAggerConfig(replay_size=400_000, replay_stratify=True, beta_anneal_steps=6e6, **da_flags)
    model, subs = build_kuka_openhand(), build_subassembly_set()
    tree = restore_path(CKPT)
    teacher = ea.TeacherBundle(net=actor_critic_from_jax_params(tree["params"], dev).requires_grad_(False),
                               obs_rms=rms_to(tree["obs_rms"], dev), priv_rms=rms_to(tree["priv_rms"], dev))
    t_build, (state, te) = _timed(lambda: ea.build(cfg, da, model, subs, args.envs, teacher, 0, device=dev), 1)
    t_warm, (state, _) = _timed(lambda: te(state), 1)
    # one epoch; the host time of each phase is what the epoch itself records
    epoch_ms, (state, m) = _timed(lambda: te(state), 1)
    host_ms = {p: m[f"time/{p}_s"] * 1e3 for p in ("rollout", "normalizers", "scatter", "update")}
    n_rows = da.horizon * args.envs
    mb_size, n_mb = te.minibatch_shape(n_rows)
    n_steps = da.mini_epochs * n_mb
    env_state, steps = state.env_state, state.agent_steps
    student = ea.StudentBundle(state.net, state.stud_obs_rms, state.pcl_rms)
    update = lambda: te.update(student, state.optimizer, te.reservoir.rows, n_rows, state.train_gen)

    def control_step():
        nonlocal env_state
        env_state, _, _, _ = te.rollout_step(state, env_state, steps)

    roll = _profile(control_step, args.steps)
    upd = _profile(update, 1)
    res = te.reservoir
    print(json.dumps({
        "path": "student_training", "envs": args.envs, "horizon": da.horizon,
        "mini_epochs": da.mini_epochs, "minibatch_rows": mb_size, "adam_steps": n_steps,
        "reservoir": {"capacity": da.replay_size, "stratified": da.replay_stratify,
                      "gb": sum(v.numel() * v.element_size() for v in res.rows.values()) / 1e9,
                      "fill_a": res.fill_a, "fill_b": res.fill_b},
        "build_and_reset_ms": t_build, "first_epoch_ms": t_warm, "epoch_ms": epoch_ms,
        "env_steps_per_s": da.horizon * args.envs / epoch_ms * 1e3,
        "host_ms": {"control_step": host_ms["rollout"] / da.horizon, **host_ms,
                    "adam_step": host_ms["update"] / n_steps},
        "rollout_profile": {"steps": args.steps, "profiled_step_ms": roll["wall_ms"],
                            "device_busy_ms_per_step": roll["busy_ms"],
                            "device_idle_share": roll["idle_share"],
                            "kernel_launches_per_step": roll["launches"],
                            "top_kernels_ms_per_step": roll["top_kernels_ms"]},
        "update_profile": {"profiled_ms": upd["wall_ms"], "device_busy_ms": upd["busy_ms"],
                           "device_idle_share": upd["idle_share"], "kernel_launches": upd["launches"],
                           "top_kernels_ms": upd["top_kernels_ms"]},
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }), flush=True)


if __name__ == "__main__":
    main()
