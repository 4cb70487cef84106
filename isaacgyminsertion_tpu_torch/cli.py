"""Command line (`key=value` overrides): the reference's train.py for the
teacher's and the student's training and evals.

    python -m isaacgyminsertion_tpu_torch.cli train.algo=PPO test=False num_envs=4096 \
        train.ppo.horizon_length=64 train.ppo.mini_epochs=8 output=outputs/teacher

trains a teacher with PPO (`max_epochs=`, `seed=`, `eval_freq_steps=`;
`checkpoint=` restores one before training; `train.ppo.*` and `ppo.*` set
the PPO config), writing `last.ckpt`, `best_*.ckpt`, `config.json` and
`metrics.jsonl` into `output`;

    python -m isaacgyminsertion_tpu_torch.cli train.algo=PPO test=True \
        checkpoint=checkpoints/teacher_r2b/best_success num_envs=1024

evaluates a teacher, and

    python -m isaacgyminsertion_tpu_torch.cli train.algo=ExtrinsicAdapt test=True \
        checkpoint=<teacher ckpt> student_checkpoint=<student ckpt> task.env.numEnvs=256 \
        task.external_cam.external_cam=True task.external_cam.seg_cam=True \
        task.external_cam.pcl_cam=True train.ppo.pcl_info=True train.ppo.obs_info=True \
        train.ppo.only_bc=True

a student on the sensors-on env (`noise_study=True` adds the point-cloud
noise sweep, `output=<dir>` is where it writes). Both evals print
`Success Rate: x` and run `num_envs` envs (`eval_envs=` sets it separately).

    python -m isaacgyminsertion_tpu_torch.cli train.algo=ExtrinsicAdapt test=False \
        checkpoint=checkpoints/teacher_r2b/best_success task.env.numEnvs=256 \
        task.external_cam.external_cam=True task.external_cam.seg_cam=True \
        task.external_cam.pcl_cam=True train.ppo.obs_info=True train.ppo.pcl_info=True \
        train.ppo.only_bc=True dagger.replay_size=400000 output=outputs/student

trains a student by DAgger from the teacher `checkpoint=` (scripts/train_s2.sh;
`dagger.*` sets the DAgger config, `max_epochs=` defaults to 1000,
`student_checkpoint=` restores a student first, `phase3=True` trains only its
decoder and latent head; its evals run `eval_envs=` or min(num_envs, 64)
envs), writing `last.ckpt`, `best_success.ckpt`, `config.json` and
`metrics.jsonl` into `output`.

    python -m isaacgyminsertion_tpu_torch.cli collect_rotate=True task.env.numEnvs=32 \
        output=outputs/tactile_rot

spins each env's grasped plug in hand for 60 frames and writes their tactile
images and plug poses to `{output}_rotate.npz` (scripts/collect_rotate.sh).
`grasp_dataset=<npz>` makes PPO training reset from a grasp dataset
(`envs/grasp_gen.py`; unless `task.grasp_at_init=True`), and
`gan_checkpoint=<ckpt>` (or `task.tactile.model_G=`) puts a CycleGAN
generator (`algo/gan_runner.py`) on the tactile frames of DAgger training's
rollout. Everything runs on CUDA unless `device=cpu` is given.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

from . import resolve_device
from .algo.ext_adapt import DAggerConfig
from .algo.ppo import PPOConfig
from .envs.config import default_task_config

# reference yaml name → dataclass path in TaskConfig (None: the env count)
_KEYMAP = {
    "task.env.numEnvs": None,
    "num_envs": None,
    "task.rl.max_episode_length": "rl.max_episode_length",
    "task.env.tactile": "env.tactile",
    "task.env.render_capacity": "env.render_capacity",
    "task.external_cam.external_cam": "env.external_cam",
    "task.external_cam.depth_cam": "env.depth_cam",
    "task.external_cam.seg_cam": "env.seg_cam",
    "task.external_cam.pcl_cam": "env.pcl_cam",
    "task.env.compute_contact_gt": "env.compute_contact_gt",
    "task.randomize.domain_randomize": "randomize.domain_randomize",
    "task.grasp_at_init": "grasp_at_init",
    "task.reset_at_success": "reset_at_success",
    "task.reset_at_fails": "reset_at_fails",
    "task.rand_inits": "rand_inits",
    "task.ctrl.ctrl_type": "ctrl_type",
    "ctrl_type": "ctrl_type",
    "task.env.numObservations": "env.num_observations",
    "task.env.numObsStudent": "env.num_obs_student",
    "task.env.numStates": "env.num_states",
    "task.env.numActions": "env.num_actions",
    "task.env.numObsHist": "env.num_obs_hist",
    "task.env.numObsStudentHist": "env.num_obs_stud_hist",
    "task.env.img_history_len": "env.img_history_len",
    "task.env.tactile_history_len": "env.tactile_history_len",
    "task.env.ft_history_len": "env.ft_history_len",
    "task.env.smooth_force": "env.smooth_force",
    "task.env.action_latency_max": "env.action_latency_max",
    "task.env.actionLatencyMax": "env.action_latency_cur_max",
    "task.env.actionLatencyScheduledSteps": "env.action_latency_scheduled_steps",
    "task.env.actionDelayProbMax": "env.action_delay_prob_max",
    "task.env.actionsMovingAverage.range": "env.actions_moving_average_range",
    "task.env.actionsMovingAverage.schedule_steps": "env.actions_moving_average_schedule_steps",
    "task.env.actionsMovingAverage.schedule_freq": "env.actions_moving_average_schedule_freq",
    "task.env.plugObsDelayProb": "env.plug_obs_delay_prob",
    "task.env.ImgDelayProb": "env.img_delay_prob",
    "task.env.PclProbNoise": "env.pcl_prob_noise",
    "task.env.SegDelayProb": "env.seg_delay_prob",
    "task.env.SegProbNoise": "env.seg_prob_noise",
    "task.env.TactileDelayProb": "env.tactile_delay_prob",
    "task.env.scalePosProb": "env.scale_pos_prob",
    "task.env.scaleRotProb": "env.scale_rot_prob",
    "task.env.maxObjectSkipObs": "env.max_object_skip_obs",
    "task.env.maxSkipImg": "env.max_skip_img",
    "task.env.maxSkipTactile": "env.max_skip_tactile",
    "task.env.actionEma": "env.action_ema",
    "task.randomize.randomization_params.frequency": "randomize.frequency",
    "task.randomize.randomization_params.observations.range": "randomize.observations.range",
    "task.randomize.randomization_params.observations.range_correlated":
        "randomize.observations.range_correlated",
    "task.randomize.randomization_params.observations.schedule": "randomize.observations.schedule",
    "task.randomize.randomization_params.observations.schedule_steps":
        "randomize.observations.schedule_steps",
    "task.randomize.randomization_params.actions.range": "randomize.actions.range",
    "task.randomize.randomization_params.actions.range_correlated":
        "randomize.actions.range_correlated",
    "task.randomize.randomization_params.actions.schedule": "randomize.actions.schedule",
    "task.randomize.randomization_params.actions.schedule_steps":
        "randomize.actions.schedule_steps",
    "task.randomize.randomization_params.sim_params.gravity.range": "randomize.gravity.range",
    "task.randomize.clearance_curriculum_extra": "randomize.clearance_curriculum_extra",
    "task.randomize.clearance_curriculum_steps": "randomize.clearance_curriculum_steps",
    "task.sim.disable_gravity": "sim.disable_gravity",
    "task.sim.dt": "sim.dt",
    "task.sim.substeps": "sim.substeps",
}


# reference yaml name → field of PPOConfig
_PPO_KEYMAP = {
    "train.ppo.horizon_length": "horizon",
    "train.ppo.mini_epochs": "mini_epochs",
    "train.ppo.learning_rate": "learning_rate",
    "train.ppo.gamma": "gamma",
    "train.ppo.tau": "tau",
    "train.ppo.e_clip": "e_clip",
    "train.ppo.critic_coef": "critic_coef",
    "train.ppo.entropy_coef": "entropy_coef",
    "train.ppo.bounds_loss_coef": "bounds_loss_coef",
    "train.ppo.grad_norm": "grad_norm",
    "train.ppo.kl_threshold": "kl_threshold",
    "train.ppo.lr_schedule": "lr_schedule",
    "train.ppo.anneal_ladder": "anneal_ladder",
    "train.ppo.anneal_decay": "anneal_decay",
    "train.ppo.anneal_patience": "anneal_patience",
    "train.ppo.anneal_min_lr": "anneal_min_lr",
    "train.ppo.anneal_margin": "anneal_margin",
    "train.ppo.anchor_coef": "anchor_coef",
    "train.ppo.value_bootstrap": "value_bootstrap",
    "train.ppo.bootstrap_mask_success": "bootstrap_mask_success",
    "train.ppo.critic_warmup_steps": "critic_warmup_steps",
    "train.ppo.normalize_input": "normalize_input",
    "train.ppo.normalize_value": "normalize_value",
    "train.ppo.normalize_advantage": "normalize_advantage",
    "train.ppo.clip_value": "clip_value",
    "train.ppo.max_agent_steps": "max_agent_steps",
}


# reference yaml name → field of DAggerConfig (None: accepted for recipe
# compatibility, no effect)
_DAGGER_KEYMAP = {
    "train.ppo.tactile_info": "use_tactile",
    "train.ppo.img_info": "use_img",
    "train.ppo.seg_info": "use_seg",
    "train.ppo.pcl_info": "use_pcl",
    "train.ppo.obs_info": "use_obs",
    "train.ppo.only_bc": "only_bc",
    "offline_train.only_bc": "only_bc",
    "offline_train.from_offline": None,
    "train.ppo.use_priv": "use_priv",
    "train.ppo.latent_loss_coef": "latent_loss_coef",
    "train.ppo.action_z_weight": "action_z_weight",
}


def _parse_value(v: str) -> Any:
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("null", "none"):
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.startswith("[") and v.endswith("]"):
        return tuple(_parse_value(x.strip()) for x in v[1:-1].split(",") if x.strip())
    return v


def _set_path(obj, path: str, value):
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(obj, **{head: _set_path(getattr(obj, head), rest, value)})


def parse_args(argv: list[str] | None = None) -> dict:
    """Returns {task, ppo, dagger, algo, num_envs, eval_envs, test, checkpoint,
    student_checkpoint, noise_study, output, seed, device, max_epochs,
    eval_freq_steps, grasp_dataset, phase3, gan_checkpoint, collect_rotate}.
    `seed` is None unless given: training then seeds with 42 and the evals
    with 1234, as the reference does."""
    argv = sys.argv[1:] if argv is None else argv
    out = dict(task=default_task_config(), ppo=PPOConfig(), dagger=DAggerConfig(), algo="PPO",
               num_envs=128, eval_envs=None, test=False, checkpoint="", student_checkpoint="",
               noise_study=False, output="outputs/run", seed=None, device=None, max_epochs=None,
               eval_freq_steps=10.0e6, grasp_dataset="", phase3=False, gan_checkpoint="",
               collect_rotate=False)
    truncate_grads = None
    for arg in argv:
        if "=" not in arg:
            continue
        k, v = arg.split("=", 1)
        val = _parse_value(v)
        if k in ("train.algo", "algo"):
            out["algo"] = val
        elif k == "test":
            out["test"] = bool(val)
        elif k in ("checkpoint", "train.load_path"):
            out["checkpoint"] = str(val)
        elif k == "seed":
            out["seed"] = int(val)
        elif k == "eval_envs":
            out["eval_envs"] = int(val)
        elif k == "device":
            out["device"] = str(val)
        elif k == "student_checkpoint":
            out["student_checkpoint"] = str(val)
        elif k == "noise_study":
            out["noise_study"] = bool(val)
        elif k in ("output", "train.ppo.output_name"):
            out["output"] = str(val)
        elif k == "max_epochs":
            out["max_epochs"] = int(val)
        elif k == "eval_freq_steps":
            out["eval_freq_steps"] = float(val)
        elif k in ("grasp_dataset", "task.grasp_dataset"):
            out["grasp_dataset"] = str(val)
        elif k in ("collect_rotate", "task.collect_rotate"):
            out["collect_rotate"] = bool(val)
        elif k in ("phase3", "train.phase3"):
            out["phase3"] = bool(val)
        elif k in ("gan_checkpoint", "task.tactile.model_G"):
            out["gan_checkpoint"] = str(val)
        elif k == "train.ppo.truncate_grads":
            # the reference's boolean: True keeps the grad_norm clip, False
            # turns clipping off. Applied after every override, so that a
            # later train.ppo.grad_norm=X does not depend on the order.
            if not isinstance(val, bool):
                raise SystemExit("train.ppo.truncate_grads expects true/false")
            truncate_grads = val
        elif k in _PPO_KEYMAP:
            out["ppo"] = _set_path(out["ppo"], _PPO_KEYMAP[k], val)
        elif k.startswith("ppo."):
            out["ppo"] = _set_path(out["ppo"], k[len("ppo."):], val)
        elif k in _DAGGER_KEYMAP:
            if _DAGGER_KEYMAP[k] is not None:
                out["dagger"] = _set_path(out["dagger"], _DAGGER_KEYMAP[k], val)
        elif k.startswith("dagger."):
            out["dagger"] = _set_path(out["dagger"], k[len("dagger."):], val)
        elif k == "task":
            pass  # single task family; accepted for recipe compatibility
        elif k in _KEYMAP:
            path = _KEYMAP[k]
            if path is None:
                out["num_envs"] = int(val)
            else:
                out["task"] = _set_path(out["task"], path, val)
        elif k.startswith("task."):
            out["task"] = _set_path(out["task"], k[len("task."):], val)
        else:
            raise SystemExit(f"unknown override: {k}")
    if truncate_grads is False:
        out["ppo"] = _set_path(out["ppo"], "grad_norm", float("inf"))
    return out


def main(argv: list[str] | None = None):
    """Train a teacher or a student (returns the `PPOTrainer` or the
    `DAggerTrainer`), run the teacher or the student eval (returns the
    success rate), or collect rotating-plug tactile frames (returns their
    number)."""
    args = parse_args(argv)
    if args["algo"] not in ("PPO", "ExtrinsicAdapt"):
        raise SystemExit(f"unknown algo {args['algo']!r}")
    from .algo.trainer import DAggerTrainer, PPOTrainer, StudentEvaluator, TeacherEvaluator
    from .assets import build_subassembly_set
    from .physics.robot import build_kuka_openhand

    model, subs = build_kuka_openhand(), build_subassembly_set()
    if args["collect_rotate"]:
        from .algo.collect import collect_rotating_plug

        n = collect_rotating_plug(args["task"], model, subs, n_envs=args["num_envs"],
                                  out_path=f"{args['output']}_rotate.npz", device=args["device"])
        print(f"collected {n} rotating-plug tactile frames")
        return n
    if args["algo"] == "PPO" and not args["test"]:
        device = resolve_device(args["device"])
        grasp_data = None
        if args["grasp_dataset"] and not args["task"].grasp_at_init:
            # grasp_at_init=True builds the grasp at reset and ignores the dataset
            from .envs.grasp_gen import load_grasp_data

            grasp_data = load_grasp_data(args["grasp_dataset"], n_sub=len(subs.names), model=model)
        trainer = PPOTrainer(args["task"], args["ppo"], model, subs, args["num_envs"], args["output"],
                             seed=42 if args["seed"] is None else args["seed"],
                             eval_envs=args["eval_envs"], eval_freq_steps=args["eval_freq_steps"],
                             device=device, grasp_data=grasp_data)
        if args["checkpoint"]:
            trainer.restore(args["checkpoint"])
        trainer.train(max_epochs=args["max_epochs"])
        return trainer
    if args["algo"] == "ExtrinsicAdapt" and not args["test"]:
        if not args["checkpoint"]:
            raise SystemExit("ExtrinsicAdapt training needs checkpoint=<teacher ckpt>")
        trainer = DAggerTrainer(args["task"], args["dagger"], model, subs, args["num_envs"], args["output"],
                                teacher_ckpt_path=args["checkpoint"],
                                seed=42 if args["seed"] is None else args["seed"], phase3=args["phase3"],
                                student_ckpt_path=args["student_checkpoint"],
                                gan_ckpt_path=args["gan_checkpoint"],
                                eval_envs=args["eval_envs"], eval_freq_steps=args["eval_freq_steps"],
                                device=args["device"])
        trainer.train(max_epochs=args["max_epochs"] or 1000)
        return trainer
    if not args["checkpoint"]:
        raise SystemExit("test=True needs checkpoint=<teacher ckpt>")
    seed = 1234 if args["seed"] is None else args["seed"]
    n_envs = args["eval_envs"] or args["num_envs"]
    if args["algo"] == "PPO":
        runner = TeacherEvaluator(args["task"], model, subs, n_envs, args["checkpoint"],
                                  device=args["device"])
        return runner.test(seed=seed)
    if not args["student_checkpoint"]:
        raise SystemExit("ExtrinsicAdapt test=True needs student_checkpoint=<student ckpt>")
    runner = StudentEvaluator(args["task"], args["dagger"], model, subs, n_envs, args["checkpoint"],
                              args["student_checkpoint"], out_dir=args["output"],
                              device=args["device"])
    sr = runner.test(seed=seed)
    if args["noise_study"]:
        runner.test_log()
    return sr


if __name__ == "__main__":
    main()
