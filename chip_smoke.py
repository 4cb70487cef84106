#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # everything; the last line is {"ok": true, ...}
    python3 chip_smoke.py --kernels-only   # phases 1-3 and 7, no result line

Any failure exits nonzero without printing a result. Phases 1-3 and 7 run
first, in this process, alone on the card. The main paths (phases 4-6 and
8-18) then run as worker processes of this script (`--unit`), UNIT_SLOTS at
a time: UNITS groups them, a unit starts once the units whose files it reads
have ended, and each unit's output is printed when it ends. The phases:
  1. device and precision: CUDA present, card name and power limit, TF32 off;
  2. build every hand-written kernel from the sources in this checkout (one
     nvcc per source, all started together), with ptxas' register counts;
  3. each kernel against its plain PyTorch version on the card:
     - contact_solver at N = 1024 envs, C = 255 contacts: a random contact set
       and one captured from a real env substep (with the distribution of
       active contacts per env); a substep captured at N = 8192, the teacher
       training path's grid, and one at N = 256 on train_s2.sh's task, the
       student training path's; then edge cases at C = 255, 37 and 200: an
       env with no active contact, an env with every contact active, C not a
       multiple of 32; all at the reference's fused-vs-XLA solver tolerances;
       phase 17's grids: a substep at one rank's 4096 envs of the sharded
       training, and one at one rank's 256 envs of the sensors-on sharded
       epoch on the dry run's reduced config (4 iterations, h = 1/60 s);
     - tactile_render (R = 768 rows × 4096 pixels) and camera_render (N = 256
       envs × 5184 pixels), closed-form variant: inputs captured from a
       sensors-on env a few steps after reset, and one random set; the march
       variant at a small shape; the camera's exact kernel also on the scenes
       it branches on (every section family, the robot proxy in view and
       parked, tilted frames, P not a multiple of 4, a ray table off 16-byte
       alignment: capture.camera_edge_cases). Noise off: fails if any output is not
       finite or more than 0.5 % of the pixels differ by more than 1e-3
       (silhouette flips); component ids equal off those pixels. Noise on
       (both kinds): outputs finite and in [0, 1], residual against the
       noise-off image (lit pixels away from the clip) with mean within
       ±1e-3 of 0 and std within 5 % of 0.01;
     - contact_gen (one thread per env and contact slot, C = 255) on the
       substeps it gets on the main paths: every 40th substep of a 120-step
       rollout of the r2b teacher at N = 1024 envs, the first substeps after
       a reset at N = 8192 (the PPO training grid) and at N = 256 on
       train_s2.sh's task, and at N = 1 on the deploy grid below: every
       output within 1e-5 of the plain version's (autograd normals);
     - the deploy path's grid, from 1-env SimInterfaces three steps after
       reset: the solver and contact generation at N = 1, and on student_r3's flags the tactile
       renderer at R = 3 rows and the camera at N = 1, at the tolerances above;
     - the sharded sensors-on path's grid (phase 17 (c)): the rows each of two
       ranks of 256 envs owns of the global selection at render_capacity 0.75
       (render_selection over the gathered priorities, at a step where both
       counts are odd), both renderers on those rows of the sensors-on env,
       at the tolerances above;
  4. main path, teacher: the teacher eval CLI with the banked r2b teacher at
     1024 envs for one 500-step episode (3 solver and 3 contact generation
     launches per control step, as on every main path below; success in
     0.81-0.90, the card's 0.8545 since PR 4 +- 4 binomial sigma);
  5. main path A, student_r5: the student eval CLI with the arguments of
     scripts/eval_s2.sh (obs + point cloud, 6-dim action head) at 256 envs
     for one 500-step episode: 500 camera launches, 1,500 solver launches, no
     tactile launch; success in the 0.17-0.34 band of student_r5's seeds (the
     card's 0.2461 since PR 4; the JAX package measured 0.2539);
  6. main path B, student_r3 (tactile + seg + point cloud, latent injected
     into the frozen actor) at 256 envs: one tactile and one camera launch per
     control step, every image finite and in range, success in 0.01-0.11
     (the card's 0.0547 since PR 4 +- 4 binomial sigma); then 50 steps with
     render_capacity=0.75 to drive the gathered render-on-demand path;
  7. times: each kernel and its plain version on CUDA events, beside the
     least time the card could take (bytes or f32 operations at the published
     H100 SXM peaks; operations counted for what this run's data needs: the
     solver's active contacts, the half-planes and quadratic of each row's
     section family). The solver is timed at 1024, 256 (train_s2 task) and
     8192 envs on the captured contact sets and at 1024 and 256 on the
     random one; contact generation at 1024 (the rollout's last kept
     substep), 8192 and 256 envs, each bound counted from its launch's own
     inputs (its envs' section kinds and per-env floats), with the L2 cache
     flushed before each launch, as for the renderers on packed rows.
     Each time is the median of single launches, printed with their spread;
  8. main path, teacher training: the PPO training CLI with the
     hyperparameters of scripts/train_s1.sh (horizon 64, 8 mini-epochs) at
     8192 envs for 2 epochs from a fresh network (seed 0): exactly 384 solver
     launches (3 per control step) and no renderer launch, 1,048,576 agent
     steps, the losses, the KL and the parameter norm finite after each epoch;
     per epoch it prints env-steps/s, the rollout and update seconds, peak
     memory, the KL and the clip fraction. Its last.ckpt must load into the
     teacher eval CLI and run a 50-step eval at 256 envs to a finite success;
  9. main path, student training: the DAgger training CLI with the arguments
     of scripts/train_s2.sh as scripts/retrain_student_r5.sh passes them
     (obs + point cloud, 6-dim action head, render_capacity 0.75, the
     stratified K = 400k reservoir, β annealed over 6e6 steps), teacher r2b,
     256 envs for 2 epochs (seed 0), then its final eval at 64 envs, cut
     from 500 steps to 100: exactly 192 solver and 64 camera launches an
     epoch and 3 solver and 1 camera launch an eval step, no tactile
     launch, 32,768 agent
     steps, the reservoir's cursors and fills as Algorithm R counts them,
     the losses and parameters finite after each epoch; per epoch it prints
     env-steps/s, the rollout, normalizer, scatter and update seconds, peak
     memory and the action loss beside the JAX package's record. Its
     last.ckpt must load into the student eval CLI and run 50 steps at 256
     envs to a finite success. Then (9b) one epoch of the tactile variant
     (student_r3's modalities, latent injection) at 256 envs with a 50-step
     episode: 192 + 150 solver, 64 + 50 tactile and 64 + 50 camera launches
     for the epoch and its eval;
 10. main path, the data path (scripts/chip_offline_r5.sh at its grid): the
     teacher-data collection through `train_supervised collect=True` (r2b
     teacher, 256 envs, depth + seg + point cloud, seed 0, deterministic,
     chunks of 32, 256 trajectories: one ~500-step episode per env; the
     banked dataset has 768): exactly 3 solver and 1 camera launch per
     control step and no tactile launch; the writer, files/s and MB/s of the
     logger, each record's dtype and per-step shape against the JAX
     collect's schema and `inspect_trajectories`. Then one epoch of the
     offline recipe on it (obs + point cloud, only-BC, batch 256, lr 1e-4,
     the banked normalization.pkl): finite losses and a `last.ckpt` in the
     flax layout that loads back; the banked offline_r5 student's loss on
     the collection beside its held-out 0.0168 (fails above 0.05); and the
     banked student's replay at 256 envs through `offline_training_w_env`
     beside the banked 0.0039, with its launches (3 solver and 1 camera a
     step);
 10b. the tactile data path: `collect_rotate=True task.env.numEnvs=32`
     through the CLI (collect_rotate.sh's default, 60 frames): exactly 60
     tactile launches, images finite and in [0, 1]; each frame the kernel
     rendered in that run (R = 96 rows, the plug turned, pad force 5.0) held
     to tactile_render_plain on the inputs it was given, at phase 3's image
     tolerance (its error joins the kernels line's); then the tactile pose
     regressor fitted for 8 epochs on those frames against plug_pos ⊕
     plug_quat: its loss finite and its last epoch below its first;
 11. grasp resets (scripts/gen_grasp.sh at its defaults):
     `vec_env.make("FactoryTaskGraspTactile", num_envs=256).run(8 rounds)`:
     exactly 720 solver launches (8 × 30 settling steps × 3 substeps), no
     renderer launch, the reference's six keys and dtypes; the rows written,
     removed by the world-Euler filter and kept per subassembly. Then the PPO
     training CLI (train_s1.sh's hyperparameters) with grasp_dataset= at 8192
     envs for 1 epoch: exactly 192 solver launches, no renderer launch,
     finite losses and parameters; a reset from the table starts every env
     whose subassembly has rows from one of them (arm and hand-base dofs and
     socket position equal);
 12. CycleGAN sim→real: `CycleGANRunner` with the reference's config for 1
     epoch (cut from 5) on 10b's 1,920 × 3 kernel-rendered gel frames against
     a stand-in real domain (`stand_in_real`: the repo holds no real frames):
     losses finite, the cycle loss of the last 50 steps below the first 50's.
     Its last.ckpt through the DAgger training CLI (9b's run +
     gan_checkpoint=): 9b's launches, the generator called once in each of
     the epoch's 64 steps and in none of the eval's 50. Then the hook on the
     card: one env step at 256 envs with the generator against the same step
     whose renderer hands out the generator's translation (1e-5), and the
     generator's time on 768 frames;
 13. diffusion policy: `DiffusionRunner` with the reference's config for 1
     epoch (cut from 10) on phase 10's collection: the loss finite and its
     last 50 steps below its first 50; `predict` on 256 observations gives
     [256, 8, 6], finite, in [-1, 1]; the checkpoint loads back.
 14. sys-id (scripts/sys_id.sh's path): 20 steps of one env recorded with
     the r2b teacher's deterministic actions under the scales SYSID_TRUTH;
     the replay objective at those scales must be below a tenth of its value
     at all-ones; then `python -m isaacgyminsertion_tpu_torch.sysid`'s main
     with 12 TPE trials (its KDE branch runs): exactly (12 + 2) x 20 x 3 = 840
     solver launches, no renderer launch; the best scales beside the truth;
 15. PBT (scripts/run_pbt_r5.sh's population: r2b restored into 4 members,
     lr 1e-4 / 5e-5 / 2.5e-5 / 1.25e-5, 512 envs, horizon 64, fail resets;
     cut to 2 intervals of 1 epoch, START_AFTER = INITIAL_DELAY = 0, the
     in-training objective) through `pbt.run`'s main: exactly 1,536 solver
     launches, no renderer launch, 8 log lines with the reference's keys,
     finite parameters after every epoch, a best.pbt; its exported
     best_success.ckpt runs in the teacher eval CLI (256 envs, 50 steps: 150
     solver launches);
 16. deploy, all at one env: (a) HardwarePlayer (r2b) on a SimInterface for
     100 steps (3 solver launches a step), its trail logged by DataLoggerReal;
     (b) StudentHardwarePlayer (student_r3) on phase 6's flags, 30 steps (3
     solver, 1 tactile, 1 camera launch a step, every frame finite and in
     range); (c) (a)'s player over RemoteInterface <-> serve_hardware on
     loopback, 30 steps, the native codec asserted, its actions against (a)'s
     (printed, with the first differing step where they differ by more than
     1e-5) and against a local run fed the deltas as float32, as the wire
     carries them (printed: bitwise equal or not); (d) the diffusion player on phase 13's checkpoint and the position
     player on 10b's regressor (tactile flag: 1 tactile launch a step), 16
     steps each; (e) calibrate_deploy_scales against (a)'s trail, 6 trials x
     20 steps: exactly 360 solver launches, a finite best loss; (f) a
     CompositeEnv on a CUDA KinematicArm servoed 60 steps along +x, and
     SafetyLimits clamping a step into the workspace's wall;
 17. data parallelism and the utilities, as two units (the first holds two
     rank processes on the card and takes two of UNIT_SLOTS): (a)
     `parallel.dryrun`'s rank function on two gloo ranks sharing the card,
     2 x 4096 envs, train_s1.sh's hyperparameters, 1 epoch: exactly 192
     solver launches a rank and no renderer launch, 524,288 agent steps,
     finite losses, and the ranks' parameters, Adam moments and normalizers
     bitwise equal; its env-steps/s summed over the ranks is printed beside
     phase 8's; (c) on the same ranks the sensors-on epoch at 2 x 256 envs,
     render_capacity 0.75, 8 steps (1 substep, 4 solver iterations): each
     step the rows the ranks render sum to the global k, each rank's tactile
     and camera launches equal its steps with rows to render, every frame
     finite and in range; then the dry run's entry point (the reference's two
     epochs at 8 envs); (b) nccl at world size 1, 512 envs, 1 epoch: exactly
     192 solver launches. (d) PPOTrainer.record_video with the r2b teacher
     restored, 1 env x 150 steps: exactly 450 solver and 150 camera
     launches, 150 finite depth frames handed to the encoder for the
     trainer's videos/ directory, the GIF and PNG (where imageio and
     matplotlib are not installed the encoder keeps the arrays, writes no
     file, and the phase says so);
     (e) check_determinism of one env step at 1024 envs, the largest
     difference of that step in a worker thread against the main thread,
     and a profiling.trace of 3 control steps; (f) export_scene_usda of the
     1024-env state and PoseExtractor over 3 steps, RandomNetworkAdversary
     on 8192 x 6 actions; (g) EkiIiwaArm on a CUDA KinematicArm against a
     fake controller on loopback: 60 servo steps along +x, the reference's
     wire format, and each real driver's DriverUnavailable reason where its
     SDK is missing.
 18. the bench (`python -m isaacgyminsertion_tpu_torch.bench`'s modes): (a)
     `sensors` (tactile + depth/seg cameras, render_capacity 0.75) and (b)
     `pcl` (the same + the point cloud) at 8192 envs, horizon 64, each built
     by `bench.build_epoch` and run by `bench.measure` (its FLOP-counted
     warm-up, then one timed epoch): its timed launches exactly 3 x 64
     solver launches and, for each renderer, its steps with rendered rows
     (`render_rows`), both renderers launched, 3 x 64 solver launches in the
     warm-up too, 524,288 agent steps an epoch, finite rate, mfu, metrics and
     parameters, every sensor queue finite and in range; env-steps/s and peak
     memory printed; then, on (a)'s final state, both renderers against their
     plain versions on the bench's grid (the render_selection at 0.75 of 8192
     envs: 6,144 envs, 18,432 tactile rows) at phase 3's tolerances, the
     errors folded into the kernels line; (c) the bench's worker as
     `run_worker` spawns it, mode `state` at 1024 envs with its horizon cut
     from 64 to 16 (the FLOP-counted warm-up costs several epochs): its line
     carries every key, a finite rate and mfu, and exactly 3 x 16 x 3 solver
     launches in its timed epochs; (d) the package's `make` at 1024 envs and one env step on the card (3
     solver launches), and `entry()`'s forward on the card.
Phase 3 prints the random solver set's error beside the worst error relative
to |plain|, the largest |plain| and the share of SOLVER_TOL it uses: the set
drives some envs to huge impulses, where the absolute error is large.
Launch counts are zeroed just before each main path and read just after, in
the worker that runs it; the main process sums the workers' counts. The
line before the last is a JSON object listing every ported kernel with its
launches summed over the main paths; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "isaacgyminsertion_tpu_torch"
CHECKPOINT = os.path.join(ROOT, "checkpoints", "teacher_r2b", "best_success")
STUDENT_R5 = os.path.join(ROOT, "checkpoints", "student_r5", "best_success")
STUDENT_R3 = os.path.join(ROOT, "checkpoints", "student_r3", "best_success")
N_ENVS = 1024
STUDENT_ENVS = 256
R5_REFERENCE = 0.2539   # the JAX package's 256-env eval of student_r5 (trial std 0.02-0.034)
PATH_B_STEPS = 500
# the card's successes since PR 4 and the bands they must stay in: r2b 0.8545 at 1024 envs and
# student_r3 0.0547 at 256 envs, each +-4 binomial sigma (0.011, 0.014); student_r5 0.2461 in
# the 0.17-0.34 band of its seeds
R2B_BAND = (0.81, 0.90)
R5_BAND = (0.17, 0.34)
R3_BAND = (0.01, 0.11)
# contact generation: every output of the kernel within 1e-5 of the plain version's; the
# r2b rollout it is held on (N_ENVS envs) and the substeps kept of it
GEN_TOL = 1e-5
GEN_ROLLOUT_STEPS, GEN_EVERY = 120, 40
# scripts/train_s1.sh's PPO hyperparameters at 8192 envs, 2 epochs
TRAIN_ENVS = 8192
TRAIN_EPOCHS = 2
TRAIN_S1_ARGS = ["train.algo=PPO", "test=False", "train.ppo.horizon_length=64",
                 "train.ppo.mini_epochs=8"]
H = 1.0 / 180.0  # substep of dt = 1/60 with 3 substeps
# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the arguments of scripts/eval_s2.sh (student_r5's recipe)
EVAL_S2_ARGS = ["train.algo=ExtrinsicAdapt", "test=True", "task.external_cam.external_cam=True",
                "task.external_cam.seg_cam=True", "task.external_cam.pcl_cam=True",
                "train.ppo.pcl_info=True", "train.ppo.obs_info=True", "train.ppo.only_bc=True"]
# student_r3's recipe: tactile + seg + point cloud, latent injection
R3_ARGS = ["train.algo=ExtrinsicAdapt", "test=True", "task.env.tactile=True",
           "task.external_cam.external_cam=True", "task.external_cam.seg_cam=True",
           "task.external_cam.pcl_cam=True", "train.ppo.tactile_info=True", "train.ppo.seg_info=True",
           "train.ppo.pcl_info=True", "train.ppo.obs_info=True", "train.ppo.only_bc=False"]
# scripts/train_s2.sh as scripts/retrain_student_r5.sh passes it, with the two arguments
# student_r5's attempt 4 added; phase 9 appends its own depth, seed and eval settings
TRAIN_S2_ARGS = ["train.algo=ExtrinsicAdapt", "test=False", f"checkpoint={CHECKPOINT}",
                 "task.external_cam.external_cam=True", "task.external_cam.seg_cam=True",
                 "task.external_cam.pcl_cam=True", "train.ppo.obs_info=True", "train.ppo.pcl_info=True",
                 "train.ppo.only_bc=True", "task.reset_at_success=True", "task.reset_at_fails=True",
                 "task.rand_inits=True", "task.env.render_capacity=0.75", "dagger.replay_size=400000",
                 "dagger.replay_mode=device_split", "eval_freq_steps=2e6", "eval_envs=256",
                 "max_epochs=1500", "dagger.replay_stratify=True", "dagger.beta_anneal_steps=6e6"]
STUDENT_EPOCHS = 2
STUDENT_EVAL_STEPS = 100        # phase 9's final eval at 64 envs, cut from the recipe's 500 steps
R5_RECORD = (0.0700, 0.0208)   # action_loss of epochs 1 and 2, checkpoints/student_r5/metrics.jsonl
# scripts/chip_offline_r5.sh: the collection (collect_s1.sh's flags) and the offline recipe
OFFLINE_R5 = os.path.join(ROOT, "checkpoints", "offline_r5")
COLLECT_ENVS = 256
COLLECT_TRAJS = 256             # one episode per env; the banked dataset holds 768
COLLECT_ARGS = ["collect=True", f"checkpoint={CHECKPOINT}", f"num_envs={COLLECT_ENVS}",
                f"total_trajectories={COLLECT_TRAJS}", "depth_cam=True", "seg_cam=True", "pcl_cam=True"]
OFFLINE_ARGS = ["batch_size=256", "only_bc=True", "pcl_info=True", "learning_rate=1e-4",
                f"teacher_checkpoint={CHECKPOINT}"]
OFFLINE_R5_VAL = 0.0168         # the banked student's held-out val/loss plateau (metrics.jsonl)
OFFLINE_R5_REPLAY = 0.0039      # its replay success at 256 envs (replay_eval.txt)
# the records of the JAX collect (algo/collect.py:39-62) at train_supervised.py's
# defaults with depth, seg and pcl on: dtype in the chunk, per-step shape
COLLECT_SCHEMA = {
    "obs": ("float32", (15,)), "student_obs": ("float32", (15,)), "priv_info": ("float32", (64,)),
    "actions": ("float32", (6,)), "rewards": ("float32", ()), "latent": ("float32", (8,)),
    "done": ("bool", ()), "success": ("float32", ()), "plug_pos": ("float32", (3,)),
    "plug_quat": ("float32", (4,)), "socket_pos": ("float32", (3,)), "socket_quat": ("float32", (4,)),
    "eef_pos": ("float32", (3,)), "eef_quat": ("float32", (4,)), "img": ("float16", (54, 96)),
    "seg": ("int8", (54, 96)), "pcl": ("float16", (800, 3)),   # 400 plug + 400 socket points
}
ROTATE_FRAMES = 60              # collect_rotating_plug's default n_steps
ROTATE_ENVS = 32                # scripts/collect_rotate.sh's default
# scripts/gen_grasp.sh's defaults (generate_grasp_dataset's settle_steps) and the
# reference's grasp file: key -> dtype
GRASP_ENVS, GRASP_ROUNDS, GRASP_SETTLE = 256, 8, 30
GRASP_KEYS = {"sub_idx": "int32", "dof_pos": "float32", "socket_pos": "float32", "socket_quat": "float32",
              "plug_pos_hand": "float32", "plug_quat_hand": "float32"}
GAN_EPOCHS = 1                  # CycleGANConfig's 5, cut
DIFFUSION_EPOCHS = 1            # DiffusionConfig's 10, cut
# sys-id: a trail recorded under known scales, then sys_id.sh's TPE (its KDE branch
# starts at 8 trials of history)
SYSID_TRUTH = {"mu_scale": 1.5, "kp_scale": 1.0, "kd_scale": 1.0, "mass_scale": 1.2}
SYSID_STEPS, SYSID_TRIALS = 20, 12
# scripts/run_pbt_r5.sh's population at the scripts' own sizes, cut in depth (from 24
# intervals of 12 epochs, START_AFTER 1.5e6, INITIAL_DELAY 3e6, EVAL_OBJECTIVE 1)
PBT_ENV = {"RESTORE": CHECKPOINT + ".ckpt", "LR_SPREAD": "1e-4,5e-5,2.5e-5,1.25e-5", "POLICIES": "4",
           "NUM_ENVS": "512", "HORIZON": "64", "EPOCHS_PER_INTERVAL": "1", "INTERVALS": "2",
           "START_AFTER": "0", "INITIAL_DELAY": "0", "EVAL_OBJECTIVE": "0"}
PBT_LOG_KEYS = {"interval", "policy", "objective", "hparams", "replaced", "agent_steps", "train_success_mean",
                "secs"}
# the deploy runs, all at one env
DEPLOY_STEPS, STUDENT_DEPLOY_STEPS, LOOPBACK_STEPS, AUX_DEPLOY_STEPS = 100, 30, 30, 16
CALIB_TRIALS, CALIB_STEPS = 6, 20
ARM_STEPS, ARM_DX = 60, 0.002
# phase 17: data-parallel PPO (train_s1.sh's hyperparameters) on two gloo ranks sharing the card,
# the sensors-on epoch at render_capacity 0.75, nccl at world size 1; the utilities
SHARD_ENVS, SHARD_SENSOR_ENVS, SHARD_SENSOR_STEPS, NCCL_ENVS = 8192, 512, 8, 512
VIDEO_STEPS, DET_ENVS, TRACE_STEPS, RNA_ROWS = 150, 1024, 3, 8192
# phase 18: the bench's sensors-on and point-cloud epochs at its own size; its worker in the
# state mode at its own 1024 envs, the horizon cut from 64 to 16
BENCH_ENVS, BENCH_HORIZON, BENCH_EPOCHS = 8192, 64, 1
BENCH_PLAIN_ENVS = 256          # the plain renderers' chunk on the bench's grid, phase 3's size
BENCH_WORKER = ("state", 1024, 16)
BENCH_WORKER_TIMEOUT = 400


def stand_in_real(frames):
    """The stand-in "real" domain of the CycleGAN: the kernel-rendered gel
    frames ([0, 1]) with their channels reversed, then gamma 0.8. The repo
    holds no real AllSight frames."""
    return np.power(frames[..., ::-1], 0.8)


class PhaseError(RuntimeError):
    pass


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _compare(name, out, ref):
    """Hold the solver kernel to its plain version at the reference's
    fused-vs-XLA solver tolerances (`capture.SOLVER_TOL`) -> max abs error."""
    from isaacgyminsertion_tpu_torch.utils import capture

    worst, bad, finite = capture.solver_errors(out, ref)
    if not finite:
        raise PhaseError(f"{name}: a kernel output is not finite")
    if bad:
        field, n_bad, size, i, a, b = bad[0]
        rtol, atol = capture.SOLVER_TOL[field]
        raise PhaseError(f"{name}: {field} differs at {i}: kernel {a} vs plain {b} "
                         f"({n_bad} of {size} outside rtol {rtol}, atol {atol})")
    return worst


def _solver_scale(out, ref):
    """Why a large absolute solver error passes: → (the worst error relative
    to |plain| over the elements where |plain| passes their atol, the largest
    |plain|, the largest share of the tolerance atol + rtol |plain| used)."""
    from isaacgyminsertion_tpu_torch.utils import capture

    rel, big, share = 0.0, 0.0, 0.0
    for field, (rtol, atol) in capture.SOLVER_TOL.items():
        a = getattr(out, field).detach().double().cpu().numpy()
        b = getattr(ref, field).detach().double().cpu().numpy()
        err, mag = np.abs(a - b), np.abs(b)
        on = mag > atol
        if on.any():
            rel = max(rel, float((err[on] / mag[on]).max()))
        big = max(big, float(mag.max()))
        share = max(share, float((err / (atol + rtol * mag)).max()))
    return rel, big, share


def _compare_images(name, out, ref, ids=()):
    """Renderer kernel vs plain, noise off → (max abs error off the flipped
    pixels, share of pixels that differ by more than 1e-3). The two round
    differently (fused multiply-adds), so a silhouette pixel can flip; more
    than 0.5 % of them, or a non-finite value, fails. `ids` holds (kernel,
    plain) pairs of id planes (component, hit flag) that must be equal off the
    flipped pixels; where two surfaces meet within rounding along a curve the
    nearer one can differ at equal depth, so up to 0.01 % of the pixels may."""
    import torch

    if not bool(torch.isfinite(out).all()):
        raise PhaseError(f"{name}: kernel output is not finite")
    err = (out - ref).abs()
    flipped = err > 1e-3
    share = float(flipped.float().mean())
    if share > 5e-3:
        raise PhaseError(f"{name}: {share:.4%} of the pixels differ by more than 1e-3 "
                         f"(max {float(err.max()):.3e})")
    for k_ids, p_ids in ids:
        if not bool(torch.isfinite(k_ids).all()):
            raise PhaseError(f"{name}: a kernel id plane is not finite")
        off = float(((k_ids != p_ids) & ~flipped).float().mean())
        if off > 1e-4:
            raise PhaseError(f"{name}: ids differ on {off:.4%} of the pixels off the flipped ones")
    return float(err[~flipped].max()), share


def _check_noise(name, noisy, clean):
    """Noise statistics of the tactile kernel against its noise-off image."""
    import torch

    if not bool(torch.isfinite(noisy).all()):
        raise PhaseError(f"{name}: noisy output is not finite")
    if float(noisy.min()) < 0.0 or float(noisy.max()) > 1.0:
        raise PhaseError(f"{name}: noisy output leaves [0, 1]")
    interior = (clean > 0.06) & (clean < 0.94)      # 6 sigma away from the clip
    if float(interior.float().mean()) < 0.005:
        raise PhaseError(f"{name}: too few lit pixels to measure the noise")
    resid = (noisy - clean)[interior]
    mean, std = float(resid.mean()), float(resid.std())
    if abs(mean) > 1e-3 or abs(std - 0.01) > 5e-4:
        raise PhaseError(f"{name}: noise residual mean {mean:.3e}, std {std:.4e} (want 0, 0.01)")
    return mean, std


def _train(cli, counts_zero, counts, substeps, out_dir, extra):
    """Phase 8: PPO teacher training through the CLI → the launch counts of its
    run; each epoch's env-steps/s goes to `extra["train_fps"]`."""
    import torch

    epochs_args = [f"num_envs={TRAIN_ENVS}", f"max_epochs={TRAIN_EPOCHS}", "seed=0", f"output={out_dir}",
                   "eval_freq_steps=1e12"]
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.main(TRAIN_S1_ARGS + epochs_args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    horizon = trainer.ppo_cfg.horizon
    steps = horizon * TRAIN_EPOCHS
    print(f"main path: teacher training (train_s1.sh: horizon {horizon}, {trainer.ppo_cfg.mini_epochs} "
          f"mini-epochs), {TRAIN_ENVS} envs x {TRAIN_EPOCHS} epochs: {secs:.2f} s incl. reset, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c}", flush=True)
    want = _launches(substeps * steps)
    if c != want:
        raise PhaseError(f"training launches {c}, expected {want}")
    if trainer.state.agent_steps != TRAIN_ENVS * steps:
        raise PhaseError(f"agent_steps {trainer.state.agent_steps}, expected {TRAIN_ENVS * steps}")
    rows = _epoch_rows(out_dir, TRAIN_EPOCHS, ("loss", "a_loss", "c_loss", "kl", "info/param_norm"))
    extra["train_fps"] = [r["performance/EnvStepFPS"] for r in rows]
    for i, r in enumerate(rows):
        print(f"training epoch {i + 1}: EnvStepFPS {r['performance/EnvStepFPS']:.1f} env-steps/s, "
              f"rollout {r['time/rollout_s']:.2f} s, update {r['time/update_s']:.2f} s (advantages "
              f"{r['time/advantages_s']:.3f}, normalizers {r['time/normalizers_s']:.3f}, batch "
              f"{r['time/batch_s']:.3f}), peak memory {r['performance/peak_memory_gb']:.3f} GB, "
              f"loss {r['loss']:.4f}, a_loss {r['a_loss']:.4f}, c_loss {r['c_loss']:.4f}, "
              f"kl {r['kl']:.5f}, diag/clip_frac {r['diag/clip_frac']:.4f}, reward "
              f"{r['episode/reward']:.4f}", flush=True)
    if not all(bool(torch.isfinite(p).all()) for p in trainer.net.parameters()):
        raise PhaseError("a parameter is not finite after training")
    ckpt = os.path.join(out_dir, "last")
    if not os.path.isfile(ckpt + ".ckpt"):
        raise PhaseError("training wrote no last.ckpt")
    del trainer
    torch.cuda.empty_cache()
    success = cli.main(["train.algo=PPO", "test=True", f"checkpoint={ckpt}", "num_envs=256",
                        "task.rl.max_episode_length=50"])
    if not (math.isfinite(success) and 0.0 <= success <= 1.0):
        raise PhaseError(f"the eval of the trained last.ckpt gave success {success}")
    print(f"main path: the trained last.ckpt in the teacher eval CLI, 256 envs x 50 steps: success "
          f"{success:.4f}", flush=True)
    return c


def _epoch_rows(out_dir, n, keys):
    """The epochs' rows of a training run's metrics.jsonl, each checked finite."""
    rows = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    rows = [r for r in rows if "loss" in r]
    if len(rows) != n:
        raise PhaseError(f"{len(rows)} epochs logged, expected {n}")
    for i, r in enumerate(rows):
        bad = [k for k in keys if not math.isfinite(r[k])]
        if bad:
            raise PhaseError(f"epoch {i + 1}: {bad} not finite")
    return rows


def _train_student(cli, counts_zero, counts, substeps, out_dir):
    """Phase 9: DAgger student training through the CLI → the launch counts of its run."""
    import torch

    from isaacgyminsertion_tpu_torch.algo import trainer as trainer_mod

    argv = TRAIN_S2_ARGS + [f"task.env.numEnvs={STUDENT_ENVS}", f"max_epochs={STUDENT_EPOCHS}", "seed=0",
                            "eval_freq_steps=1e12", "eval_envs=64", f"output={out_dir}"]
    eval_task_config = trainer_mod.eval_task_config

    def short_eval(cfg_task):
        """The trainer's eval config with its episode cut to STUDENT_EVAL_STEPS (depth only)."""
        cfg = eval_task_config(cfg_task)
        return cfg.replace(rl=dataclasses.replace(cfg.rl, max_episode_length=STUDENT_EVAL_STEPS))

    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer_mod.eval_task_config = short_eval
    try:
        trainer = cli.main(argv)
    finally:
        trainer_mod.eval_task_config = eval_task_config
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    da = trainer.da_cfg
    # the student eval runs whole chunks of 50 steps
    steps, eval_steps = da.horizon * STUDENT_EPOCHS, -(-STUDENT_EVAL_STEPS // 50) * 50
    print(f"main path: student training (train_s2.sh as retrain_student_r5.sh runs it: horizon "
          f"{da.horizon}, {da.mini_epochs} mini-epochs, reservoir {da.replay_size} stratified), "
          f"{STUDENT_ENVS} envs x {STUDENT_EPOCHS} epochs + a {eval_steps}-step eval at 64 envs: "
          f"{secs:.2f} s incl. reset and eval, peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
          f"launches {c}", flush=True)
    want = _launches(substeps * (steps + eval_steps), 0, steps + eval_steps)
    if c != want:
        raise PhaseError(f"student training launches {c}, expected {want}")
    n = STUDENT_ENVS * steps
    if trainer.state.agent_steps != n:
        raise PhaseError(f"agent_steps {trainer.state.agent_steps}, expected {n}")
    res = trainer.train_epoch.reservoir
    k_a = da.replay_size // 2
    want_res = (n, n, False, min(n, k_a), min(n, da.replay_size - k_a))   # β stays above 0.5: A collects
    got_res = (res.cursor, res.cursor_a, res.a_frozen, res.fill_a, res.fill_b)
    if got_res != want_res:
        raise PhaseError(f"reservoir (cursor, cursor_a, a_frozen, fill_a, fill_b) {got_res}, "
                         f"expected {want_res}")
    rows = _epoch_rows(out_dir, STUDENT_EPOCHS, ("loss", "action_loss", "info/param_norm"))
    for i, r in enumerate(rows):
        print(f"student training epoch {i + 1}: EnvStepFPS {r['performance/EnvStepFPS']:.1f} env-steps/s, "
              f"rollout {r['time/rollout_s']:.2f} s, normalizers {r['time/normalizers_s']:.3f} s, scatter "
              f"{r['time/scatter_s']:.3f} s, update {r['time/update_s']:.2f} s, peak memory "
              f"{r['performance/peak_memory_gb']:.3f} GB, action_loss {r['action_loss']:.4f} (the JAX "
              f"package's record: {R5_RECORD[i]:.4f}), beta {r['episode/beta']:.4f}, reward "
              f"{r['episode/reward']:.4f}", flush=True)
    if not all(bool(torch.isfinite(p).all()) for p in trainer.state.net.parameters()):
        raise PhaseError("a student parameter is not finite after training")
    print(f"student reservoir: {sum(v.numel() * v.element_size() for v in res.rows.values()) / 1e9:.3f} GB "
          f"on the card, (cursor, cursor_a, a_frozen, fill_a, fill_b) {got_res}", flush=True)
    del trainer, res
    torch.cuda.empty_cache()
    ckpt = os.path.join(out_dir, "last")
    success = cli.main(EVAL_S2_ARGS + [f"checkpoint={CHECKPOINT}", f"student_checkpoint={ckpt}",
                                       f"task.env.numEnvs={STUDENT_ENVS}", "task.rl.max_episode_length=50"])
    if not (math.isfinite(success) and 0.0 <= success <= 1.0):
        raise PhaseError(f"the eval of the trained student's last.ckpt gave success {success}")
    print(f"main path: the trained student's last.ckpt in the student eval CLI, {STUDENT_ENVS} envs x 50 "
          f"steps: success {success:.4f}", flush=True)
    return c


def _train_student_tactile(cli, counts_zero, counts, substeps, out_dir):
    """Phase 9b: one DAgger epoch of the tactile variant → the launch counts of its run."""
    import torch

    argv = [a for a in R3_ARGS if a != "test=True"] + [
        "test=False", f"checkpoint={CHECKPOINT}", f"task.env.numEnvs={STUDENT_ENVS}", "max_epochs=1",
        "seed=0", "eval_freq_steps=1e12", "eval_envs=64", "task.rl.max_episode_length=50",
        f"output={out_dir}"]
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    h = trainer.da_cfg.horizon
    print(f"main path: student training, tactile variant (tactile + seg + pcl, latent injection), "
          f"{STUDENT_ENVS} envs x 1 epoch + a 50-step eval at 64 envs: {secs:.2f} s incl. reset and eval, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c}", flush=True)
    want = _launches(substeps * (h + 50), h + 50, h + 50)
    if c != want:
        raise PhaseError(f"tactile student training launches {c}, expected {want}")
    r = _epoch_rows(out_dir, 1, ("loss", "action_loss", "info/param_norm"))[0]
    print(f"student training, tactile variant: EnvStepFPS {r['performance/EnvStepFPS']:.1f} env-steps/s, "
          f"rollout {r['time/rollout_s']:.2f} s, update {r['time/update_s']:.2f} s, peak memory "
          f"{r['performance/peak_memory_gb']:.3f} GB, action_loss {r['action_loss']:.4f}, beta "
          f"{r['episode/beta']:.4f}", flush=True)
    if not all(bool(torch.isfinite(p).all()) for p in trainer.state.net.parameters()):
        raise PhaseError("a student parameter is not finite after the tactile epoch")
    return c


def _collect_path(counts_zero, counts, substeps, work):
    """Phase 10: collection, one offline epoch and the banked student's loss
    on the collection → the launch counts of the collection."""
    import shutil

    import numpy as np
    import torch

    from isaacgyminsertion_tpu_torch import native, train_supervised
    from isaacgyminsertion_tpu_torch.data.data_io import inspect_trajectories
    from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

    data, out = os.path.join(work, "traj"), os.path.join(work, "offline")
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = train_supervised.main(COLLECT_ARGS + [f"data_dir={data}"])
    secs = time.perf_counter() - t0
    c_collect = counts()
    steps = st["steps"]
    print(f"main path: collection (chip_offline_r5.sh's: r2b teacher, depth + seg + pcl, chunks of 32), "
          f"{COLLECT_ENVS} envs x {steps} steps -> {st['count']} trajectories: {secs:.2f} s incl. reset, "
          f"{st['rollout_s'] / steps * 1e3:.2f} ms a control step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c_collect}", flush=True)
    want = _launches(substeps * steps, 0, steps)
    if c_collect != want:
        raise PhaseError(f"collection launches {c_collect}, expected {want}")
    if st["count"] < COLLECT_TRAJS or st["files"] != st["count"]:
        raise PhaseError(f"collection wrote {st['files']} files for {st['count']} trajectories")
    loop = st["rollout_s"] + st["host_copy_s"] + st["logger_s"]
    print(f"collection: writer {st['writer']} ({native.LIB_PATH or native.BUILD_ERROR}); {st['files']} files, "
          f"{st['bytes'] / 1e6:.1f} MB; rollout {st['rollout_s']:.2f} s, host copies "
          f"{st['host_copy_s']:.3f} s, "
          f"logger {st['logger_s']:.2f} s (add_chunk: median {statistics.median(st['logger_chunk_s']):.3f} s "
          f"a chunk, {st['logger_chunk_s'][-1]:.2f} s the last, where the episodes end; final drain "
          f"{st['logger_drain_s']:.2f} s; "
          f"{st['files'] / st['logger_s']:.1f} files/s, "
          f"{st['bytes'] / 1e6 / st['logger_s']:.1f} MB/s); host share (copies + logger) "
          f"{(st['host_copy_s'] + st['logger_s']) / loop:.3f}", flush=True)
    if st["writer"] != "native .itraj":
        raise PhaseError(f"the collection fell back to the {st['writer']} writer: {native.BUILD_ERROR}")
    schema = {k: (d, tuple(s)) for k, (d, s) in st["schema"].items()}
    if schema != COLLECT_SCHEMA:
        raise PhaseError(f"collected records {schema}, the JAX collect's {COLLECT_SCHEMA}")
    files = sorted(f for f in os.listdir(data) if f.endswith(".itraj"))
    traj = native.read_trajectory(os.path.join(data, files[0]))
    for k, (dtype, shape) in COLLECT_SCHEMA.items():
        got = (str(traj[k].dtype), traj[k].shape[1:])
        if got != (str(native.stored_dtype(dtype)), shape):
            raise PhaseError(f"{files[0]}:{k} stored as {got}, expected {native.stored_dtype(dtype)} {shape}")
    summary = inspect_trajectories(data)
    print(f"collection: schema of {len(COLLECT_SCHEMA)} keys as the JAX collect's; inspect_trajectories "
          f"{summary}", flush=True)
    if summary["num_trajectories"] != st["count"]:
        raise PhaseError(f"inspect_trajectories read {summary['num_trajectories']} of {st['count']}")

    # one epoch of the offline recipe, on the banked normalizer
    shutil.copy(os.path.join(OFFLINE_R5, "normalization.pkl"), data)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = train_supervised.main([f"data_dir={data}", f"output={out}", "epochs=1"] + OFFLINE_ARGS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    m = json.loads(open(os.path.join(out, "metrics.jsonl")).readlines()[-1])
    if not (math.isfinite(m["train/loss"]) and math.isfinite(m["val/loss"])):
        raise PhaseError(f"offline epoch losses {m}")
    tree = restore_path(os.path.join(out, "last"))
    kernel = tree["student_params"]["params"]["obs_enc"]["Dense_0"]["kernel"]
    if np.asarray(kernel).shape != (15, 128):
        raise PhaseError(f"last.ckpt's obs_enc kernel {np.asarray(kernel).shape}: not the flax layout")
    before = [p.detach().clone() for p in runner.student.parameters()]
    runner.restore(os.path.join(out, "last"))
    if not all(torch.equal(a, b) for a, b in zip(before, runner.student.parameters())):
        raise PhaseError("last.ckpt did not load back into the offline student")
    print(f"main path: offline epoch (obs + pcl, only-BC, batch 256), {len(runner.dataset)} train and "
          f"{len(runner.val_dataset)} held-out samples, {runner.updates} Adam steps: {secs:.2f} s incl. "
          f"loading the data, peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, train/loss "
          f"{m['train/loss']:.5f}, val/loss {m['val/loss']:.5f}; last.ckpt in the flax layout loads back",
          flush=True)

    # the banked offline_r5 student on this collection, with the banked normalizer
    runner.restore(os.path.join(OFFLINE_R5, "last"))
    t0 = time.perf_counter()
    losses, n = 0.0, 0
    for ds in (runner.dataset, runner.val_dataset):
        for batch in ds.batches(min(256, len(ds)), np.random.default_rng(1)):
            losses += float(runner.eval_step(runner._prepare(batch, None, augment=False))["loss"])
            n += 1
    if n == 0:
        raise PhaseError("the collection gave no batch for the distribution check")
    loss = losses / n
    print(f"distribution check: the banked offline_r5 student's only-BC loss on this collection "
          f"{loss:.5f} over {n} batches ({time.perf_counter() - t0:.2f} s) beside its held-out "
          f"{OFFLINE_R5_VAL} on the banked data; band 0.0084-0.034"
          + ("" if 0.0084 <= loss <= 0.034 else ": OUTSIDE, a fault for ROADMAP"), flush=True)
    if not (math.isfinite(loss) and loss <= 3 * OFFLINE_R5_VAL):
        raise PhaseError(f"the banked student's loss on the collection is {loss} (> 0.05 or not finite)")
    return c_collect


def _replay_path(counts_zero, counts, substeps, work):
    """Phase 10, its second half: the banked student's replay through
    train_supervised's offline_training_w_env, on phase 10's collection → the
    launch counts of the replay."""
    import torch

    from isaacgyminsertion_tpu_torch import train_supervised

    data, out = os.path.join(work, "traj"), os.path.join(work, "offline")
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = train_supervised.main([f"data_dir={data}", f"output={out}_replay", "epochs=0",
                                    f"restore={os.path.join(OFFLINE_R5, 'last')}",
                                    "offline_training_w_env=True", f"num_envs={COLLECT_ENVS}"]
                                   + OFFLINE_ARGS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c_replay = counts()
    sr = runner.replay_success
    print(f"main path: offline_r5 replay, {COLLECT_ENVS} envs x 500 steps: success {sr:.4f} beside the "
          f"banked {OFFLINE_R5_REPLAY}" + ("" if sr <= 0.02 else " (above 0.02: a fault for ROADMAP)")
          + f"; {secs:.2f} s incl. loading the data, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c_replay}", flush=True)
    if not (math.isfinite(sr) and 0.0 <= sr <= 1.0):
        raise PhaseError(f"replay success {sr}")
    want = _launches(substeps * 500, 0, 500)
    if c_replay != want:
        raise PhaseError(f"replay launches {c_replay}, expected {want}")
    return c_replay


def _tactile_data_path(cli, counts_zero, counts, work):
    """Phase 10b: rotating-plug frames through the CLI, each frame the kernel
    rendered held to the plain renderer on the same inputs, then the tactile
    pose regressor on them → (the launch counts of the collection, the
    frames' max abs error against the plain renderer)."""
    import numpy as np
    import torch

    from isaacgyminsertion_tpu_torch.algo.tactile_runner import TactileRegressionRunner, TactileRunnerConfig
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk

    frames_in = []   # (inputs, kernel output) of every tactile render of the run
    render = rk.tactile_render

    def recording_render(*args, **kw):
        img = render(*args, **kw)
        frames_in.append(([a.clone() for a in args], dict(kw), img.clone()))
        return img

    counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk.tactile_render = recording_render
    try:
        n = cli.main(["collect_rotate=True", f"task.env.numEnvs={ROTATE_ENVS}", f"output={work}/tactile_rot"])
    finally:
        rk.tactile_render = render
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    print(f"main path: rotating-plug collection, {ROTATE_ENVS} envs x {ROTATE_FRAMES} frames ({n}): "
          f"{secs:.2f} s incl. reset, launches {c}", flush=True)
    want = _launches(0, ROTATE_FRAMES, 0)
    if c != want:
        raise PhaseError(f"rotating-plug launches {c}, expected {want}")
    with np.load(f"{work}/tactile_rot_rotate.npz") as d:
        tactile, quat, pos = d["tactile"], d["plug_quat"], d["plug_pos"]
    if not (np.isfinite(tactile).all() and tactile.min() >= 0.0 and tactile.max() <= 1.0):
        raise PhaseError("rotating-plug frames not finite or outside [0, 1]")
    if len(frames_in) != ROTATE_FRAMES:
        raise PhaseError(f"{len(frames_in)} tactile renders recorded, expected {ROTATE_FRAMES}")
    errs, shares = [], []
    with torch.no_grad():
        for t, (args, kw, img) in enumerate(frames_in):
            if args[0].device.type != "cuda":
                raise PhaseError(f"rotating-plug frame {t} was rendered on {args[0].device}")
            e, share = _compare_images(f"tactile_render rotating plug, frame {t}", img,
                                       rk.tactile_render_plain(*args, **kw))
            errs.append(e)
            shares.append(share)
    lit = float((frames_in[-1][2] > 0.01).float().mean())
    print(f"kernel vs plain: tactile_render exact R={frames_in[0][0][0].shape[0]} (rotating plug, "
          f"{ROTATE_FRAMES} frames, force 5.0): max_abs_err {max(errs):.3e}, at most {max(shares):.5%} "
          f"of a frame's pixels flipped, last frame {lit:.3%} lit", flush=True)
    frames = tactile.reshape((-1,) + tactile.shape[2:])
    targets = np.concatenate([np.broadcast_to(pos[:, None], quat.shape[:2] + (3,)), quat], -1).reshape(-1, 7)
    t0 = time.perf_counter()
    reg = TactileRegressionRunner(TactileRunnerConfig(epochs=8), os.path.join(work, "tactile_reg"))
    last = reg.fit(frames, targets)
    el = reg.epoch_losses
    print(f"tactile regressor: {frames.shape[0]} frames {frames.shape[1:]}, 8 epochs in "
          f"{time.perf_counter() - t0:.2f} s; mean loss by epoch {[round(x, 6) for x in el]}, last step "
          f"{last:.6f}; frames mean {float(tactile.mean()):.4f}", flush=True)
    if not (all(math.isfinite(x) for x in el) and len(el) == 8 and el[-1] < el[0]):
        raise PhaseError(f"the tactile regressor's loss did not fall: {el}")
    return c, max(errs)


def _grasp_path(cli, counts_zero, counts, substeps, work):
    """Phase 11: grasp generation through `vec_env.make("FactoryTaskGraspTactile")`
    at gen_grasp.sh's defaults, the table's rows, PPO training on it through
    the CLI, and the resets from it → (the launch counts of the generation,
    of the training)."""
    import numpy as np
    import torch

    from isaacgyminsertion_tpu_torch.envs import grasp_gen, insertion, vec_env

    path = os.path.join(work, "initial_grasp_data.npz")
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task = vec_env.make("FactoryTaskGraspTactile", num_envs=GRASP_ENVS)
    n = task.run(n_rounds=GRASP_ROUNDS, out_path=path)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c_gen = counts()
    print(f"main path: grasp generation (gen_grasp.sh: {GRASP_ENVS} envs x {GRASP_ROUNDS} rounds x "
          f"{GRASP_SETTLE} settling steps, gravity -9.81): {n} rows written of {GRASP_ENVS * GRASP_ROUNDS} "
          f"envs, {secs:.2f} s incl. resets, peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
          f"launches {c_gen}", flush=True)
    want = _launches(GRASP_ROUNDS * GRASP_SETTLE * substeps)
    if c_gen != want:
        raise PhaseError(f"grasp generation launches {c_gen}, expected {want}")
    with np.load(path) as d:
        layout = {k: str(d[k].dtype) for k in d.files}
    if layout != GRASP_KEYS or n == 0:
        raise PhaseError(f"grasp file {layout} with {n} rows; the reference writes {GRASP_KEYS}")
    n_sub = len(task.subs.names)
    kept = int(grasp_gen.load_grasp_data(path, n_sub, max_rows=max(n, 1), model=task.model).count.sum())
    table = grasp_gen.load_grasp_data(path, n_sub, model=task.model)
    print(f"grasp table: {n} rows written, {n - kept} removed by the world-Euler filter (> 0.4 rad), "
          f"{int(table.count.sum())} kept (at most 512 a subassembly); rows by subassembly "
          f"{dict(zip(task.subs.names, table.count.tolist()))}", flush=True)
    del task
    torch.cuda.empty_cache()

    # PPO training on the table through the CLI (train_s1.sh's hyperparameters)
    out_dir = os.path.join(work, "grasp_ppo")
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.main(TRAIN_S1_ARGS + [f"num_envs={TRAIN_ENVS}", "max_epochs=1", "seed=0", f"output={out_dir}",
                                        "eval_freq_steps=1e12", f"grasp_dataset={path}"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c_train = counts()
    steps = trainer.ppo_cfg.horizon
    r = _epoch_rows(out_dir, 1, ("loss", "a_loss", "c_loss", "kl", "info/param_norm"))[0]
    print(f"main path: teacher training on the grasp table (train_s1.sh, grasp_dataset=), {TRAIN_ENVS} envs "
          f"x 1 epoch: {secs:.2f} s incl. loading the table and the reset, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c_train}; EnvStepFPS "
          f"{r['performance/EnvStepFPS']:.1f} env-steps/s, loss {r['loss']:.4f}, kl {r['kl']:.5f}, reward "
          f"{r['episode/reward']:.4f}", flush=True)
    want = _launches(substeps * steps)
    if c_train != want:
        raise PhaseError(f"grasp training launches {c_train}, expected {want}")
    if trainer.train_epoch.grasp_data is None:
        raise PhaseError("the training env did not get the grasp table")
    if not all(bool(torch.isfinite(p).all()) for p in trainer.net.parameters()):
        raise PhaseError("a parameter is not finite after training on the grasp table")
    cfg, model, subs, dev = trainer.cfg_task, trainer.model, trainer.subs, trainer.device
    del trainer
    torch.cuda.empty_cache()

    # every env whose subassembly has rows starts from one of them
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, dev), TRAIN_ENVS,
                                    grasp_data=table)
    cols = [0, 1, 2, 3, 4, 5, 6, 7, 10]   # arm and hand-base joints; the fingers close onto the plug again
    sub = state.sub_idx
    rows_q = torch.as_tensor(table.dof_pos, device=dev)[sub][..., cols]            # [N, S, 9]
    rows_s = torch.as_tensor(table.socket_pos, device=dev)[sub]
    count = torch.as_tensor(table.count, device=dev)[sub]
    valid = torch.arange(rows_q.shape[1], device=dev)[None] < count[:, None]
    hit = ((rows_q == state.phys.q[:, None, cols]).all(-1)
           & (rows_s == state.params.socket_pos[:, None]).all(-1) & valid).any(-1)
    has = count > 0
    if bool((has & ~hit).any()) or not bool(has.any()):
        raise PhaseError(f"{int((has & ~hit).sum())} of {int(has.sum())} envs with rows did not start from one")
    print(f"grasp resets: {int(has.sum())} of {TRAIN_ENVS} envs have rows and each starts from one (arm and "
          f"hand-base dofs and socket position equal to a row's)", flush=True)
    return c_gen, c_train


def _cyclegan_path(cli, counts_zero, counts, substeps, work):
    """Phase 12: CycleGAN on phase 10b's frames, its generator in DAgger
    training on the tactile path, and the hook held on the card → the
    launch counts of the training run."""
    import numpy as np
    import torch

    from isaacgyminsertion_tpu_torch.algo.gan_runner import CycleGANConfig, CycleGANRunner
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.models import zoo
    from isaacgyminsertion_tpu_torch.sensors import tactile as tact_mod
    from isaacgyminsertion_tpu_torch.utils import capture

    with np.load(f"{work}/tactile_rot_rotate.npz") as d:
        sim01 = np.asarray(d["tactile"], np.float32).reshape((-1, 64, 64, 3))
    real01 = stand_in_real(sim01)
    out_dir = os.path.join(work, "cyclegan")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = CycleGANRunner(CycleGANConfig(epochs=GAN_EPOCHS), out_dir, image_shape=(64, 64, 3))
    m = runner.fit(sim01 * 2.0 - 1.0, real01 * 2.0 - 1.0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cyc = [s["cycle"] for s in runner.step_metrics]
    first, last = float(np.mean(cyc[:50])), float(np.mean(cyc[-50:]))
    print(f"main path: CycleGAN (CycleGANConfig: batch {runner.cfg.batch_size}, lr {runner.cfg.learning_rate}), "
          f"{GAN_EPOCHS} epoch on {len(sim01)} kernel-rendered gel frames against the stand-in real domain "
          f"(channels reversed, gamma 0.8): {len(cyc)} steps in {secs:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; last step {m}; cycle loss mean of the first 50 "
          f"steps {first:.4f}, of the last 50 {last:.4f}", flush=True)
    if not all(math.isfinite(v) for s in runner.step_metrics for v in s.values()):
        raise PhaseError("a CycleGAN loss is not finite")
    if not last < first:
        raise PhaseError(f"the CycleGAN cycle loss did not fall: {first} -> {last}")
    ckpt = os.path.join(out_dir, "last")
    g_ab = runner.G_ab
    del runner
    torch.cuda.empty_cache()

    # DAgger training on the tactile path with the generator (phase 9b's run + gan_checkpoint=)
    calls = dict(gen=0, steps_gan=0, steps_plain=0)
    forward, step = zoo.ResnetGenerator.forward, insertion.step

    def counting_forward(self, x):
        calls["gen"] += 1
        return forward(self, x)

    def counting_step(*args, gan=None, **kw):
        calls["steps_gan" if gan is not None else "steps_plain"] += 1
        return step(*args, gan=gan, **kw)

    argv = [a for a in R3_ARGS if a != "test=True"] + [
        "test=False", f"checkpoint={CHECKPOINT}", f"task.env.numEnvs={STUDENT_ENVS}", "max_epochs=1",
        "seed=0", "eval_freq_steps=1e12", "eval_envs=64", "task.rl.max_episode_length=50",
        f"output={out_dir}_student", f"gan_checkpoint={ckpt}"]
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zoo.ResnetGenerator.forward, insertion.step = counting_forward, counting_step
    try:
        trainer = cli.main(argv)
    finally:
        zoo.ResnetGenerator.forward, insertion.step = forward, step
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    h = trainer.da_cfg.horizon
    print(f"main path: student training with the CycleGAN generator (phase 9b's run + gan_checkpoint=), "
          f"{STUDENT_ENVS} envs x 1 epoch + a 50-step eval at 64 envs: {secs:.2f} s incl. reset and eval, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c}; generator calls "
          f"{calls['gen']}, env steps with it {calls['steps_gan']} (the epoch), without it "
          f"{calls['steps_plain']} (the eval)", flush=True)
    want = _launches(substeps * (h + 50), h + 50, h + 50)
    if c != want:
        raise PhaseError(f"CycleGAN student training launches {c}, expected {want}")
    if (calls["gen"], calls["steps_gan"], calls["steps_plain"]) != (h, h, 50):
        raise PhaseError(f"generator calls {calls}: expected {h} in the epoch's {h} steps and none in the "
                         f"eval's 50")
    r = _epoch_rows(f"{out_dir}_student", 1, ("loss", "action_loss", "info/param_norm"))[0]
    print(f"student training with the generator: EnvStepFPS {r['performance/EnvStepFPS']:.1f} env-steps/s, "
          f"rollout {r['time/rollout_s']:.2f} s, action_loss {r['action_loss']:.4f}", flush=True)
    if not all(bool(torch.isfinite(p).all()) for p in trainer.state.net.parameters()):
        raise PhaseError("a student parameter is not finite after the CycleGAN epoch")
    cfg, model, subs, dev = trainer.cfg_task, trainer.model, trainer.subs, trainer.device
    gan = trainer.train_epoch.gan
    if not all(torch.equal(a, b) for a, b in zip(gan.parameters(), g_ab.parameters())):
        raise PhaseError("the trainer's generator is not the CycleGAN's g_ab")
    del trainer
    torch.cuda.empty_cache()

    # the hook on the card: one step with the generator against the same step
    # whose renderer hands out the generator's translation of its frames
    gen = insertion.make_generator(0, dev)
    render = tact_mod.render_tactile

    def translated(*args, **kw):
        img = render(*args, **kw)
        return (gan(img.reshape((-1,) + img.shape[2:]) * 2.0 - 1.0).reshape(img.shape) + 1.0) * 0.5

    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, gen, STUDENT_ENVS)
        act = torch.zeros((STUDENT_ENVS, 6), device=dev)
        for _ in range(3):
            state, _ = insertion.step(cfg, model, subs, state, act, gen)
        gen_b = insertion.make_generator(0, dev)
        gen_b.set_state(gen.get_state())
        s_hook, _ = insertion.step(cfg, model, subs, state, act, gen, gan=gan)
        tact_mod.render_tactile = translated
        try:
            s_ref, _ = insertion.step(cfg, model, subs, state, act, gen_b)
        finally:
            tact_mod.render_tactile = render
        err = float((s_hook.tactile_queue.float() - s_ref.tactile_queue.float()).abs().max())
        fresh = int((s_hook.tactile_queue[:, 0] != state.tactile_queue[:, 0]).flatten(1).any(1).sum())
        frames = torch.rand((3 * STUDENT_ENVS, 64, 64, 3), generator=gen, device=dev) * 2.0 - 1.0
        g_times = capture.cuda_times_ms(lambda: gan(frames), reps=10)
    print(f"CycleGAN hook on the card, {STUDENT_ENVS} envs: tactile queue max abs err {err:.3e} against the "
          f"generator applied to the same step's frames ({fresh} envs took a fresh frame); the generator on "
          f"{3 * STUDENT_ENVS} frames {statistics.median(g_times):.3f} ms a control step "
          f"({capture.spread(g_times)})", flush=True)
    if not err <= 1e-5 or fresh == 0:
        raise PhaseError(f"the hook's frames differ from the generator's by {err} ({fresh} fresh)")
    return c


def _diffusion_path(work):
    """Phase 13: the diffusion policy trained on phase 10's collection, its
    prediction, its checkpoint loaded back."""
    import numpy as np
    import torch

    from isaacgyminsertion_tpu_torch.algo.diffusion_runner import DiffusionConfig, DiffusionRunner
    from isaacgyminsertion_tpu_torch.models.zoo import to_jax_params
    from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

    out_dir = os.path.join(work, "diffusion")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = DiffusionRunner(DiffusionConfig(epochs=DIFFUSION_EPOCHS), os.path.join(work, "traj"), out_dir)
    t_load = time.perf_counter() - t0
    m = runner.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = runner.losses
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
    print(f"main path: diffusion policy (DiffusionConfig: chunk {runner.cfg.chunk}, batch "
          f"{runner.cfg.batch_size}, lr {runner.cfg.learning_rate}, {runner.cfg.num_diffusion_steps} steps), "
          f"{DIFFUSION_EPOCHS} epoch on phase 10's {len(runner.dataset.files)} trajectories ({len(runner.dataset)} "
          f"chunks): {len(losses)} AdamW steps in {secs:.2f} s ({t_load:.2f} s reading the data), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; loss mean of the first 50 steps {first:.5f}, of "
          f"the last 50 {last:.5f} ({m})", flush=True)
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise PhaseError(f"the diffusion loss did not fall or is not finite: {first} -> {last}")
    batch = next(runner.dataset.batches(256, np.random.default_rng(1)))
    obs = batch["student_obs"][:, 0]
    t0 = time.perf_counter()
    pred = runner.predict(obs)
    torch.cuda.synchronize()
    print(f"diffusion predict: {tuple(pred.shape)} in {(time.perf_counter() - t0) * 1e3:.1f} ms (8 DDIM steps "
          f"from the EMA weights), range [{float(pred.min()):.4f}, {float(pred.max()):.4f}]", flush=True)
    if tuple(pred.shape) != (256, runner.cfg.chunk, 6) or not bool(torch.isfinite(pred).all()) \
            or float(pred.abs().max()) > 1.0:
        raise PhaseError(f"predict gave {tuple(pred.shape)}, finite {bool(torch.isfinite(pred).all())}, "
                         f"max |a| {float(pred.abs().max())}")
    saved = runner.checkpoint_tree()
    tree = restore_path(os.path.join(out_dir, "last"))
    with torch.no_grad():
        for p in list(runner.net.parameters()) + list(runner.ema.parameters()):
            p.zero_()
    runner.restore(os.path.join(out_dir, "last"))
    back = {"params": to_jax_params(runner.net), "ema_params": to_jax_params(runner.ema)}
    same = lambda a, b: all(same(a[k], b[k]) for k in a) if isinstance(a, dict) else np.array_equal(a, b)
    if not (same(saved, tree) and same(back, tree)):
        raise PhaseError("the diffusion checkpoint did not load back")
    print("diffusion checkpoint: {params, ema_params} in the flax layout, loads back", flush=True)


def _sysid_path(counts_zero, counts, substeps, work):
    """Phase 14: sys-id (scripts/sys_id.sh's path) against a trail recorded at
    one env under known scales → the launch counts of the replays."""
    import torch

    from isaacgyminsertion_tpu_torch import resolve_device, sysid
    from isaacgyminsertion_tpu_torch.algo.ppo import make_act_fn
    from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.models.actor_critic import actor_critic_from_jax_params
    from isaacgyminsertion_tpu_torch.models.running_mean_std import rms_to
    from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
    from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

    dev = resolve_device(None)
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    tree = restore_path(CHECKPOINT)
    act = make_act_fn(cfg, actor_critic_from_jax_params(tree["params"], dev))
    obs_rms, priv_rms = rms_to(tree["obs_rms"], dev), rms_to(tree["priv_rms"], dev)
    # the r2b teacher's deterministic actions from the reset every trial starts from
    t0 = time.perf_counter()
    gen = insertion.make_generator(0, dev)
    rec = {"actions": [], "plug_pos": [], "plug_quat": []}
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, gen, 1)
        state = state._replace(params=sysid.scale_params(state.params, SYSID_TRUTH))
        for _ in range(SYSID_STEPS):
            a = act(obs_rms, priv_rms, state.obs_queue, insertion.priv_info_of(cfg, model, state))
            state, _ = insertion.step(cfg, model, subs, state, a, gen)
            for k, v in (("actions", a), ("plug_pos", state.phys.plug_pos), ("plug_quat", state.phys.plug_quat)):
                rec[k].append(v[0].cpu().numpy().copy())
    rec = {k: np.stack(v) for k, v in rec.items()}
    traj = os.path.join(work, "sysid_rec.npz")
    np.savez(traj, **rec)
    t_rec = time.perf_counter() - t0
    counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obj = sysid.make_replay_objective(cfg, model, subs, rec)
    truth, ones = obj(SYSID_TRUTH), obj({})
    t_score = time.perf_counter() - t0
    best, hist = sysid.main(["--traj", traj, "--trials", str(SYSID_TRIALS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    replays = SYSID_TRIALS + 2
    print(f"main path: sys-id (sys_id.sh), 1 env x {SYSID_STEPS} steps recorded by the r2b teacher under "
          f"{SYSID_TRUTH} in {t_rec:.2f} s; the objective at the true scales {truth:.6e}, at all-ones "
          f"{ones:.6e} ({t_score:.2f} s for the two); {SYSID_TRIALS} TPE trials; {replays} replays in "
          f"{secs:.2f} s ({secs / (replays * SYSID_STEPS) * 1e3:.1f} ms a replayed step), launches {c}",
          flush=True)
    want = _launches(substeps * SYSID_STEPS * replays)
    if c != want:
        raise PhaseError(f"sys-id launches {c}, expected {want}")
    if not truth < 0.1 * ones:
        raise PhaseError(f"sys-id: the objective at the true scales {truth} is not below a tenth of "
                         f"all-ones' {ones}")
    best_loss = min(loss for _, loss in hist)
    print(f"sys-id: best {({k: round(v, 4) for k, v in best.items()})} loss {best_loss:.6e}; truth "
          f"{SYSID_TRUTH} loss {truth:.6e}; losses by trial {[f'{x:.3e}' for _, x in hist]}", flush=True)
    if not (len(hist) == SYSID_TRIALS and all(math.isfinite(x) for _, x in hist)):
        raise PhaseError("sys-id: a trial's loss is not finite")
    return c


def _pbt_path(cli, counts_zero, counts, substeps, work):
    """Phase 15: PBT (scripts/run_pbt_r5.sh's population, cut in depth) through
    `python -m isaacgyminsertion_tpu_torch.pbt.run`'s main, then its exported
    best in the teacher eval CLI → the launch counts of the sweep and the eval."""
    import torch

    from isaacgyminsertion_tpu_torch.pbt import run as pbt_run

    ws = os.path.join(work, "pbt")
    env = dict(PBT_ENV, WORKSPACE=ws)
    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    members = pbt_run.main(env)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    n_pol, n_int, horizon = int(env["POLICIES"]), int(env["INTERVALS"]), int(env["HORIZON"])
    epochs = n_pol * n_int * int(env["EPOCHS_PER_INTERVAL"])
    print(f"main path: PBT (run_pbt_r5.sh's population: {n_pol} members from r2b, lr {env['LR_SPREAD']}, "
          f"{env['NUM_ENVS']} envs, horizon {horizon}; {n_int} intervals of {env['EPOCHS_PER_INTERVAL']} "
          f"epoch), {epochs} epochs in {secs:.2f} s incl. the builds and resets, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c}", flush=True)
    want = _launches(substeps * horizon * epochs)
    if c != want:
        raise PhaseError(f"PBT launches {c}, expected {want}")
    rows = [json.loads(line) for line in open(os.path.join(ws, "pbt_log.jsonl"))]
    if len(rows) != n_pol * n_int or any(set(r) != PBT_LOG_KEYS for r in rows):
        raise PhaseError(f"pbt_log.jsonl: {len(rows)} lines, keys {sorted(set().union(*map(set, rows)))}")
    for i, m in enumerate(members):
        bad = [h for h in m["history"] if not (math.isfinite(h["param_norm"]) and math.isfinite(h["loss"]))]
        if bad or len(m["history"]) != epochs // n_pol:
            raise PhaseError(f"PBT member {i}: {len(m['history'])} epochs logged, not finite after {bad}")
        print(f"PBT member {i}: env-steps/s by epoch {[round(h['env_steps_per_s'], 1) for h in m['history']]}, "
              f"objective by interval {[r['objective'] for r in rows if r['policy'] == i]}, hparams "
              f"{m['hparams']}, replaced {[r['replaced'] for r in rows if r['policy'] == i]}", flush=True)
    if not all(os.path.isfile(os.path.join(ws, f)) for f in ("best.pbt", "best_success.ckpt")):
        raise PhaseError(f"PBT wrote no best.pbt or no exported best_success.ckpt: {sorted(os.listdir(ws))}")
    del members
    torch.cuda.empty_cache()
    counts_zero()
    success = cli.main(["train.algo=PPO", "test=True", f"checkpoint={ws}/best_success", "num_envs=256",
                        "task.rl.max_episode_length=50"])
    c_eval = counts()
    print(f"main path: PBT's exported best_success.ckpt in the teacher eval CLI, 256 envs x 50 steps: "
          f"success {success:.4f}, launches {c_eval}", flush=True)
    if c_eval != _launches(substeps * 50) or \
            not (math.isfinite(success) and 0.0 <= success <= 1.0):
        raise PhaseError(f"the PBT export's eval: success {success}, launches {c_eval}")
    return c, c_eval


def _deploy_path(cli, counts_zero, counts, substeps, work):
    """Phase 16: the deploy stack at one env → {path: launch counts}."""
    import torch

    from isaacgyminsertion_tpu_torch.data.logger import DataLoggerReal
    from isaacgyminsertion_tpu_torch.deploy import (DiffusionHardwarePlayer, HardwarePlayer,
                                                    PosPredHardwarePlayer, SimInterface,
                                                    StudentHardwarePlayer, calib, devices, transport)
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config

    cfg = default_task_config()
    out = {}

    class Steps:
        """A deploy logger: keeps each step's observation and action, checks
        the frames the player saw, and hands the step on to `inner`."""

        def __init__(self, inner=None, frames=False):
            self.inner, self.frames, self.obs, self.acts = inner, frames, [], []

        def add_step(self, ob, act, done=False):
            self.obs.append(ob)
            self.acts.append(np.asarray(act))
            if self.frames:
                for k, lo, hi in (("tactile", 0.0, 1.0), ("seg", 0.0, 3.0), ("pcl", -1.0, 1.0)):
                    x = ob[k]
                    if x.size == 0 or not np.isfinite(x).all() or x.min() < lo or x.max() > hi:
                        raise PhaseError(f"deploy frame {k} at step {len(self.obs)}: empty, not finite or "
                                         f"outside [{lo}, {hi}]")
            if self.inner is not None:
                self.inner.add_step(ob, act, done=done)

    def drive(label, hw, steps, want, deploy):
        """`deploy()` → the steps it executed, checked against `want` launches a step."""
        counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = deploy()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = counts()
        print(f"main path: deploy, {label}: {n} of {steps} steps in {secs:.2f} s ({secs / max(n, 1) * 1e3:.1f} ms "
              f"a step), success {getattr(hw, 'success', None)}, launches {c}", flush=True)
        w = {k: v * n for k, v in want.items()}
        if c != w:
            raise PhaseError(f"deploy {label}: launches {c}, expected {w}")
        return n, c

    def per_step(tactile=0, camera=0):
        return _launches(substeps, tactile, camera)

    # (a) the teacher player, its trail saved in the logger's schema
    player = HardwarePlayer(CHECKPOINT, cfg)
    trail = os.path.join(work, "deploy_trail")
    logger = DataLoggerReal(trail)
    rec_a, hw = Steps(logger), SimInterface(cfg, seed=0)
    n_a, out["deploy teacher"] = drive("teacher player (r2b) on a 1-env SimInterface", hw, DEPLOY_STEPS,
                                       per_step(), lambda: player.deploy(hw, DEPLOY_STEPS, logger=rec_a))
    logger.close()

    # (b) the student player: student_r3 (tactile, seg, pcl, latent into r2b) on phase 6's flags
    args = cli.parse_args(R3_ARGS)
    rec_b, hw = Steps(frames=True), SimInterface(args["task"], seed=0)
    student = StudentHardwarePlayer(CHECKPOINT, STUDENT_R3, args["dagger"], args["task"])
    _, out["deploy student"] = drive("student player (student_r3) on a sensors-on 1-env SimInterface", hw,
                                     STUDENT_DEPLOY_STEPS, per_step(tactile=1, camera=1),
                                     lambda: student.deploy(hw, STUDENT_DEPLOY_STEPS, logger=rec_b))
    print(f"deploy student frames: {len(rec_b.obs)} observations finite and in range; tactile mean "
          f"{np.mean([o['tactile'].mean() for o in rec_b.obs]):.4f}, seg ids "
          f"{sorted(set(np.unique(rec_b.obs[-1]['seg']).tolist()))}", flush=True)

    # (c) (a)'s player over loopback TCP, the native codec at both ends
    served = SimInterface(cfg, seed=0)
    thread = transport.serve_hardware(served, port=0)
    try:
        remote = transport.RemoteInterface(port=thread.server.server_address[1])
        rec_c = Steps()
        n_c, out["deploy loopback"] = drive("teacher player over RemoteInterface <-> serve_hardware(SimInterface)",
                                            remote, LOOPBACK_STEPS, per_step(),
                                            lambda: player.deploy(remote, LOOPBACK_STEPS, logger=rec_c))
        remote.close()
    finally:
        thread.server.shutdown()
        thread.server.server_close()
    # one process holds both ends: the server's codec is the client's
    codec, note = transport.codec()
    if codec != "native":
        raise PhaseError(f"loopback: the transport took the {codec} codec ({note})")

    rec_w, wire = Steps(), transport.WireDeltas(SimInterface(cfg, seed=0))
    n_w, out["deploy loopback, local float32 deltas"] = drive(
        "teacher player on a 1-env SimInterface fed float32 deltas", wire, LOOPBACK_STEPS, per_step(),
        lambda: player.deploy(wire, LOOPBACK_STEPS, logger=rec_w))
    k = min(n_c, n_a)
    diff = np.abs(np.stack(rec_c.acts[:k]) - np.stack(rec_a.acts[:k])).max(axis=1)
    k_w = min(n_c, n_w)
    bitwise = bool(np.array_equal(np.stack(rec_c.acts[:k_w]), np.stack(rec_w.acts[:k_w])))
    print(f"deploy loopback: codec {codec} at both ends ({note}); actions of {k} steps against "
          f"(a)'s: max abs difference {float(diff.max()):.3e}; against the local run fed float32 deltas "
          f"(as the wire carries them), {k_w} steps: bitwise equal {bitwise}", flush=True)
    if float(diff.max()) > 1e-5:
        t = int(np.argmax(diff > 1e-5))
        d_obs = float(np.abs(rec_c.obs[t]["obs"] - rec_a.obs[t]["obs"]).max())
        print(f"deploy loopback: NOT within 1e-5: the first differing step is {t} (action differs by "
              f"{float(diff[t]):.3e}); its observation differs from (a)'s by {d_obs:.3e}, so "
              f"{'the env state diverged before it' if d_obs > 0 else 'the same observation gave another action'}",
              flush=True)

    # (d) the diffusion player on phase 13's checkpoint, the position player on 10b's regressor
    diffusion = DiffusionHardwarePlayer(os.path.join(work, "diffusion", "last"), cfg)
    hw = SimInterface(cfg, seed=1)
    _, out["deploy diffusion"] = drive("diffusion player (phase 13's EMA weights)", hw, AUX_DEPLOY_STEPS,
                                       per_step(), lambda: diffusion.deploy(hw, AUX_DEPLOY_STEPS))
    cfg_t = cfg.replace(env=dataclasses.replace(cfg.env, tactile=True))
    position = PosPredHardwarePlayer(os.path.join(work, "tactile_reg", "last"), cfg_t)
    hw_t = SimInterface(cfg_t, seed=2)
    _, out["deploy position"] = drive("position player (phase 10b's regressor) on the tactile flag", hw_t,
                                      AUX_DEPLOY_STEPS, per_step(tactile=1),
                                      lambda: position.deploy(hw_t, AUX_DEPLOY_STEPS))

    # (e) calibration of the deploy scales against (a)'s trail
    trajs = calib.load_sim_trajectories(os.path.join(trail, "*.npz"))
    if len(trajs) != 1 or len(trajs[0]["actions"]) != n_a:
        raise PhaseError(f"calibration: {len(trajs)} trails loaded from the logger, expected one of {n_a} steps")
    counts_zero()
    t0 = time.perf_counter()
    best, loss, hist = calib.calibrate_deploy_scales(SimInterface(cfg, seed=0), trajs, n_trials=CALIB_TRIALS,
                                                     max_steps=CALIB_STEPS, seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = out["calibration"] = counts()
    print(f"main path: calibration, {CALIB_TRIALS} trials x {CALIB_STEPS} steps against (a)'s trail: {secs:.2f} s, "
          f"best loss {loss:.6e} m, best {({k: round(v, 6) for k, v in best.items()})}, launches {c}", flush=True)
    want = _launches(substeps * CALIB_TRIALS * CALIB_STEPS)
    if c != want or not math.isfinite(loss):
        raise PhaseError(f"calibration: launches {c} (expected {want}), best loss {loss}")

    # (f) the composite env on a CUDA kinematic arm: servo along +x, then the workspace wall
    arm = devices.KinematicArm()
    env = devices.CompositeEnv(devices.CompositeEnvConfig(with_hand=False), arm=arm)
    try:
        if not env.ready or arm.device.type != "cuda":
            raise PhaseError(f"composite env ready {env.ready}, arm on {arm.device}")
        env.reset()
        p0 = arm._read()["ee_pos"].copy()
        t0 = time.perf_counter()
        for _ in range(ARM_STEPS):
            env.apply_action(np.array([ARM_DX, 0.0, 0.0]), np.zeros(3))
        secs = time.perf_counter() - t0
        d = arm._read()["ee_pos"] - p0
        print(f"deploy arm: {ARM_STEPS} servo steps of {ARM_DX} m along +x in {secs:.3f} s: the eef moved "
              f"{[round(float(x), 5) for x in d]} m", flush=True)
        if not (d[0] > 0.5 * ARM_STEPS * ARM_DX and abs(d[1]) < 0.25 * d[0] and abs(d[2]) < 0.25 * d[0]):
            raise PhaseError(f"the kinematic arm did not follow +x: {d}")
        time.sleep(0.05)                                  # the poller refreshes the pose
        x = float(arm.latest()["ee_pos"][0])
        env.cfg.safety.workspace_hi = (x + 1e-3, 0.3, 0.5)
        env.apply_action(np.array([0.005, 0.0, 0.0]), np.zeros(3))
        print(f"deploy arm: a 5 mm step toward a wall 1 mm away became {float(env._last_action[0]) * 1e3:.4f} mm",
              flush=True)
        if abs(float(env._last_action[0]) - 1e-3) > 1e-6:
            raise PhaseError(f"SafetyLimits did not clamp the step at the wall: {env._last_action[:3]}")
    finally:
        env.close()
    return out


def _sharded_path(x):
    """Phase 17 (a)-(c): data-parallel PPO through `parallel.dryrun`'s rank
    function → {path: launch counts summed over the ranks}."""
    import torch

    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.parallel import dryrun

    out = {}

    def spawn(label, world, backend, specs):
        t0 = time.perf_counter()
        results = dryrun.spawn(world, backend, None, specs)
        print(f"{label}: {world} rank(s), {backend}, {time.perf_counter() - t0:.2f} s with the ranks' start",
              flush=True)
        return results

    def summed(runs):
        return {k: sum(r["counts"][k] for r in runs) for k in runs[0]["counts"]}

    # (a) and (c): one gloo group of two ranks sharing the card
    train_spec = dryrun.RunSpec(n_envs=SHARD_ENVS, horizon=64, mini_epochs=8, reduced=False, seed=0)
    sensor_spec = dryrun.RunSpec(n_envs=SHARD_SENSOR_ENVS, horizon=SHARD_SENSOR_STEPS, sensors=True, seed=1)
    results = spawn("sharded teacher training and the sensors-on epoch", 2, "gloo", [train_spec, sensor_spec])
    runs = [r[0] for r in results]
    m = dryrun.check(results, 0)
    want = _launches(3 * train_spec.horizon)
    fps = sum(r["env_steps_per_s"] for r in runs)
    x.extra["sharded_fps"] = fps
    print(f"main path: sharded teacher training (train_s1.sh: horizon 64, 8 mini-epochs), 2 gloo ranks x "
          f"{SHARD_ENVS // 2} envs on one card, 1 epoch: {[round(r['secs'], 2) for r in runs]} s (rollout "
          f"{m['time/rollout_s']:.2f} s, update {m['time/update_s']:.2f} s on rank 0), "
          f"{fps:.1f} env-steps/s summed over the ranks, launches by rank {[r['counts'] for r in runs]}, "
          f"agent_steps {runs[0]['agent_steps']}, loss {m['loss']:.4f}, kl {m['kl']:.5f}, reward "
          f"{m['episode/reward']:.4f}; parameters, Adam moments and normalizers bitwise equal on both ranks "
          f"(sha256 {runs[0]['digest'][:16]})", flush=True)
    if any(r["counts"] != want for r in runs):
        raise PhaseError(f"sharded training launches {[r['counts'] for r in runs]}, expected {want} a rank")
    if any(r["agent_steps"] != SHARD_ENVS * train_spec.horizon for r in runs):
        raise PhaseError(f"sharded agent_steps {[r['agent_steps'] for r in runs]}")
    if not all(math.isfinite(m[k]) for k in ("loss", "a_loss", "c_loss", "kl")):
        raise PhaseError(f"sharded training losses not finite: {m}")
    out["sharded training"] = summed(runs)

    runs = [r[1] for r in results]
    m = dryrun.check(results, 1)
    k = insertion.render_count(SHARD_SENSOR_ENVS, 0.75)
    rows = np.asarray([r["render_rows"] for r in runs])        # [rank, step, (tactile, camera)]
    drawn = (rows > 0).sum(axis=1)                             # steps each rank rendered, per renderer
    print(f"main path: sensors-on epoch, 2 gloo ranks x {SHARD_SENSOR_ENVS // 2} envs, render_capacity 0.75 "
          f"(k = {k}): rows rendered by rank and step, tactile {rows[:, :, 0].tolist()}, camera "
          f"{rows[:, :, 1].tolist()}; launches by rank {[r['counts'] for r in runs]}; frames "
          f"{runs[0]['frames']}; loss {m['loss']:.4f}, render overflow {m['episode/render_overflow']:.1f}",
          flush=True)
    if not (rows.sum(axis=0) == k).all():
        raise PhaseError(f"the ranks' rendered rows do not sum to k = {k} each step: {rows.tolist()}")
    for r, d in zip(runs, drawn):
        want = _launches(SHARD_SENSOR_STEPS, int(d[0]), int(d[1]))
        if r["counts"] != want:
            raise PhaseError(f"sensors-on rank {r['rank']}: launches {r['counts']}, expected {want}")
        for name, (lo, hi, finite) in r["frames"].items():
            bound = dryrun.SENSOR_QUEUES[name]
            if not finite or lo < bound[0] or hi > bound[1]:
                raise PhaseError(f"sensors-on rank {r['rank']}: {name} in [{lo}, {hi}] (finite {finite})")
    out["sharded sensors-on epoch"] = summed(runs)

    # the dry run's own entry point: the reference's two epochs at 8 envs
    t0 = time.perf_counter()
    results = dryrun.dryrun(2, "gloo")
    print(f"dryrun entry point: {time.perf_counter() - t0:.2f} s", flush=True)
    out["dryrun"] = {k: sum(summed([r[i] for r in results])[k] for i in range(2))
                     for k in ("contact_solver", "contact_gen", "tactile_render", "camera_render")}

    # (b) NCCL at world size 1
    nccl_spec = dryrun.RunSpec(n_envs=NCCL_ENVS, horizon=64, mini_epochs=8, reduced=False, seed=2)
    results = spawn("nccl", 1, "nccl", [nccl_spec])
    run, m = results[0][0], dryrun.check(results, 0)
    print(f"main path: nccl at world size 1, {NCCL_ENVS} envs, 1 epoch: {run['secs']:.2f} s, "
          f"{run['env_steps_per_s']:.1f} env-steps/s, launches {run['counts']}, loss {m['loss']:.4f}",
          flush=True)
    want = _launches(3 * nccl_spec.horizon)
    if run["counts"] != want or not math.isfinite(m["loss"]):
        raise PhaseError(f"nccl: launches {run['counts']} (expected {want}), loss {m['loss']}")
    out["nccl"] = run["counts"]
    torch.cuda.synchronize()
    return out


def _utilities_path(x):
    """Phase 17 (d)-(g): the rollout video, determinism and the profiler,
    the scene export and RNA, the EKI arm → {path: launch counts}."""
    import importlib.util
    import re
    import socket
    import threading

    import torch

    from isaacgyminsertion_tpu_torch.algo import ppo as ppo_mod
    from isaacgyminsertion_tpu_torch.algo.trainer import PPOTrainer
    from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
    from isaacgyminsertion_tpu_torch.deploy import drivers
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.physics.kinematics import forward_kinematics
    from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
    from isaacgyminsertion_tpu_torch.utils import profiling, rna, scene_export, video

    dev = torch.device("cuda")
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    out = {}

    def run(label, fn):
        x.counts_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[label] = x.counts()
        return r, time.perf_counter() - t0

    # (d) the rollout video of the restored r2b teacher, one env
    # record_video runs whole; where imageio or matplotlib is missing, its last step (the
    # encoding, write_eval_video) only keeps what it is handed
    trainer = PPOTrainer(cfg, ppo_mod.PPOConfig(), model, subs, 1, _in(x.work, "video"), device=dev)
    trainer.restore(CHECKPOINT)
    encoders = [m for m in ("imageio", "matplotlib") if importlib.util.find_spec(m) is None]
    handed, write = {}, video.write_eval_video

    def keep_then_write(frames, actions, forces, out_dir):
        handed.update(frames=frames, actions=actions, forces=forces, out_dir=out_dir)
        if encoders:
            return []
        return write(frames, actions, forces, out_dir)

    video.write_eval_video = keep_then_write
    try:
        paths, secs = run("video", lambda: trainer.record_video(n_steps=VIDEO_STEPS))
    finally:
        video.write_eval_video = write
    if encoders:
        print(f"video: {' and '.join(encoders)} not installed on this machine: record_video captured the "
              f"rollout and handed it to write_eval_video, which encoded no file", flush=True)
    else:
        sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
        print(f"video: wrote {sizes} bytes", flush=True)
        if sorted(sizes) != ["rollout.gif", "traces.png"] or not all(sizes.values()):
            raise PhaseError(f"record_video wrote {sizes}")
    frames, forces = handed["frames"], handed["forces"]
    want_dir = os.path.join(trainer.ckpt.out_dir, "videos")
    want = _launches(x.substeps * VIDEO_STEPS, 0, VIDEO_STEPS)
    print(f"main path: PPOTrainer.record_video, r2b restored, 1 env x {VIDEO_STEPS} steps: {secs:.2f} s, "
          f"launches {out['video']}; depth frames {frames.shape} in [{frames.min():.4f}, {frames.max():.4f}], "
          f"handed to the encoder for {handed['out_dir']}", flush=True)
    if out["video"] != want or not np.isfinite(frames).all() or not np.isfinite(forces).all():
        raise PhaseError(f"video: launches {out['video']} (expected {want}) or a frame not finite")
    if frames.shape[0] != VIDEO_STEPS or handed["out_dir"] != want_dir:
        raise PhaseError(f"video: {frames.shape[0]} frames for {handed['out_dir']}, expected "
                         f"{VIDEO_STEPS} for {want_dir}")
    del trainer

    # (e) determinism of one env step at 1024 envs; the same step in a worker thread; a trace
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, dev), DET_ENVS)
        acts = 0.5 * torch.ones((DET_ENVS, 6), device=dev)
        step = lambda: insertion.step(cfg, model, subs, state, acts, insertion.make_generator(1, dev))
        same, _ = run("determinism", lambda: profiling.check_determinism(step))
        main_out = list(profiling.leaves(step()))
        box = []
        worker = threading.Thread(target=lambda: box.append(list(profiling.leaves(step()))))
        worker.start()
        worker.join(timeout=120)
        if worker.is_alive() or not box:
            raise PhaseError("the env step in a worker thread did not finish")
        diff = max((float((a.double() - b.double()).abs().max()) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() and a.numel() else 0.0) for a, b in zip(main_out, box[0]))
        print(f"determinism: one env step at {DET_ENVS} envs, run twice from the same state: bitwise equal "
              f"{same}; the same step in a worker thread against the main thread: largest difference "
              f"{diff:.3e}", flush=True)
        if not same:
            raise PhaseError("the env step is not deterministic on the card")
        trace_dir = _in(x.work, "trace")
        (path, secs) = run("trace", lambda: _traced_steps(profiling, insertion, cfg, model, subs, state, acts,
                                                          trace_dir))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"trace: {TRACE_STEPS} control steps at {DET_ENVS} envs -> {os.path.getsize(path)} bytes, "
              f"{len(events)} events, {kernels} device kernel events, {secs:.2f} s", flush=True)
        if not os.path.getsize(path) or not events:
            raise PhaseError(f"profiling.trace wrote an empty trace: {path}")

        # (f) the scene export and the pose extractor on the card state, RNA on 8192 actions
        usda = scene_export.export_scene_usda(cfg, model, subs, state, os.path.join(x.work, "scene.usda"))
        poses = scene_export.PoseExtractor(model)
        s = state
        for _ in range(3):
            s, _ = insertion.step(cfg, model, subs, s, acts, insertion.make_generator(2, dev))
            poses.record(s, env=5)
        poses.save(_in(x.work, "poses"))
        pos, rotq = np.stack(poses.positions), np.stack(poses.rotations)
        nb = forward_kinematics(model, s.phys.q[:1]).body_t.shape[-2]
        text = open(usda).read()
        print(f"scene export: {len(text)} bytes of USDA ({text.count('def ')} prims); poses "
              f"{pos.shape} / {rotq.shape}, finite {bool(np.isfinite(pos).all() and np.isfinite(rotq).all())}",
              flush=True)
        if (pos.shape != (3, nb + 1, 3) or rotq.shape != (3, nb + 1, 4) or not np.isfinite(pos).all()
                or not np.isfinite(rotq).all() or 'def Xform "plug"' not in text):
            raise PhaseError(f"scene export or poses malformed: {pos.shape}, {rotq.shape}")
        adv = rna.RandomNetworkAdversary(obs_dim=15).to(dev)
        obs = torch.randn((RNA_ROWS, 15), generator=insertion.make_generator(3, dev), device=dev)
        a = torch.rand((RNA_ROWS, 6), generator=insertion.make_generator(4, dev), device=dev) * 2 - 1
        pert = adv.perturb(insertion.make_generator(5, dev), obs, a)
        moved = float((pert - a).abs().max())
        print(f"rna: perturb {RNA_ROWS} x 6 actions on {pert.device}: in [{float(pert.min()):.4f}, "
              f"{float(pert.max()):.4f}], largest change {moved:.4f}", flush=True)
        if not bool(torch.isfinite(pert).all()) or float(pert.abs().max()) > 1.0 or moved == 0.0:
            raise PhaseError("rna: a perturbed action is not finite, leaves [-1, 1], or none moved")
    del state, s

    # (g) the EKI arm on a CUDA KinematicArm against a fake controller on loopback
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(30.0)
    wire = []
    ctrl = threading.Thread(target=_eki_echo, args=(srv, wire, ARM_STEPS), daemon=True)
    ctrl.start()
    arm = drivers.EkiIiwaArm("127.0.0.1", port=srv.getsockname()[1])
    try:
        p0 = arm._read()["ee_pos"].copy()
        _, secs = run("eki arm", lambda: [arm.servo_delta(np.array([ARM_DX, 0.0, 0.0]), np.zeros(3))
                                          for _ in range(ARM_STEPS)])
        d = arm._read()["ee_pos"] - p0
    finally:
        ctrl.join(timeout=30)
        arm.stop()
        srv.close()
    pattern = re.compile(rb'<RobotCommand><Joints( A[1-7]="-?\d+\.\d{6}"){7}/></RobotCommand>')
    fmt = all(pattern.fullmatch(w) for w in wire)
    print(f"eki arm on {arm.device}: {ARM_STEPS} servo steps of {ARM_DX} m along +x over loopback in "
          f"{secs:.3f} s: the measured eef moved {[round(float(v), 5) for v in d]} m; {len(wire)} commands, "
          f"each in the reference's wire format {fmt}", flush=True)
    if arm.device.type != "cuda" or len(wire) != ARM_STEPS or not fmt or ctrl.is_alive():
        raise PhaseError(f"eki arm: device {arm.device}, {len(wire)} commands, format {fmt}")
    if not (d[0] > 0.5 * ARM_STEPS * ARM_DX and abs(d[1]) < 0.25 * d[0] and abs(d[2]) < 0.25 * d[0]):
        raise PhaseError(f"the EKI arm did not follow +x: {d}")
    for name, make in (("ZedCamera", drivers.ZedCamera), ("SerialOpenhand", drivers.SerialOpenhand),
                       ("UsbAllsight", drivers.UsbAllsight),
                       ("ApriltagTracker", lambda: drivers.ApriltagTracker(frame_fn=lambda: None)),
                       ("SegTracker", drivers.SegTracker)):
        try:
            dev_ = make()
            print(f"driver {name}: constructed (its SDK is installed)", flush=True)
            stop = getattr(dev_, "stop", None)
            if stop is not None:
                stop()
        except drivers.DriverUnavailable as e:
            print(f"driver {name}: DriverUnavailable: {e}", flush=True)
    return out


def _bench_path(x):
    """Phase 18: the bench's sensors-on and point-cloud epochs at 8192 envs
    through `bench.build_epoch`, then its worker CLI → {path: launch counts}."""
    import torch

    from isaacgyminsertion_tpu_torch import bench
    from isaacgyminsertion_tpu_torch.parallel.dryrun import SENSOR_QUEUES

    out = {}
    for label, mode in (("(a)", "sensors"), ("(b)", "pcl")):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        step, state, ppo_cfg = bench.build_epoch(bench.task_config(mode), BENCH_ENVS, BENCH_HORIZON)
        torch.cuda.synchronize()
        print(f"bench {label} {mode}: {BENCH_ENVS} envs built and reset in {time.perf_counter() - t0:.2f} s",
              flush=True)
        horizon, steps0 = ppo_cfg.horizon, state.agent_steps
        x.counts_zero()
        t0 = time.perf_counter()
        res, state, m = bench.measure(step, state, BENCH_ENVS, horizon, epochs=BENCH_EPOCHS)
        c = x.counts()
        epochs = 1 + res["epochs"]    # the warm-up and the timed ones
        print(f"main path: bench {label} {mode} through bench.measure, {epochs} epochs in "
              f"{time.perf_counter() - t0:.2f} s: {BENCH_ENVS} envs x {horizon} steps, timed "
              f"{res['seconds_per_epoch']:.2f} s an epoch = {res['rate']:.1f} env-steps/s (rollout "
              f"{m['time/rollout_s']:.2f} s, update {m['time/update_s']:.2f} s), peak memory "
              f"{res['peak_memory_gb']:.3f} GB, {res['flops'] / 1e12:.3f} TFLOP counted in the warm-up "
              f"(mfu {res['mfu']}); timed launches {res['launches']}, steps with rows {res['steps_with_rows']}, "
              f"rendered rows a step {sorted({r for pair in step.render_rows for r in pair})}; launches of "
              f"the {epochs} epochs {c}; loss {m['loss']:.4f}, kl {m['kl']:.5f}, reward "
              f"{m['episode/reward']:.4f}, render overflow {m['episode/render_overflow']:.0f}", flush=True)
        want = {**_launches(x.substeps * horizon * res["epochs"]), **res["steps_with_rows"]}
        if res["launches"] != want:
            raise PhaseError(f"bench {mode}: timed launches {res['launches']}, expected {want}")
        if not all(res["steps_with_rows"].values()):
            raise PhaseError(f"bench {mode}: a renderer was never launched ({res['launches']})")
        if c["contact_solver"] != x.substeps * horizon * epochs or c["contact_gen"] != c["contact_solver"] or not all(
                res["launches"][k] < c[k] <= horizon * epochs for k in ("tactile_render", "camera_render")):
            raise PhaseError(f"bench {mode}: launches of the {epochs} epochs {c}")
        if state.agent_steps - steps0 != BENCH_ENVS * horizon * epochs:
            raise PhaseError(f"bench {mode}: agent steps {state.agent_steps - steps0}, expected "
                             f"{BENCH_ENVS * horizon * epochs}")
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        bad += [k for k in ("rate", "mfu", "loss", "kl") if not math.isfinite(res[k])]
        if bad:
            raise PhaseError(f"bench {mode}: {bad} not finite")
        if not all(bool(torch.isfinite(p).all()) for p in state.net.parameters()):
            raise PhaseError(f"bench {mode}: a parameter is not finite")
        frames = {}
        for name, (lo, hi) in SENSOR_QUEUES.items():
            q = getattr(state.env_state, name)
            if q.numel():
                q = q.float()
                frames[name] = (round(float(q.min()), 4), round(float(q.max()), 4))
                if not bool(torch.isfinite(q).all()) or frames[name][0] < lo or frames[name][1] > hi:
                    raise PhaseError(f"bench {mode}: {name} not finite or outside [{lo}, {hi}]: {frames[name]}")
        want_queues = {"tactile_queue", "img_queue", "seg_queue"} | ({"pcl_queue"} if mode == "pcl" else set())
        if set(frames) != want_queues:
            raise PhaseError(f"bench {mode}: sensor queues {sorted(frames)}, expected {sorted(want_queues)}")
        print(f"bench {label} {mode}: sensor queues finite and in range (min, max) {frames}", flush=True)
        out[f"bench {mode}"] = c
        if mode == "sensors":
            x.extra["bench_render_err"] = _bench_grid_renders(state.env_state)
        del step, state
    torch.cuda.empty_cache()

    # (c) the worker CLI, as the orchestrator spawns it
    mode, n, horizon = BENCH_WORKER
    t0 = time.perf_counter()
    res, err = bench.run_worker(mode, n, horizon, BENCH_WORKER_TIMEOUT)
    if res is None:
        raise PhaseError(f"bench worker: {err}")
    keys = {"rate", "mfu", "device_kind", "peak_memory_gb", "flops", "flops_counted", "seconds_per_epoch",
            "epochs", "launches", "steps_with_rows", "loss", "kl"}
    print(f"main path: bench (c) worker {mode}@{n}, horizon {horizon} (cut from 64), in "
          f"{time.perf_counter() - t0:.2f} s with its start: {json.dumps(res)}", flush=True)
    if set(res) != keys:
        raise PhaseError(f"bench worker: keys {sorted(res)}, expected {sorted(keys)}")
    if not all(isinstance(res[k], float) and math.isfinite(res[k]) for k in ("rate", "mfu")):
        raise PhaseError(f"bench worker: rate {res['rate']} and mfu {res['mfu']} must be finite")
    want = _launches(x.substeps * horizon * res["epochs"])
    if res["launches"] != want:
        raise PhaseError(f"bench worker: launches {res['launches']}, expected {want}")
    out[f"bench worker, {mode}"] = res["launches"]

    # (d) the package's top-level surface on the card: make() and one env step, entry()'s forward
    import isaacgyminsertion_tpu_torch as port
    from isaacgyminsertion_tpu_torch.entry import entry

    x.counts_zero()
    env = port.make("FactoryTaskInsertionTactile", num_envs=N_ENVS)
    env.reset()
    obs, rew, _, _ = env.step(np.zeros((N_ENVS, env.num_actions), np.float32))
    torch.cuda.synchronize()
    out["package make"] = c = x.counts()
    if c != _launches(x.substeps):
        raise PhaseError(f"make: one env step launched {c}")
    if obs["obs"].device.type != "cuda" or not bool(torch.isfinite(obs["obs"]).all() & torch.isfinite(rew).all()):
        raise PhaseError("make: the env's step is not on the card or not finite")
    fn, args = entry()
    mu, value = fn(*args)
    if mu.device.type != "cuda" or tuple(mu.shape) != (128, env.num_actions) or bool(mu.any() | value.any()):
        raise PhaseError(f"entry: mu {tuple(mu.shape)} on {mu.device}; on zero rows mu and value must be 0")
    print(f"package: version {port.__version__}; make(FactoryTaskInsertionTactile, num_envs={N_ENVS}) on "
          f"{obs['obs'].device}, one step: launches {c}, reward mean {float(rew.mean()):.4f}; entry() forward "
          f"mu {tuple(mu.shape)}, value {tuple(value.shape)} on {mu.device}", flush=True)
    return out


def _bench_grid_renders(env_state):
    """Both renderers against their plain versions on the bench's grid: the
    render_selection at render_capacity 0.75 of the bench's 8192-env state
    (k = 6,144 envs, 18,432 tactile rows), the kernel on all rows at once, the
    plain version BENCH_PLAIN_ENVS envs at a time → {kernel: max abs error}."""
    import torch

    from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk
    from isaacgyminsertion_tpu_torch.utils import capture

    model, dev = build_kuka_openhand(), env_state.progress.device
    sel = capture.rank_selections(BENCH_ENVS, 1, 0.75, dev, steps=1)[0][0]
    inputs = lambda rows: capture.sensor_inputs(model, capture.env_rows(env_state, rows))
    with torch.no_grad():
        (t_args, t_kw), (c_args, c_kw) = inputs(sel)
        k_img = rk.tactile_render_cuda(*t_args, **t_kw)
        kt, kd, kc = rk.camera_render_cuda(*c_args, **c_kw)
        torch.cuda.synchronize()
        del t_args, c_args
        p_img, p_cam = [], []
        for i in range(0, len(sel), BENCH_PLAIN_ENVS):
            (t_args, t_kw), (c_args, c_kw) = inputs(sel[i:i + BENCH_PLAIN_ENVS])
            p_img.append(rk.tactile_render_plain(*t_args, **t_kw))
            p_cam.append(rk.camera_render_plain(*c_args, **c_kw))
        p_img = torch.cat(p_img)
        pt, pd, pc = (torch.cat(z) for z in zip(*p_cam))
    e_t, share_t = _compare_images(f"tactile_render exact, the bench's {len(sel)} rows", k_img, p_img)
    e_c, share_c = _compare_images(f"camera_render exact, the bench's {len(sel)} rows", kt, pt,
                                   [(kc, pc), (kd, pd)])
    print(f"kernel vs plain on the bench's grid ({len(sel)} of {BENCH_ENVS} envs of the sensors-on state after "
          f"its epochs, render_capacity 0.75): tactile_render exact R={k_img.shape[0]} max_abs_err {e_t:.3e}, "
          f"{share_t:.5%} of pixels flipped; camera_render exact N={kt.shape[0]} max_abs_err {e_c:.3e}, "
          f"{share_c:.5%} of pixels flipped", flush=True)
    return {"tactile_render": e_t, "camera_render": e_c}


def _traced_steps(profiling, insertion, cfg, model, subs, state, acts, trace_dir):
    """TRACE_STEPS control steps inside `profiling.trace` → the trace's path."""
    import torch

    gen = insertion.make_generator(6, state.phys.q.device)
    with profiling.trace(trace_dir) as path:
        for _ in range(TRACE_STEPS):
            state, _ = insertion.step(cfg, model, subs, state, acts, gen)
        torch.cuda.synchronize()
    return path


def _eki_echo(srv, wire, n):
    """A fake EKI controller: each command's joints echoed back as the
    measured state, its line kept in `wire`."""
    import xml.etree.ElementTree as ET

    conn, _ = srv.accept()
    conn.settimeout(30.0)
    buf = b""
    try:
        for _ in range(n):
            while b"\n" not in buf:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                buf += chunk
            line, buf = buf.split(b"\n", 1)
            wire.append(line)
            j = ET.fromstring(line.decode()).find("Joints").attrib
            conn.sendall(("<RobotState><Joints " + " ".join(f'A{i}="{j[f"A{i}"]}"' for i in range(1, 8))
                          + '/><Wrench Fx="0" Fy="0" Fz="0" Tx="0" Ty="0" Tz="0"/></RobotState>\n').encode())
    finally:
        conn.close()


def _eval(cli, counts_zero, counts, label, argv, n, steps):
    """One eval through the CLI → (success, launch counts)."""
    import torch

    counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    success = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = counts()
    print(f"main path: {label}, {n} envs x {steps} steps: success {success:.4f}, {secs:.2f} s "
          f"({n * steps / secs:.1f} env-steps/s incl. checkpoint load and reset), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches {c}", flush=True)
    return success, c


def _teacher_eval(x):
    """Phase 4: the r2b teacher eval at N_ENVS envs, one 500-step episode."""
    steps = x.steps
    success, c = _eval(x.cli, x.counts_zero, x.counts, "r2b teacher eval",
                       ["train.algo=PPO", "test=True", f"checkpoint={CHECKPOINT}", f"num_envs={N_ENVS}"],
                       N_ENVS, steps)
    if c != _launches(x.substeps * steps):
        raise PhaseError(f"teacher path launches {c}, expected {x.substeps * steps} solver "
                         f"launches (3 per control step) and no renderer launch")
    if not R2B_BAND[0] <= success <= R2B_BAND[1]:
        raise PhaseError(f"r2b success {success:.4f} outside its band {R2B_BAND} (0.8545 since PR 4)")
    return {"teacher": c}


def _r5_eval(x):
    """Phase 5: path A, student_r5 (eval_s2.sh) at STUDENT_ENVS envs."""
    steps = x.steps
    success, c = _eval(x.cli, x.counts_zero, x.counts, "student_r5 eval (obs + pcl, action head)",
                       EVAL_S2_ARGS + [f"checkpoint={CHECKPOINT}", f"student_checkpoint={STUDENT_R5}",
                                       f"task.env.numEnvs={STUDENT_ENVS}"], STUDENT_ENVS, steps)
    print(f"main path: student_r5 success {success:.4f} beside the JAX package's {R5_REFERENCE} "
          f"(256 envs; trial std 0.02-0.034)", flush=True)
    if c != _launches(x.substeps * steps, 0, steps):
        raise PhaseError(f"path A launches {c}, expected camera_render {steps}, contact_solver "
                         f"{x.substeps * steps}, tactile_render 0")
    if not R5_BAND[0] <= success <= R5_BAND[1]:
        raise PhaseError(f"student_r5 success {success:.4f} outside its band {R5_BAND} (0.2461 since PR 4)")
    return {"A": c}


def _r3_eval(x):
    """Phase 6: path B, student_r3, then 50 steps of gathered renders."""
    b_args = R3_ARGS + [f"checkpoint={CHECKPOINT}", f"student_checkpoint={STUDENT_R3}",
                        f"task.env.numEnvs={STUDENT_ENVS}"]
    success, c = _eval(x.cli, x.counts_zero, x.counts, "student_r3 eval (tactile + seg + pcl, latent injection)",
                       b_args + [f"task.rl.max_episode_length={PATH_B_STEPS}"], STUDENT_ENVS, PATH_B_STEPS)
    if c != _launches(x.substeps * PATH_B_STEPS, PATH_B_STEPS, PATH_B_STEPS):
        raise PhaseError(f"path B launches {c}, expected one tactile and one camera launch per "
                         f"control step ({PATH_B_STEPS})")
    if not R3_BAND[0] <= success <= R3_BAND[1]:
        raise PhaseError(f"student_r3 success {success:.4f} outside its band {R3_BAND} (0.0547 since PR 4)")
    _, c_g = _eval(x.cli, x.counts_zero, x.counts, "student_r3 eval, render_capacity 0.75 (gathered renders)",
                   b_args + ["task.env.render_capacity=0.75", "task.rl.max_episode_length=50"],
                   STUDENT_ENVS, 50)
    if c_g != _launches(x.substeps * 50, 50, 50):
        raise PhaseError(f"gathered path launches {c_g}, expected 50 of each renderer")
    return {"B": c}


def _rotating_plug(x):
    """Phase 10b; the frames' error against the plain renderer goes to `x.extra`."""
    c, x.extra["tactile_err"] = _tactile_data_path(x.cli, x.counts_zero, x.counts, x.work)
    return {"rotating plug": c}


def _in(work, name):
    path = os.path.join(work, name)
    os.makedirs(path, exist_ok=True)
    return path


def _two(keys, pair):
    return dict(zip(keys, pair))


# every main path: phase -> its function of the unit's context → {path: launch counts},
# in phase order (the order of the "launches by path" line)
PHASES = {
    "4": _teacher_eval,
    "5": _r5_eval,
    "6": _r3_eval,
    "8": lambda x: {"training": _train(x.cli, x.counts_zero, x.counts, x.substeps, _in(x.work, "train"),
                                       x.extra)},
    "9": lambda x: {"student training": _train_student(x.cli, x.counts_zero, x.counts, x.substeps,
                                                       _in(x.work, "student"))},
    "9b": lambda x: {"student training, tactile": _train_student_tactile(
        x.cli, x.counts_zero, x.counts, x.substeps, _in(x.work, "student_tactile"))},
    "10": lambda x: {"collection": _collect_path(x.counts_zero, x.counts, x.substeps, x.work)},
    "10 replay": lambda x: {"offline replay": _replay_path(x.counts_zero, x.counts, x.substeps, x.work)},
    "10b": _rotating_plug,
    "11": lambda x: _two(("grasp generation", "grasp training"),
                         _grasp_path(x.cli, x.counts_zero, x.counts, x.substeps, x.work)),
    "12": lambda x: {"student training, CycleGAN": _cyclegan_path(x.cli, x.counts_zero, x.counts,
                                                                  x.substeps, x.work)},
    "13": lambda x: _diffusion_path(x.work) or {},
    "14": lambda x: {"sys-id": _sysid_path(x.counts_zero, x.counts, x.substeps, x.work)},
    "15": lambda x: _two(("pbt", "pbt export eval"), _pbt_path(x.cli, x.counts_zero, x.counts, x.substeps,
                                                               x.work)),
    "16": lambda x: _deploy_path(x.cli, x.counts_zero, x.counts, x.substeps, x.work),
    "17": _sharded_path,
    "17d": _utilities_path,
    "18": _bench_path,
}
# The main paths run as worker processes of this script (--unit), UNIT_SLOTS at a time
# on the one card. Each is bound by the host (one Python thread issues every op of a
# control step and the card idles ~90% of it), so several processes share the card.
# A unit is a few phases in one process; it starts once the units whose files it
# reads have ended. The scheduler prefers the units in this order: the collection and
# what reads it first, since they are the longest chain; the two-slot unit next, so that
# it starts while the card still has two slots free.
UNITS = {
    "collection": (("10",), ()),
    "replay": (("10 replay",), ("collection",)),
    "diffusion and deploy": (("13", "16"), ("collection", "rotating plug and CycleGAN")),
    "rotating plug and CycleGAN": (("10b", "12"), ()),
    "sharded training": (("17",), ()),
    "bench": (("18",), ()),
    "student training": (("9", "9b"), ()),
    "pbt": (("15",), ()),
    "student_r3 eval": (("6",), ()),
    "teacher eval": (("4",), ()),
    "student_r5 eval": (("5",), ()),
    "teacher training, grasp resets, sys-id": (("8", "11", "14"), ()),
    "utilities and drivers": (("17d",), ()),
}
UNIT_SLOTS = 4
# a unit that holds more than one process on the card takes as many slots
UNIT_WEIGHT = {"sharded training": 2}


def _launches(solver, tactile=0, camera=0):
    """The hand-written kernels' launches a path must show: contact generation
    launches once for every contact solve."""
    return dict(contact_solver=solver, contact_gen=solver, tactile_render=tactile, camera_render=camera)


def _counters():
    """→ (counts_zero, counts) over the four kernels' launch counts in this process."""
    from isaacgyminsertion_tpu_torch.utils import profiling

    return (lambda: profiling.clear_counters("kernels.")), profiling.launches


def _device():
    """Check for the card and the checkout, turn TF32 off → (torch, the card's
    name and power limit as nvidia-smi gives them)."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        _fail(f"{PACKAGE}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None
    if card is None:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch, card


def _worker(unit, work, result):
    """Run the phases of `unit` in this process; write {"phases": {phase:
    {path: launch counts}}, "extra": ...} to `result`."""
    import types

    torch, _ = _device()
    from isaacgyminsertion_tpu_torch import cli
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config

    cfg = default_task_config()
    counts_zero, counts = _counters()
    x = types.SimpleNamespace(cli=cli, counts_zero=counts_zero, counts=counts, substeps=cfg.sim.substeps,
                              steps=cfg.rl.max_episode_length, work=work, extra={})
    phases = {}
    for p in UNITS[unit][0]:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phases[p] = PHASES[p](x)
        print(f"phase {p}: {time.perf_counter() - t0:.2f} s", flush=True)
    with open(result + ".tmp", "w") as f:
        json.dump({"phases": phases, "extra": x.extra}, f)
    os.replace(result + ".tmp", result)


def _die_with_parent():
    """In a worker, before it runs: the kernel kills it if this script dies."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG


def _run_units(work):
    """Run UNITS as worker processes, UNIT_SLOTS at a time, each once the units
    it needs have ended; print each unit's output when it ends → {unit: its
    result}. A unit that fails stops the others and raises."""
    os.makedirs(os.path.join(work, "units"), exist_ok=True)
    pending, running, done = list(UNITS), {}, {}
    t_all = time.perf_counter()
    try:
        while pending or running:
            for name in [n for n in pending if all(d in done for d in UNITS[n][1])]:
                used = sum(UNIT_WEIGHT.get(n, 1) for n in running)
                if used + UNIT_WEIGHT.get(name, 1) > UNIT_SLOTS:
                    break
                stem = os.path.join(work, "units", name.replace(" ", "_").replace(",", ""))
                log = open(stem + ".log", "w")
                proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--unit", name,
                                         "--work", work, "--result", stem + ".json"],
                                        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                                        preexec_fn=_die_with_parent)
                running[name] = (proc, log, stem, time.perf_counter())
                pending.remove(name)
                print(f"unit {name} (phase {', '.join(UNITS[name][0])}) started at "
                      f"{time.perf_counter() - t_all:.1f} s", flush=True)
            time.sleep(0.5)
            for name, (proc, log, stem, t0) in list(running.items()):
                if proc.poll() is None:
                    continue
                del running[name]
                log.close()
                print(f"---- unit {name}: exit {proc.returncode} after {time.perf_counter() - t0:.1f} s "
                      f"(ended at {time.perf_counter() - t_all:.1f} s)", flush=True)
                with open(stem + ".log") as f:
                    sys.stdout.write(f.read())
                sys.stdout.flush()
                if proc.returncode != 0:
                    raise PhaseError(f"unit {name} (phase {', '.join(UNITS[name][0])}) exited "
                                     f"{proc.returncode}")
                with open(stem + ".json") as f:
                    done[name] = json.load(f)
    finally:
        for proc, log, _, _ in running.values():
            proc.kill()
            proc.wait()
            log.close()
    return done


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, compare and time the kernels; skip the main paths (no result line)")
    ap.add_argument("--unit", choices=sorted(UNITS), help=argparse.SUPPRESS)   # a worker: one unit's phases
    ap.add_argument("--work", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    t_start = time.perf_counter()
    if opts.unit:
        _worker(opts.unit, opts.work, opts.result)
        return
    torch, card = _device()
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}", flush=True)
    print(f"precision: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)

    from isaacgyminsertion_tpu_torch import cli
    from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.physics import contact_kernel as ck
    from isaacgyminsertion_tpu_torch.physics import solver_kernel as sk
    from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
    from isaacgyminsertion_tpu_torch.physics.solver import ContactSet
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk
    from isaacgyminsertion_tpu_torch.utils import capture
    from isaacgyminsertion_tpu_torch.utils.cuda_build import build_all

    # ---------------------------------------------------------------- 2. build
    kernels_src = [sk.KERNEL, ck.KERNEL, rk.TACTILE_KERNEL, rk.CAMERA_KERNEL]
    t0 = time.perf_counter()
    build_all(kernels_src)
    print(f"build: {len(kernels_src)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for k in kernels_src:
        spills = [ln for ln in k.registers() if "spill" in ln]
        print(f"build: {k.name} {k.info['seconds']:.2f} s "
              f"({'cached' if k.info.get('cached') else 'nvcc'}); registers by entry function "
              f"{k.register_counts()}; {'; '.join(spills) or 'no spill'}", flush=True)

    # ------------------------------------------------------ 3. kernel vs plain
    T = lambda a: torch.as_tensor(a, device=dev)

    def random_args(n, c, seed, **kw):
        mass, I_inv, v, w, cs = sk.random_problem(n, c, seed=seed, **kw)
        return T(mass), T(I_inv), T(v), T(w), ContactSet(**{k: T(x) for k, x in cs.items()})

    def solver_vs_plain(name, args, h=H, **kw):
        out = sk.solve_contacts_fused_cuda(*args, h, **kw)
        torch.cuda.synchronize()
        return out, _compare(name, out, sk.solve_contacts_fused_plain(*args, h, **kw))

    rand_args = random_args(N_ENVS, 255, 0)
    out_rand, err_rand = solver_vs_plain("random contacts", rand_args)
    rel_rand, big_rand, share_rand = _solver_scale(out_rand, sk.solve_contacts_fused_plain(*rand_args, H))

    cfg = default_task_config()
    model, subs = build_kuka_openhand(), build_subassembly_set()
    real_args = capture.substep_problem(cfg, model, subs, N_ENVS, H, dev)
    _, err_real = solver_vs_plain("env contacts", real_args)
    k_env = capture.active_counts(real_args[4]).float()
    print(f"kernel vs plain: contact_solver N={N_ENVS} C={real_args[4].depth.shape[1]}: "
          f"random max_abs_err {err_rand:.3e} (worst error relative to |plain| {rel_rand:.3e}, largest "
          f"|plain| {big_rand:.3e}: at most {share_rand:.3f} of SOLVER_TOL's atol + rtol |plain|), env "
          f"substep max_abs_err {err_real:.3e} ({int(k_env.sum())} of {real_args[4].depth.numel()} contacts "
          f"active)", flush=True)
    # the training paths' grids: phase 8 runs the solver at TRAIN_ENVS envs, phase 9 at
    # STUDENT_ENVS envs on train_s2.sh's task (sensors on, random initial grasps)
    train_args = capture.substep_problem(cfg, model, subs, TRAIN_ENVS, H, dev)
    _, err_train = solver_vs_plain(f"env contacts, {TRAIN_ENVS} envs", train_args)
    print(f"kernel vs plain: contact_solver N={TRAIN_ENVS} C={train_args[4].depth.shape[1]}: env "
          f"substep max_abs_err {err_train:.3e} ({int(capture.active_counts(train_args[4]).sum())} of "
          f"{train_args[4].depth.numel()} contacts active)", flush=True)
    student_args = capture.substep_problem(cli.parse_args(TRAIN_S2_ARGS)["task"], model, subs,
                                           STUDENT_ENVS, H, dev)
    _, err_student = solver_vs_plain(f"env contacts, train_s2 task, {STUDENT_ENVS} envs", student_args)
    print(f"kernel vs plain: contact_solver N={STUDENT_ENVS} C={student_args[4].depth.shape[1]}: "
          f"train_s2 task substep max_abs_err {err_student:.3e} "
          f"({int(capture.active_counts(student_args[4]).sum())} of {student_args[4].depth.numel()} "
          f"contacts active)", flush=True)
    # phase 17's grid: each rank of the sharded teacher training steps SHARD_ENVS // 2 envs
    # (rank 1's reset, from its own seed)
    from isaacgyminsertion_tpu_torch.parallel import mesh

    shard_args = capture.substep_problem(cfg, model, subs, SHARD_ENVS // 2, H, dev, seed=mesh.rank_seed(0, 1))
    _, err_shard = solver_vs_plain(f"env contacts, one rank of {SHARD_ENVS} envs", shard_args)
    print(f"kernel vs plain: contact_solver N={SHARD_ENVS // 2} C={shard_args[4].depth.shape[1]}: one rank of "
          f"the sharded training, env substep max_abs_err {err_shard:.3e} "
          f"({int(capture.active_counts(shard_args[4]).sum())} of {shard_args[4].depth.numel()} contacts "
          f"active)", flush=True)
    # and the sensors-on epoch of phase 17 (c) steps one rank's SHARD_SENSOR_ENVS // 2 envs on the
    # dry run's reduced config (one substep of 1/60 s, 4 velocity iterations)
    from isaacgyminsertion_tpu_torch.parallel import dryrun

    cfg_r = dryrun.task_config(dryrun.RunSpec(n_envs=SHARD_SENSOR_ENVS, sensors=True))
    h_r = cfg_r.sim.dt / cfg_r.sim.substeps
    shard_s_args = capture.substep_problem(cfg_r, model, subs, SHARD_SENSOR_ENVS // 2, h_r, dev, seed=1)
    _, err_shard_s = solver_vs_plain("env contacts, reduced config", shard_s_args, h_r,
                                     iters=cfg_r.sim.solver_iters)
    err_shard = max(err_shard, err_shard_s)
    print(f"kernel vs plain: contact_solver N={SHARD_SENSOR_ENVS // 2} C={shard_s_args[4].depth.shape[1]}: one "
          f"rank of the sensors-on sharded epoch ({cfg_r.sim.solver_iters} iterations, h = {h_r:.5f} s), env "
          f"substep max_abs_err {err_shard_s:.3e}", flush=True)
    del shard_args, shard_s_args
    q = lambda x: int(torch.quantile(k_env, x, interpolation="higher"))
    print(f"contact_solver: active contacts per env on the env substep: min {int(k_env.min())}, "
          f"median {q(0.5)}, p99 {q(0.99)}, max {int(k_env.max())} of {real_args[4].depth.shape[1]}; "
          f"random set: median {int(capture.active_counts(rand_args[4]).median())}", flush=True)
    # edge cases, on contact sets that stay bounded over the iterations (short lever arms)
    for c in (255, 37, 200):
        mass, I_inv, v, w, cs = sk.random_problem(8, c, seed=3, lever=0.01)
        cs["depth"][0] = -abs(cs["depth"][0]) - 1e-4         # env 0: no active contact
        cs["depth"][1] = abs(cs["depth"][1]) + 1e-4          # env 1: every contact active
        cs["weight"][2, ::3] = 0.0                            # env 2: inert by weight
        args = (T(mass), T(I_inv), T(v), T(w), ContactSet(**{k: T(x) for k, x in cs.items()}))
        out, e = solver_vs_plain(f"edge cases C={c}", args)
        k_edge = capture.active_counts(args[4]).tolist()
        if k_edge[0] != 0 or k_edge[1] != c:
            raise PhaseError(f"edge cases C={c}: active counts {k_edge}, expected 0 and {c} first")
        if not (torch.equal(out.v[0], args[2][0]) and torch.equal(out.w[0], args[3][0])
                and not bool(out.lam_n[0].any()) and not bool(out.dx[0].any())):
            raise PhaseError(f"edge cases C={c}: the env with no active contact did not keep its velocity")
        inert = ~((args[4].depth > 0) & (args[4].weight != 0))
        if bool(out.lam_n[inert].any()) or bool(out.lam_t[inert].any()):
            raise PhaseError(f"edge cases C={c}: an inert contact got an impulse")
        print(f"kernel vs plain: contact_solver edge cases N=8 C={c}: active per env {k_edge}, "
              f"max_abs_err {e:.3e}, inert impulses exactly 0", flush=True)

    # contact generation: substeps of an r2b rollout at N_ENVS envs, and the first substeps after
    # a reset at TRAIN_ENVS envs (the PPO training grid) and at STUDENT_ENVS envs on train_s2.sh's
    # task (the DAgger grid); the deploy grid's one env follows with the solver's
    gen_sets = {N_ENVS: capture.rollout_contact_inputs(cfg, model, subs, N_ENVS, GEN_ROLLOUT_STEPS, GEN_EVERY,
                                                       dev, CHECKPOINT),
                TRAIN_ENVS: capture.contact_inputs_of(cfg, model, subs, TRAIN_ENVS, dev, steps=1),
                STUDENT_ENVS: capture.contact_inputs_of(cli.parse_args(TRAIN_S2_ARGS)["task"], model, subs,
                                                        STUDENT_ENVS, dev, steps=1)}
    err_gen = {}

    def gen_vs_plain(label, sets):
        worst = {}
        for args in sets:
            out = ck.generate_contacts_cuda(*args)
            torch.cuda.synchronize()
            for f, e in capture.contact_errors(out, ck.generate_contacts_plain(*args)).items():
                worst[f] = max(worst.get(f, 0.0), e)
        if not max(worst.values()) <= GEN_TOL:
            raise PhaseError(f"contact_gen {label}: kernel vs plain {worst}, above {GEN_TOL}")
        return worst

    for n, sets in gen_sets.items():
        worst = gen_vs_plain(f"N={n}", sets)
        err_gen[n] = max(worst.values())
        print(f"kernel vs plain: contact_gen N={n}: {len(sets)} substeps, max_abs_err by field "
              f"{ {f: float(f'{e:.3e}') for f, e in worst.items()} }", flush=True)

    # the renderers: a sensors-on env a few steps after reset (the pads press on the plug)
    cfg_s = capture.sensors_on(cfg)
    s_state, s_out, gen = capture.sensor_state(cfg_s, model, subs, STUDENT_ENVS, dev)
    with torch.no_grad():
        (t_args, t_kw), (c_args, c_kw) = capture.sensor_inputs(model, s_state)
        (tr_args, tr_kw), (cr_args, cr_kw) = capture.random_scene(STUDENT_ENVS, 7, dev)
        (tm_args, tm_kw), (cm_args, cm_kw) = capture.random_scene(8, 11, dev)

        errs = {}
        for label, a, kw in (("env state", t_args, t_kw), ("random", tr_args, tr_kw)):
            k_img = rk.tactile_render_cuda(*a, **kw)
            torch.cuda.synchronize()
            e, share = _compare_images(f"tactile_render exact, {label}", k_img,
                                       rk.tactile_render_plain(*a, **kw))
            errs[("tactile", label)] = e
            lit = float((k_img > 0.01).float().mean())
            print(f"kernel vs plain: tactile_render exact R={a[0].shape[0]} P={a[7].shape[0]} ({label}): "
                  f"max_abs_err {e:.3e}, {share:.5%} of pixels flipped, {lit:.3%} lit", flush=True)
        for label, a, kw in (("env state", c_args, c_kw), ("random", cr_args, cr_kw)):
            kt, kd, kc = rk.camera_render_cuda(*a, **kw)
            torch.cuda.synchronize()
            pt, pd, pc = rk.camera_render_plain(*a, **kw)
            e, share = _compare_images(f"camera_render exact, {label}", kt, pt, [(kc, pc), (kd, pd)])
            errs[("camera", label)] = e
            counts = torch.bincount(kc.long().flatten(), minlength=4).tolist()
            print(f"kernel vs plain: camera_render exact N={a[0].shape[0]} P={a[14].shape[0]} ({label}): "
                  f"max_abs_err {e:.3e}, {share:.5%} of pixels flipped, component pixels "
                  f"table/plug/socket/robot {counts}", flush=True)
        # the scenes on whose edges the exact camera kernel branches
        for label, scal, k_rays, rays, ckw in capture.camera_edge_cases(dev):
            kt, kd, kc = rk.camera_rows_cuda(scal, k_rays, **ckw)
            torch.cuda.synchronize()
            pt, pd, pc = rk.camera_rows_plain(scal, rays, **ckw)
            e, share = _compare_images(f"camera_render exact, {label}", kt, pt, [(kc, pc), (kd, pd)])
            counts = torch.bincount(kc.long().flatten(), minlength=4).tolist()
            print(f"kernel vs plain: camera_render exact N={scal.shape[0]} P={rays.shape[1]} ({label}): "
                  f"max_abs_err {e:.3e}, {share:.5%} of pixels flipped, component pixels "
                  f"table/plug/socket/robot {counts}", flush=True)
        # the march variants at a small shape
        k_img = rk.tactile_render_cuda(*tm_args, **tm_kw, exact=False)
        e, share = _compare_images("tactile_render march", k_img,
                                   rk.tactile_render_plain(*tm_args, **tm_kw, exact=False))
        print(f"kernel vs plain: tactile_render march R={tm_args[0].shape[0]}: max_abs_err {e:.3e}, "
              f"{share:.5%} of pixels flipped", flush=True)
        kt, kd, kc = rk.camera_render_cuda(*cm_args, **cm_kw, exact=False)
        pt, pd, pc = rk.camera_render_plain(*cm_args, **cm_kw, exact=False)
        e, share = _compare_images("camera_render march", kt, pt, [(kc, pc)])
        e_d, _ = _compare_images("camera_render march d_min", kd, pd)
        print(f"kernel vs plain: camera_render march N={cm_args[0].shape[0]}: t max_abs_err {e:.3e}, "
              f"d_min max_abs_err {e_d:.3e}, {share:.5%} of pixels flipped", flush=True)
        # noise, both kinds, against the noise-off image of the same kernel
        clean = rk.tactile_render_cuda(*t_args, **t_kw)
        for kind in ("gauss", "ih4"):
            noisy = rk.tactile_render_cuda(*t_args, **t_kw, generator=insertion.make_generator(5, dev),
                                           noise_std=0.01, noise_kind=kind)
            again = rk.tactile_render_cuda(*t_args, **t_kw, generator=insertion.make_generator(6, dev),
                                           noise_std=0.01, noise_kind=kind)
            torch.cuda.synchronize()
            mean, std = _check_noise(f"tactile_render noise {kind}", noisy, clean)
            if bool((noisy == again).all()):
                raise PhaseError(f"tactile_render noise {kind}: two seeds gave the same image")
            print(f"kernel noise: tactile_render {kind}: residual mean {mean:.3e}, std {std:.4e} "
                  f"(want 0 and 0.01), in [0, 1], finite", flush=True)
        # the deploy path's grid, from 1-env SimInterfaces three steps after reset: the solver at
        # N = 1 (two envs share a warp, so half of it has none), on student_r3's flags the tactile
        # renderer at R = 3 rows and the camera at N = 1
        from isaacgyminsertion_tpu_torch.deploy import SimInterface

        one, one_s = SimInterface(cfg, seed=0), SimInterface(cli.parse_args(R3_ARGS)["task"], seed=0)
        for hw in (one, one_s):
            for _ in range(3):
                hw.apply_action(np.zeros(3), np.zeros(3))
        with capture.recording_contact_inputs() as one_gen:
            one_args = capture.contact_problem_of(model, one.state, H)
        _, err_one = solver_vs_plain("env contacts, 1 env", one_args)
        err_gen[1] = max(gen_vs_plain("N=1", one_gen).values())
        (t1_args, t1_kw), (c1_args, c1_kw) = capture.sensor_inputs(model, one_s.state)
        k_img = rk.tactile_render_cuda(*t1_args, **t1_kw)
        torch.cuda.synchronize()
        errs[("tactile", "one env")], share_t = _compare_images("tactile_render exact, 1 env", k_img,
                                                                rk.tactile_render_plain(*t1_args, **t1_kw))
        kt, kd, kc = rk.camera_render_cuda(*c1_args, **c1_kw)
        torch.cuda.synchronize()
        pt, pd, pc = rk.camera_render_plain(*c1_args, **c1_kw)
        errs[("camera", "one env")], share_c = _compare_images("camera_render exact, 1 env", kt, pt,
                                                               [(kc, pc), (kd, pd)])
        print(f"kernel vs plain at one env (SimInterface): contact_solver N=1 C={one_args[4].depth.shape[1]} "
              f"max_abs_err {err_one:.3e} ({int(capture.active_counts(one_args[4]).sum())} contacts active); "
              f"contact_gen N=1 max_abs_err {err_gen[1]:.3e}; "
              f"tactile_render exact R={t1_args[0].shape[0]} max_abs_err {errs[('tactile', 'one env')]:.3e}, "
              f"{share_t:.5%} of pixels flipped; camera_render exact N={c1_args[0].shape[0]} max_abs_err "
              f"{errs[('camera', 'one env')]:.3e}, {share_c:.5%} of pixels flipped", flush=True)
        del one, one_s
        # phase 17's sensors-on grids: the rows a rank owns of the global selection, a count
        # that varies from step to step. Two ranks of STUDENT_ENVS envs at render_capacity 0.75
        # (k = 384 of 512, as phase 17 (c)), at the first step where each rank's count is odd
        sels = capture.rank_selections(STUDENT_ENVS, 2, 0.75, dev)
        sel_step, sel_pair = next((i, p) for i, p in enumerate(sels) if all(len(x) % 2 for x in p))
        sel_errs = []
        for sel in sel_pair:
            (tg_args, tg_kw), (cg_args, cg_kw) = capture.sensor_inputs(model, capture.env_rows(s_state, sel))
            k_img = rk.tactile_render_cuda(*tg_args, **tg_kw)
            torch.cuda.synchronize()
            e_t, share_t = _compare_images(f"tactile_render exact, {len(sel)} gathered rows", k_img,
                                           rk.tactile_render_plain(*tg_args, **tg_kw))
            kt, kd, kc = rk.camera_render_cuda(*cg_args, **cg_kw)
            torch.cuda.synchronize()
            pt, pd, pc = rk.camera_render_plain(*cg_args, **cg_kw)
            e_c, share_c = _compare_images(f"camera_render exact, {len(sel)} gathered rows", kt, pt,
                                           [(kc, pc), (kd, pd)])
            sel_errs.append((e_t, e_c))
            print(f"kernel vs plain on a rank's gathered rows (global step {sel_step}): tactile_render exact "
                  f"R={tg_args[0].shape[0]} max_abs_err {e_t:.3e}, {share_t:.5%} of pixels flipped; "
                  f"camera_render exact N={cg_args[0].shape[0]} max_abs_err {e_c:.3e}, {share_c:.5%} of pixels "
                  f"flipped", flush=True)
        errs[("tactile", "gathered")] = max(e for e, _ in sel_errs)
        errs[("camera", "gathered")] = max(e for _, e in sel_errs)

    # every image the sensors-on env hands out is finite and in range
    with torch.no_grad():
        for _ in range(5):
            s_state, s_out = insertion.step(cfg_s, model, subs, s_state,
                                            torch.zeros((STUDENT_ENVS, 6), device=dev), gen)
    for name, img, lo, hi in (("tactile", s_out.tactile, 0.0, 1.0), ("seg", s_out.seg, 0.0, 3.0),
                              ("pcl", s_out.pcl, -1.0, 1.0)):
        if not bool(torch.isfinite(img).all()) or float(img.min()) < lo or float(img.max()) > hi:
            raise PhaseError(f"sensor output {name} is not finite or leaves [{lo}, {hi}]")
    print(f"sensors: tactile mean {float(s_out.tactile.mean()):.4f}, seg ids "
          f"{sorted(set(s_out.seg.unique().tolist()))}, pcl centroid "
          f"{[round(x, 4) for x in s_out.pcl.mean((0, 1, 2)).tolist()]}: finite and in range", flush=True)

    kernel_rows = []
    # ------------------------------------------------------------------ 7. times
    def bound(flop, nbytes):
        t_ops, t_bytes = flop / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes

    def row(name, source, replaces, err, times, plain_ms, flop, nbytes):
        b_ms, by, t_ops, t_bytes = bound(flop, nbytes)
        ms = statistics.median(times)
        print(f"times: {name} {ms:.4f} ms ({capture.spread(times)}), plain {plain_ms:.3f} ms; bound "
              f"{b_ms:.4f} ms by {by} ({flop / 1e9:.3f} GFLOP -> {t_ops:.4f} ms, {nbytes / 1e6:.2f} MB "
              f"-> {t_bytes:.4f} ms)", flush=True)
        kernel_rows.append(dict(name=name, route="cuda", source=f"{PACKAGE}/csrc/{source}",
                                replaces=replaces, launches=0, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None))

    time_ms, times_ms = capture.cuda_time_ms, capture.cuda_times_ms
    with torch.no_grad():
        n, c = real_args[4].depth.shape
        solver_times = times_ms(lambda: sk.solve_contacts_fused_cuda(*real_args, H), reps=50)
        solve = lambda args: time_ms(lambda: sk.solve_contacts_fused_cuda(*args, H), reps=50)
        solver_ms = statistics.median(solver_times)
        row(sk.KERNEL_NAME, "contact_solver.cu", "isaacgyminsertion_tpu/physics/solver_pallas.py:40",
            max(err_real, err_train, err_student, err_one, err_shard), solver_times,
            time_ms(lambda: sk.solve_contacts_fused_plain(*real_args, H), reps=5, warmup=1),
            sk.flops(n, c, active=int(k_env.sum())), sk.bytes_moved(n, c))
        print(f"times: contact_solver env substep {N_ENVS} envs {solver_ms:.4f} ms, "
              f"{STUDENT_ENVS} envs (train_s2 task) {solve(student_args):.4f} ms, {TRAIN_ENVS} envs "
              f"{solve(train_args):.4f} ms; random set {N_ENVS} envs "
              f"{solve(rand_args):.4f} ms, {STUDENT_ENVS} envs "
              f"{solve(random_args(STUDENT_ENVS, 255, 0)):.4f} ms", flush=True)
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)   # 1 GB: 20 x L2
        # contact generation on the last substep of each grid, L2 flushed (its inputs come cold)
        gen_line = []
        for n, sets in gen_sets.items():
            args = sets[-1]
            gen_times = times_ms(lambda: ck.generate_contacts_cuda(*args), reps=30, flush=flush)
            nbytes = ck.bytes_moved(n, ck.per_env_floats(args))
            b_ms, by, _, _ = bound(ck.flops(args[7]), nbytes)
            gen_line.append(f"{n} envs {statistics.median(gen_times):.4f} ms ({capture.spread(gen_times)}; bound "
                            f"{b_ms:.4f} ms by {by}, {nbytes / 1e6:.2f} MB)")
            if n == N_ENVS:
                row(ck.KERNEL_NAME, "contact_gen.cu", "none: the JAX package leaves contact generation to XLA",
                    max(err_gen.values()), gen_times,
                    time_ms(lambda: ck.generate_contacts_plain(*args), reps=5, warmup=1, flush=flush),
                    ck.flops(args[7]), nbytes)
        print(f"times: contact_gen {'; '.join(gen_line)}", flush=True)
        t_rows, t_rkw = capture.tactile_packed(t_args, t_kw)
        noise_kw = dict(generator=insertion.make_generator(9, dev), noise_std=0.01)
        r, p = t_rows[0].shape[0], t_rows[1].shape[1]
        row("tactile_render", "tactile_render.cu", "isaacgyminsertion_tpu/sensors/render_pallas.py:90",
            max(errs[("tactile", "env state")], errs[("tactile", "one env")], errs[("tactile", "gathered")]),
            times_ms(lambda: rk.tactile_rows_cuda(*t_rows, **t_rkw, **noise_kw), reps=30, flush=flush),
            time_ms(lambda: rk.tactile_rows_plain(*t_rows, **t_rkw, **noise_kw), reps=5, warmup=1,
                    flush=flush),
            rk.tactile_flops(t_rows[0], p, exact=True, noise_kind="gauss"), rk.tactile_bytes_moved(r, p))
        c_rows, c_rkw = capture.camera_packed(c_args, c_kw)
        n, p = c_rows[0].shape[0], c_rows[1].shape[1]
        row("camera_render", "camera_render.cu", "isaacgyminsertion_tpu/sensors/render_pallas.py:388",
            max(errs[("camera", "env state")], errs[("camera", "one env")], errs[("camera", "gathered")]),
            times_ms(lambda: rk.camera_rows_cuda(*c_rows, **c_rkw), reps=30, flush=flush),
            time_ms(lambda: rk.camera_rows_plain(*c_rows, **c_rkw), reps=5, warmup=1, flush=flush),
            rk.camera_flops(c_rows[0], p, exact=True), rk.camera_bytes_moved(n, p))
        cr_rows, cr_rkw = capture.camera_packed(cr_args, cr_kw)
        cr_times = times_ms(lambda: rk.camera_rows_cuda(*cr_rows, **cr_rkw), reps=30, flush=flush)
        print(f"times: camera_render random scene {cr_rows[0].shape[0]} envs x {cr_rows[1].shape[1]} px "
              f"{statistics.median(cr_times):.4f} ms ({capture.spread(cr_times)})", flush=True)
    del flush
    if opts.kernels_only:
        print(json.dumps({"kernels": kernel_rows}), flush=True)
        print("kernels only: the main paths were skipped, no result line", flush=True)
        return

    # ------------------------------------------- 4-6, 8-17. the main paths
    del real_args, train_args, student_args, rand_args, s_state, s_out, gen_sets
    torch.cuda.empty_cache()
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_work_") as work:
        units = _run_units(work)
    for p in PHASES:
        for u in units.values():
            results.update(u["phases"].get(p, {}))
    err_rotate = units["rotating plug and CycleGAN"]["extra"]["tactile_err"]
    err_bench = units["bench"]["extra"]["bench_render_err"]
    for r in kernel_rows:
        if r["name"] == "tactile_render":
            r["max_abs_err"] = max(r["max_abs_err"], err_rotate)
        r["max_abs_err"] = max(r["max_abs_err"], err_bench.get(r["name"], 0.0))
        r["launches"] = sum(results[p][r["name"]] for p in results)
    fps_single = units["teacher training, grasp resets, sys-id"]["extra"]["train_fps"]
    print(f"sharded training: {units['sharded training']['extra']['sharded_fps']:.1f} env-steps/s summed over 2 "
          f"ranks x {SHARD_ENVS // 2} envs on one card, beside phase 8's single process at {TRAIN_ENVS} envs "
          f"{[round(v, 1) for v in fps_single]} (same run; both shared the card with the other units)", flush=True)
    print(f"launches by path: {json.dumps(results)}; {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        _fail("a phase raised")
