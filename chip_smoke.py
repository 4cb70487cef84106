#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # everything; the last line is {"ok": true, ...}
    python3 chip_smoke.py --kernels-only   # phases 1-3 and 7, no result line

Phases, in order; any failure exits nonzero without printing a result:
  1. device and precision: CUDA present, card name and power limit, TF32 off;
  2. build every hand-written kernel from the sources in this checkout (one
     nvcc per source, all started together), with ptxas' register counts;
  3. each kernel against its plain PyTorch version on the card:
     - contact_solver at N = 1024 envs, C = 255 contacts: a random contact set
       and one captured from a real env substep, at the reference's
       fused-vs-XLA solver tolerances;
     - tactile_render (R = 768 rows × 4096 pixels) and camera_render (N = 256
       envs × 5184 pixels), closed-form variant: inputs captured from a
       sensors-on env a few steps after reset, and one random set; the march
       variant at a small shape. Noise off: fails if any output is not
       finite or more than 0.5 % of the pixels differ by more than 1e-3
       (silhouette flips); component ids equal off those pixels. Noise on
       (both kinds): outputs finite and in [0, 1], residual against the
       noise-off image (lit pixels away from the clip) with mean within
       ±1e-3 of 0 and std within 5 % of 0.01;
  4. main path, teacher: the teacher eval CLI with the banked r2b teacher at
     1024 envs for one 500-step episode (3 solver launches per control step,
     success must reach 0.5);
  5. main path A, student_r5: the student eval CLI with the arguments of
     scripts/eval_s2.sh (obs + point cloud, 6-dim action head) at 256 envs
     for one 500-step episode: 500 camera launches, 1,500 solver launches, no
     tactile launch; success must reach 0.12 (the JAX package measured 0.2539);
  6. main path B, student_r3 (tactile + seg + point cloud, latent injected
     into the frozen actor) at 256 envs: one tactile and one camera launch per
     control step, every image finite and in range; then 50 steps with
     render_capacity=0.75 to drive the gathered render-on-demand path;
  7. times: each kernel and its plain version on CUDA events, beside the
     least time the card could take (bytes or f32 operations at the published
     H100 SXM peaks). The renderers are timed on packed rows with the L2 cache
     flushed before each launch.
Launch counts are zeroed just before each main path and read just after. The
line before the last is a JSON object listing every ported kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "isaacgyminsertion_tpu_torch"
CHECKPOINT = os.path.join(ROOT, "checkpoints", "teacher_r2b", "best_success")
STUDENT_R5 = os.path.join(ROOT, "checkpoints", "student_r5", "best_success")
STUDENT_R3 = os.path.join(ROOT, "checkpoints", "student_r3", "best_success")
N_ENVS = 1024
STUDENT_ENVS = 256
R5_REFERENCE = 0.2539   # the JAX package's 256-env eval of student_r5 (trial std 0.02-0.034)
R5_FLOOR = 0.12
PATH_B_STEPS = 500
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


class PhaseError(RuntimeError):
    pass


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _cuda_time_ms(fn, reps, warmup=3, flush=None):
    """Mean time of fn on CUDA events. With `flush` (a large tensor) the L2
    cache is overwritten before every timed call and each call is timed alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def _compare(name, out, ref):
    """Hold the solver kernel to its plain version at the reference's
    fused-vs-XLA solver tolerances (summation order differs; 16 iterations
    with discontinuous friction-cone projections grow fp deltas to ~1e-3)."""
    import numpy as np

    tol = dict(v=(2e-3, 2e-3), w=(5e-3, 2e-2), lam_n=(2e-3, 1e-4), lam_t=(5e-3, 1e-3),
               dx=(2e-3, 1e-5), dth=(5e-3, 1e-3))
    worst = 0.0
    for field, (rtol, atol) in tol.items():
        a = getattr(out, field).detach().cpu().numpy()
        b = getattr(ref, field).detach().cpu().numpy()
        if not np.isfinite(a).all():
            raise PhaseError(f"{name}: kernel output {field} is not finite")
        err = np.abs(a - b)
        bad = err > atol + rtol * np.abs(b)
        if bad.any():
            i = np.unravel_index(np.argmax(err - (atol + rtol * np.abs(b))), err.shape)
            raise PhaseError(f"{name}: {field} differs at {i}: kernel {a[i]} vs plain {b[i]} "
                             f"({int(bad.sum())} of {bad.size} outside rtol {rtol}, atol {atol})")
        worst = max(worst, float(err.max()))
    return worst


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


def _sensor_inputs(cfg, model, state):
    """(args, kwargs) of the two renderers for an env state, as the env's
    sensor step builds them for the whole batch."""
    from isaacgyminsertion_tpu_torch.physics import engine
    from isaacgyminsertion_tpu_torch.physics.kinematics import forward_kinematics, site_pose
    from isaacgyminsertion_tpu_torch.physics.robot import SITE_FINGERTIP_CENTERED
    from isaacgyminsertion_tpu_torch.sensors import camera as cam_mod
    from isaacgyminsertion_tpu_torch.sensors import tactile as tact_mod

    phys, p = state.phys, state.params
    fk = forward_kinematics(model, phys.q)
    tip_q, tip_t = engine.fingertip_poses(model, fk)
    _, ftc_t = site_pose(model, fk, SITE_FINGERTIP_CENTERED)
    wrist = fk.body_t[..., 6, :]
    tact = tact_mod.render_inputs(
        tact_mod.TactileConfig(), tip_q, tip_t, phys.plug_quat, phys.plug_pos, p.kind_onehot,
        p.plug_hx * p.plug_scale, p.plug_hy * p.plug_scale, p.plug_length * p.plug_scale,
        state.finger_forces_ema)
    cam = cam_mod.render_inputs(
        cam_mod.CameraConfig(), phys.plug_quat, phys.plug_pos, p.socket_quat, p.socket_pos,
        p.kind_onehot, p.plug_hx, p.plug_hy, p.plug_length, p.hole_hx, p.hole_hy, p.socket_height,
        p.table_height, tip_pos=tip_t, wrist_pos=wrist, hand_pos=ftc_t + 0.55 * (wrist - ftc_t),
        tip_radius=0.012, hand_radius=0.032)
    return tact, cam


def _random_scene(n, seed, dev):
    """Random tactile and camera scenes (numpy seed) in the style of the
    reference's render parity tests → the two renderers' (args, kwargs)."""
    import numpy as np
    import torch

    from isaacgyminsertion_tpu_torch.sensors import camera as cam_mod
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk
    from isaacgyminsertion_tpu_torch.sensors import tactile as tact_mod

    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    tact = tact_mod.render_inputs(tact_mod.TactileConfig(),
                                  *[T(a) for a in rk.random_tactile_inputs(n, seed)])
    cargs, ckw = rk.random_camera_inputs(n, seed)
    cam = cam_mod.render_inputs(cam_mod.CameraConfig(), *[T(a) for a in cargs],
                                **{k: (T(v) if hasattr(v, "shape") else v) for k, v in ckw.items()})
    return tact, cam


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, compare and time the kernels; skip the main paths (no result line)")
    opts = ap.parse_args()
    import torch

    # ---------------------------------------------------------------- 1. device
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
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}", flush=True)
    print(f"precision: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)

    import dataclasses

    from isaacgyminsertion_tpu_torch import cli
    from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.physics import engine
    from isaacgyminsertion_tpu_torch.physics import solver_kernel as sk
    from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
    from isaacgyminsertion_tpu_torch.physics.solver import ContactSet
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk
    from isaacgyminsertion_tpu_torch.utils.cuda_build import build_all

    # ---------------------------------------------------------------- 2. build
    kernels_src = [sk.KERNEL, rk.TACTILE_KERNEL, rk.CAMERA_KERNEL]
    t0 = time.perf_counter()
    build_all(kernels_src)
    print(f"build: {len(kernels_src)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for k in kernels_src:
        print(f"build: {k.name} {k.info['seconds']:.2f} s "
              f"({'cached' if k.info.get('cached') else 'nvcc'}); {'; '.join(k.registers())}", flush=True)

    # ------------------------------------------------------ 3. kernel vs plain
    mass, I_inv, v, w, cs = sk.random_problem(N_ENVS, 255, seed=0)
    T = lambda a: torch.as_tensor(a, device=dev)
    rand_args = (T(mass), T(I_inv), T(v), T(w), ContactSet(**{k: T(x) for k, x in cs.items()}))
    out = sk.solve_contacts_fused_cuda(*rand_args, H)
    torch.cuda.synchronize()
    err_rand = _compare("random contacts", out, sk.solve_contacts_fused_plain(*rand_args, H))

    cfg = default_task_config()
    model, subs = build_kuka_openhand(), build_subassembly_set()
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, dev), N_ENVS)
        ctrl = engine.ControlInput(q_target=state.phys.q, tau_cmd=torch.zeros_like(state.phys.q),
                                   torque_mode_mask=torch.zeros((15,), device=dev),
                                   plug_wrench=torch.zeros((N_ENVS, 6), device=dev))
        real_args = engine.contact_problem(model, state.params, state.phys, ctrl, H)
    out = sk.solve_contacts_fused_cuda(*real_args, H)
    torch.cuda.synchronize()
    err_real = _compare("env contacts", out, sk.solve_contacts_fused_plain(*real_args, H))
    n_act = int((real_args[4].depth > 0).sum())
    print(f"kernel vs plain: contact_solver N={N_ENVS} C={real_args[4].depth.shape[1]}: "
          f"random max_abs_err {err_rand:.3e}, env substep max_abs_err {err_real:.3e} "
          f"({n_act} of {real_args[4].depth.numel()} contacts active)", flush=True)

    # the renderers: a sensors-on env a few steps after reset (the pads press on the plug)
    cfg_s = cfg.replace(env=dataclasses.replace(cfg.env, tactile=True, external_cam=True,
                                                seg_cam=True, pcl_cam=True))
    with torch.no_grad():
        gen = insertion.make_generator(1, dev)
        s_state = insertion.reset_all(cfg_s, model, subs, gen, STUDENT_ENVS)
        for _ in range(3):
            s_state, s_out = insertion.step(cfg_s, model, subs, s_state,
                                            torch.zeros((STUDENT_ENVS, 6), device=dev), gen)
        (t_args, t_kw), (c_args, c_kw) = _sensor_inputs(cfg_s, model, s_state)
        (tr_args, tr_kw), (cr_args, cr_kw) = _random_scene(STUDENT_ENVS, 7, dev)
        (tm_args, tm_kw), (cm_args, cm_kw) = _random_scene(8, 11, dev)

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

    kernel_rows = []
    results = {}
    if not opts.kernels_only:
        def counts_zero():
            sk.launch_count = 0
            rk.tactile_launch_count = 0
            rk.camera_launch_count = 0

        def counts():
            return dict(contact_solver=sk.launch_count, tactile_render=rk.tactile_launch_count,
                        camera_render=rk.camera_launch_count)

        def run(label, argv, n, steps):
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

        # ------------------------------------------------------ 4. teacher path
        steps = cfg.rl.max_episode_length
        success, c = run("r2b teacher eval", ["train.algo=PPO", "test=True", f"checkpoint={CHECKPOINT}",
                                              f"num_envs={N_ENVS}"], N_ENVS, steps)
        if c != dict(contact_solver=cfg.sim.substeps * steps, tactile_render=0, camera_render=0):
            raise PhaseError(f"teacher path launches {c}, expected {cfg.sim.substeps * steps} solver "
                             f"launches (3 per control step) and no renderer launch")
        if not success >= 0.5:
            raise PhaseError(f"r2b success {success:.4f} < 0.5")
        results["teacher"] = c

        # ------------------------------------------------- 5. path A, student_r5
        success, c = run("student_r5 eval (obs + pcl, action head)",
                         EVAL_S2_ARGS + [f"checkpoint={CHECKPOINT}", f"student_checkpoint={STUDENT_R5}",
                                         f"task.env.numEnvs={STUDENT_ENVS}"], STUDENT_ENVS, steps)
        print(f"main path: student_r5 success {success:.4f} beside the JAX package's {R5_REFERENCE} "
              f"(256 envs; trial std 0.02-0.034)", flush=True)
        if c != dict(contact_solver=cfg.sim.substeps * steps, tactile_render=0, camera_render=steps):
            raise PhaseError(f"path A launches {c}, expected camera_render {steps}, contact_solver "
                             f"{cfg.sim.substeps * steps}, tactile_render 0")
        if not success >= R5_FLOOR:
            raise PhaseError(f"student_r5 success {success:.4f} < {R5_FLOOR}")
        results["A"] = c

        # ------------------------------------------------- 6. path B, student_r3
        b_args = R3_ARGS + [f"checkpoint={CHECKPOINT}", f"student_checkpoint={STUDENT_R3}",
                            f"task.env.numEnvs={STUDENT_ENVS}"]
        success, c = run("student_r3 eval (tactile + seg + pcl, latent injection)",
                         b_args + [f"task.rl.max_episode_length={PATH_B_STEPS}"], STUDENT_ENVS,
                         PATH_B_STEPS)
        if c != dict(contact_solver=cfg.sim.substeps * PATH_B_STEPS, tactile_render=PATH_B_STEPS,
                     camera_render=PATH_B_STEPS):
            raise PhaseError(f"path B launches {c}, expected one tactile and one camera launch per "
                             f"control step ({PATH_B_STEPS})")
        results["B"] = c
        success, c = run("student_r3 eval, render_capacity 0.75 (gathered renders)",
                         b_args + ["task.env.render_capacity=0.75", "task.rl.max_episode_length=50"],
                         STUDENT_ENVS, 50)
        if c != dict(contact_solver=cfg.sim.substeps * 50, tactile_render=50, camera_render=50):
            raise PhaseError(f"gathered path launches {c}, expected 50 of each renderer")
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

    # ------------------------------------------------------------------ 7. times
    def bound(flop, nbytes):
        t_ops, t_bytes = flop / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes

    def row(name, source, replaces, launches, err, ms, plain_ms, flop, nbytes):
        b_ms, by, t_ops, t_bytes = bound(flop, nbytes)
        print(f"times: {name} {ms:.4f} ms, plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {by} "
              f"({flop / 1e9:.3f} GFLOP -> {t_ops:.4f} ms, {nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms)",
              flush=True)
        kernel_rows.append(dict(name=name, route="cuda", source=f"{PACKAGE}/csrc/{source}",
                                replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None))

    launches = {k: sum(results[p][k] for p in results) for k in ("contact_solver", "tactile_render",
                                                                  "camera_render")} if results else {}
    with torch.no_grad():
        n, c = real_args[4].depth.shape
        row(sk.KERNEL_NAME, "contact_solver.cu", "isaacgyminsertion_tpu/physics/solver_pallas.py:40",
            launches.get("contact_solver", 0), err_real,
            _cuda_time_ms(lambda: sk.solve_contacts_fused_cuda(*real_args, H), reps=50),
            _cuda_time_ms(lambda: sk.solve_contacts_fused_plain(*real_args, H), reps=5, warmup=1),
            sk.flops(n, c), sk.bytes_moved(n, c))
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)   # 1 GB: 20 x L2
        t_rows = rk.tactile_rows(*t_args, mask_flat=t_kw["mask_flat"])
        t_rkw = {k: v for k, v in t_kw.items() if k != "mask_flat"}
        noise_kw = dict(generator=insertion.make_generator(9, dev), noise_std=0.01)
        r, p = t_rows[0].shape[0], t_rows[1].shape[1]
        row("tactile_render", "tactile_render.cu", "isaacgyminsertion_tpu/sensors/render_pallas.py:90",
            launches.get("tactile_render", 0), errs[("tactile", "env state")],
            _cuda_time_ms(lambda: rk.tactile_rows_cuda(*t_rows, **t_rkw, **noise_kw), reps=30, flush=flush),
            _cuda_time_ms(lambda: rk.tactile_rows_plain(*t_rows, **t_rkw, **noise_kw), reps=5, warmup=1,
                          flush=flush),
            rk.tactile_flops(r, p, exact=True, noise_kind="gauss"), rk.tactile_bytes_moved(r, p))
        c_rows = rk.camera_rows(*c_args, tips_cam=c_kw["tips_cam"], wrist_cam=c_kw["wrist_cam"],
                                hand_cam=c_kw["hand_cam"])
        c_rkw = {k: v for k, v in c_kw.items() if k not in ("tips_cam", "wrist_cam", "hand_cam")}
        n, p = c_rows[0].shape[0], c_rows[1].shape[1]
        row("camera_render", "camera_render.cu", "isaacgyminsertion_tpu/sensors/render_pallas.py:388",
            launches.get("camera_render", 0), errs[("camera", "env state")],
            _cuda_time_ms(lambda: rk.camera_rows_cuda(*c_rows, **c_rkw), reps=30, flush=flush),
            _cuda_time_ms(lambda: rk.camera_rows_plain(*c_rows, **c_rkw), reps=5, warmup=1, flush=flush),
            rk.camera_flops(n, p, exact=True), rk.camera_bytes_moved(n, p))
    if opts.kernels_only:
        print(json.dumps({"kernels": kernel_rows}), flush=True)
        print("kernels only: the main paths were skipped, no result line", flush=True)
        return
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
