"""Kernel inputs as the env produces them, for checks and timings on the card.

`chip_smoke.py` and `kernel_ablation.py` hold each hand-written kernel against
its plain version, and time it, on what the main path gives it: a contact
problem captured from a real physics substep, and the two renderers' arguments
captured from a sensors-on env a few steps after reset. Random scenes in the
style of the reference's render parity tests come from here too.
"""

from __future__ import annotations

import dataclasses
from statistics import median

import numpy as np
import torch

from ..envs import insertion
from ..physics import engine
from ..physics.kinematics import forward_kinematics, site_pose
from ..physics.robot import SITE_FINGERTIP_CENTERED
from ..sensors import camera as cam_mod
from ..sensors import render_kernels as rk
from ..sensors import tactile as tact_mod
from .checkpoint import tree_map


def substep_problem(cfg, model, subs, n: int, h: float, dev, seed: int = 0):
    """The contact solver's arguments (mass, I_inv, v, w, ContactSet) on the
    first substep after a reset of `n` envs with a hold-still control."""
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, insertion.make_generator(seed, dev), n)
    return contact_problem_of(model, state, h)


def contact_problem_of(model, state, h: float):
    """The contact solver's arguments on the next substep of an env state
    under a hold-still control."""
    q = state.phys.q
    with torch.no_grad():
        ctrl = engine.ControlInput(q_target=q, tau_cmd=torch.zeros_like(q),
                                   torque_mode_mask=torch.zeros((15,), device=q.device),
                                   plug_wrench=torch.zeros((q.shape[0], 6), device=q.device))
        return engine.contact_problem(model, state.params, state.phys, ctrl, h)


def active_counts(cs) -> torch.Tensor:
    """[N] contacts per env that the solver has to solve (depth > 0 and
    weight != 0); every other contact is inert."""
    return ((cs.depth > 0) & (cs.weight != 0)).sum(dim=1)


def sensors_on(cfg):
    """`cfg` with the tactile pads and the three camera outputs on."""
    return cfg.replace(env=dataclasses.replace(cfg.env, tactile=True, external_cam=True,
                                               seg_cam=True, pcl_cam=True))


def sensor_state(cfg_s, model, subs, n: int, dev, steps: int = 3, seed: int = 1):
    """A sensors-on env `steps` zero-action steps after reset (the pads press on
    the plug) → (state, last step's output, generator)."""
    with torch.no_grad():
        gen = insertion.make_generator(seed, dev)
        state = insertion.reset_all(cfg_s, model, subs, gen, n)
        out = None
        for _ in range(steps):
            state, out = insertion.step(cfg_s, model, subs, state,
                                        torch.zeros((n, 6), device=dev), gen)
    return state, out, gen


def sensor_inputs(model, state):
    """(args, kwargs) of the two renderers for an env state, as the env's
    sensor step builds them for the whole batch."""
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


def rank_selections(n_rank: int, world: int, capacity: float, dev, seed: int = 0, steps: int = 64):
    """The rows each rank renders on the sharded render-on-demand path of a
    group of `world` ranks of `n_rank` envs each: `render_selection` over the
    gathered priorities (drawn from {0, 1, 2}), each rank taking the selected
    rows it owns, at global steps 0, 1, ... → per step, one tensor of local
    rows a rank."""
    n = n_rank * world
    prio = torch.randint(0, 3, (n,), generator=insertion.make_generator(seed, dev), device=dev)
    out = []
    for step in range(steps):
        sel = insertion.render_selection(prio, capacity, step)
        out.append([sel[(sel >= r * n_rank) & (sel < (r + 1) * n_rank)] - r * n_rank for r in range(world)])
    return out


def env_rows(state, rows):
    """The env state's rows `rows` (every leaf with a leading env axis)."""
    return tree_map(lambda x: x[rows] if x.ndim else x, state)


def random_scene(n: int, seed: int, dev):
    """Random tactile and camera scenes (numpy seed) in the style of the
    reference's render parity tests → the two renderers' (args, kwargs)."""
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    tact = tact_mod.render_inputs(tact_mod.TactileConfig(),
                                  *[T(a) for a in rk.random_tactile_inputs(n, seed)])
    cargs, ckw = rk.random_camera_inputs(n, seed)
    cam = cam_mod.render_inputs(cam_mod.CameraConfig(), *[T(a) for a in cargs],
                                **{k: (T(v) if hasattr(v, "shape") else v) for k, v in ckw.items()})
    return tact, cam


def tactile_packed(t_args, t_kw):
    """Packed rows and the remaining keywords of a tactile (args, kwargs) pair,
    as `tactile_rows_cuda` and `tactile_rows_plain` take them."""
    rows = rk.tactile_rows(*t_args, mask_flat=t_kw["mask_flat"])
    return rows, {k: v for k, v in t_kw.items() if k != "mask_flat"}


def camera_packed(c_args, c_kw):
    """Packed rows and the remaining keywords of a camera (args, kwargs) pair."""
    proxy = ("tips_cam", "wrist_cam", "hand_cam")
    rows = rk.camera_rows(*c_args, **{k: c_kw[k] for k in proxy})
    return rows, {k: v for k, v in c_kw.items() if k not in proxy}


_PROXY = ("tips_cam", "wrist_cam", "hand_cam")


def camera_edge_cases(dev):
    """The scenes on whose edges the camera kernel branches, as packed rows →
    [(label, scal, rays for the kernel, rays for the plain version, keywords)]:
    one env per section family with the robot proxy in view (a capsule across
    the plug, a fingertip wholly behind the camera) and parked, tilted frames,
    a pixel count that is not a multiple of 4 and a ray table 4 bytes off
    16-byte alignment (both take the kernel's scalar loads and stores)."""
    T = lambda a: torch.as_tensor(a, device=dev)
    cases = []
    for label, n, proxy, tilt, pixels in (
            ("six families, proxy in view", 6, True, 0.0, None),
            ("six families, proxy parked", 6, False, 0.0, None),
            ("six families x2, tilted frames, proxy in view", 12, True, 0.1, None),
            ("P = 383, not a multiple of 4", 6, True, 0.0, 383)):
        args, kw = rk.camera_edge_inputs(n, proxy=proxy, tilt=tilt)
        args = [T(a) for a in args]
        args[14] = args[14][:pixels].contiguous()
        scal, rays = rk.camera_rows(*args, **{k: (T(kw[k]) if k in kw else None) for k in _PROXY})
        rest = {k: v for k, v in kw.items() if k not in _PROXY}
        cases.append((label, scal, rays, rays, rest))
    _, scal, rays, _, rest = cases[0]
    buf = torch.zeros(rays.numel() + 1, device=dev)
    buf[1:].copy_(rays.reshape(-1))
    cases.append(("ray table 4 bytes off 16-byte alignment", scal, buf[1:].view(rays.shape), rays, rest))
    return cases


SPIN_CYCLES = 1_000_000   # ~0.5 ms of a spin kernel that touches no memory


def cuda_times_ms(fn, reps: int, warmup: int = 3, flush=None) -> list:
    """The times of `reps` calls of fn on CUDA events, each call timed alone,
    sorted.

    Before every timed call the device is kept busy, so that the host has
    queued the start event, the call and the end event before the device
    reaches them and the host's launch latency stays out of the time (a
    wrapper takes tens of microseconds on the host, more than a short kernel
    takes on the card). With `flush` (a tensor larger than the L2 cache) the
    busy work overwrites it and the call finds the cache cold; without, it is a
    spin kernel that touches no memory and the cache stays warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is None:
            torch.cuda._sleep(SPIN_CYCLES)
        else:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)


def cuda_time_ms(fn, reps: int, warmup: int = 3, flush=None) -> float:
    """The median of `cuda_times_ms`: one slow launch does not move it."""
    return median(cuda_times_ms(fn, reps, warmup, flush))


def spread(times) -> str:
    """min / median / p90 / max of sorted times, for a log line."""
    p90 = times[min(len(times) - 1, int(0.9 * len(times)))]
    return (f"min {times[0]:.4f} median {median(times):.4f} p90 {p90:.4f} max {times[-1]:.4f} ms "
            f"over {len(times)} launches")


# The reference's fused-vs-XLA solver tolerances (rtol, atol) per output: the
# summation order differs, and 16 iterations with discontinuous friction-cone
# projections grow fp deltas to ~1e-3.
SOLVER_TOL = dict(v=(2e-3, 2e-3), w=(5e-3, 2e-2), lam_n=(2e-3, 1e-4), lam_t=(5e-3, 1e-3),
                  dx=(2e-3, 1e-5), dth=(5e-3, 1e-3))


def solver_errors(out, ref):
    """Solver kernel vs plain → (largest abs error, [(field, elements outside
    its tolerance, size, worst index, kernel value, plain value)], finite)."""
    worst, bad, finite = 0.0, [], True
    for field, (rtol, atol) in SOLVER_TOL.items():
        a = getattr(out, field).detach().cpu().numpy()
        b = getattr(ref, field).detach().cpu().numpy()
        finite = finite and bool(np.isfinite(a).all())
        err = np.abs(a - b)
        over = err - (atol + rtol * np.abs(b))
        n_bad = int((over > 0).sum())
        if n_bad:
            i = np.unravel_index(np.argmax(over), err.shape)
            bad.append((field, n_bad, err.size, tuple(int(x) for x in i), float(a[i]), float(b[i])))
        worst = max(worst, float(np.nanmax(err)))
    return worst, bad, finite
