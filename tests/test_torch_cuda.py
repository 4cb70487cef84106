"""Card-only tests of the port (marker `cuda`): each hand-written kernel (the
contact solver, the tactile and the camera renderer) against its plain PyTorch
version, alone and inside an engine or env step, PPO and DAgger learning on a
fixed seed and budget, and the teacher-data collection's launches and files.
They skip without a GPU. This file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea
from isaacgyminsertion_tpu_torch.algo import ppo
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import insertion
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.models.actor_critic import actor_critic_from_jax_params
from isaacgyminsertion_tpu_torch.models.running_mean_std import rms_to
from isaacgyminsertion_tpu_torch.physics import engine
from isaacgyminsertion_tpu_torch.physics import solver_kernel as sk
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
from isaacgyminsertion_tpu_torch.physics.solver import ContactSet
from isaacgyminsertion_tpu_torch.sensors import camera as cam_mod
from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk
from isaacgyminsertion_tpu_torch.sensors import tactile as tact_mod
from isaacgyminsertion_tpu_torch.utils import capture, profiling
from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

H = 1.0 / 180.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _assert_solver_tolerances(out, ref):
    """The reference's fused-vs-XLA solver tolerances: summation order
    differs; 16 iterations with discontinuous friction-cone projections grow
    fp deltas to ~1e-3."""
    a = lambda x: x.detach().cpu().numpy()
    np.testing.assert_allclose(a(out.v), a(ref.v), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(a(out.w), a(ref.w), rtol=5e-3, atol=2e-2)
    np.testing.assert_allclose(a(out.lam_n), a(ref.lam_n), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(a(out.lam_t), a(ref.lam_t), rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(a(out.dx), a(ref.dx), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(a(out.dth), a(ref.dth), rtol=5e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(5, 20), (5, 37), (64, 100), (1024, 255)])
def test_cuda_kernel_matches_plain(cuda_device, n, c):
    mass, I_inv, v, w, cs = sk.random_problem(n, c, seed=6)
    T = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (T(mass), T(I_inv), T(v), T(w), ContactSet(**{k: T(x) for k, x in cs.items()}))
    before = profiling.launches()["contact_solver"]
    out = sk.solve_contacts_fused(*args, H)
    torch.cuda.synchronize()
    assert profiling.launches()["contact_solver"] == before + 1
    _assert_solver_tolerances(out, sk.solve_contacts_fused_plain(*args, H))


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    mass, I_inv, v, w, cs = sk.random_problem(2, 300, seed=0)
    T = lambda x: torch.as_tensor(x, device=cuda_device)
    with pytest.raises(ValueError):   # more contacts than a warp holds
        sk.solve_contacts_fused(T(mass), T(I_inv), T(v), T(w),
                                ContactSet(**{k: T(x) for k, x in cs.items()}), H)
    mass, I_inv, v, w, cs = sk.random_problem(2, 10, seed=0)
    with pytest.raises(TypeError):    # float64
        sk.solve_contacts_fused(T(mass).double(), T(I_inv), T(v), T(w),
                                ContactSet(**{k: T(x) for k, x in cs.items()}), H)


@pytest.mark.cuda
def test_engine_step_on_the_card_matches_the_cpu(cuda_device):
    """One engine step from the same reset state: CUDA tensors (kernel) vs CPU
    tensors (plain version), 1e-4 as for the engine parity test."""
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    with torch.no_grad():
        s = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, "cpu"), 8)
        ctrl = engine.ControlInput(q_target=s.phys.q + 0.01, tau_cmd=torch.zeros_like(s.phys.q),
                                   torque_mode_mask=torch.zeros(15), plug_wrench=torch.zeros((8, 6)))
        to = lambda tree: type(tree)(*[to(x) if isinstance(x, tuple) else x.to(cuda_device)
                                       for x in tree])
        before = profiling.launches()
        p_gpu = engine.step(model, to(s.params), to(s.phys), to(ctrl))
        torch.cuda.synchronize()
        after = profiling.launches()
        for k in ("contact_solver", "contact_gen"):   # one generation and one solve a substep
            assert after[k] == before[k] + cfg.sim.substeps, k
        p_cpu = engine.step(model, s.params, s.phys, ctrl)
    for f in ("q", "plug_pos", "plug_quat"):
        np.testing.assert_allclose(getattr(p_gpu, f).cpu().numpy(), getattr(p_cpu, f).numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    for f in ("qd", "plug_v", "plug_w", "tip_forces", "tip_fn"):
        np.testing.assert_allclose(getattr(p_gpu, f).cpu().numpy(), getattr(p_cpu, f).numpy(),
                                   rtol=1e-4, atol=1e-3, err_msg=f)


def _assert_images(out, ref):
    """Renderer kernel vs plain, noise off: the two round differently (fused
    multiply-adds), so a silhouette pixel may flip; fewer than 0.5 % may differ
    by more than 1e-3, and the rest agree to 2e-4."""
    assert bool(torch.isfinite(out).all())
    err = (out - ref).abs()
    flipped = err > 1e-3
    assert float(flipped.float().mean()) < 5e-3
    assert float(err[~flipped].max()) < 2e-4
    return flipped


def _tactile_scene(n, seed, device):
    args = [torch.as_tensor(a, device=device) for a in rk.random_tactile_inputs(n, seed)]
    return tact_mod.render_inputs(tact_mod.TactileConfig(), *args)


def _camera_scene(n, seed, device):
    args, kw = rk.random_camera_inputs(n, seed)
    T = lambda a: torch.as_tensor(a, device=device)
    return cam_mod.render_inputs(cam_mod.CameraConfig(), *[T(a) for a in args],
                                 **{k: (T(v) if hasattr(v, "shape") else v) for k, v in kw.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("n,exact", [(2, True), (7, True), (256, True), (7, False)])
def test_tactile_kernel_matches_plain(cuda_device, n, exact):
    args, kw = _tactile_scene(n, 3, cuda_device)
    before = profiling.launches()["tactile_render"]
    out = rk.tactile_render(*args, **kw, exact=exact)
    torch.cuda.synchronize()
    assert profiling.launches()["tactile_render"] == before + 1
    assert tuple(out.shape) == (3 * n, 4096, 3)
    assert float((out > 0.01).float().mean()) > 0.01      # the pads do see the plug
    _assert_images(out, rk.tactile_render_plain(*args, **kw, exact=exact))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauss", "ih4"])
def test_tactile_kernel_noise(cuda_device, kind):
    """In-kernel Philox noise: finite, clipped to [0, 1], mean 0 and std 0.01
    on lit pixels away from the clip, new numbers for a new seed, the same
    numbers for the same seed."""
    args, kw = _tactile_scene(64, 4, cuda_device)
    clean = rk.tactile_render(*args, **kw)
    draw = lambda seed: rk.tactile_render(*args, **kw, noise_std=0.01, noise_kind=kind,
                                          generator=insertion.make_generator(seed, cuda_device))
    a, b, a2 = draw(1), draw(2), draw(1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    interior = (clean > 0.06) & (clean < 0.94)
    resid = (a - clean)[interior]
    assert abs(float(resid.mean())) < 1e-3 and abs(float(resid.std()) - 0.01) < 5e-4
    assert bool((a == a2).all()) and not bool((a == b).all())
    # neighbouring pixels and the three colour planes are uncorrelated
    r = (a - clean)[interior.all(-1)]
    assert abs(float(torch.corrcoef(r.T)[0, 1])) < 0.02


_EDGE_CASES = 5   # capture.camera_edge_cases


@pytest.mark.cuda
@pytest.mark.parametrize("scene,n,exact",
                         [("random", 1, True), ("random", 6, True), ("random", 256, True), ("random", 6, False)]
                         + [(f"edge{k}", 0, True) for k in range(_EDGE_CASES)] + [("edge0", 0, False)])
def test_camera_kernel_matches_plain(cuda_device, scene, n, exact):
    """Random scenes through the dispatching wrapper, and the scenes the exact
    kernel branches on (`capture.camera_edge_cases`: every section family, the
    proxy in view and parked, tilted frames, P not a multiple of 4, a ray
    table off 16-byte alignment) through the packed-row wrapper."""
    before = profiling.launches()["camera_render"]
    if scene == "random":
        args, kw = _camera_scene(n, 5, cuda_device)
        kt, kd, kc = rk.camera_render(*args, **kw, exact=exact)
        pt, pd, pc = rk.camera_render_plain(*args, **kw, exact=exact)
    else:
        _, scal, k_rays, rays, kw = capture.camera_edge_cases(cuda_device)[int(scene[4:])]
        kt, kd, kc = rk.camera_rows_cuda(scal, k_rays, **kw, exact=exact)
        pt, pd, pc = rk.camera_rows_plain(scal, rays, **kw, exact=exact)
    torch.cuda.synchronize()
    assert profiling.launches()["camera_render"] == before + 1
    flipped = _assert_images(kt, pt)
    assert float(((kc != pc) & ~flipped).float().mean()) < 1e-4
    if exact:
        assert float(((kd != pd) & ~flipped).float().mean()) < 1e-4
    else:
        _assert_images(kd, pd)


@pytest.mark.cuda
def test_render_kernels_refuse_what_they_do_not_take(cuda_device):
    args, kw = _tactile_scene(2, 0, cuda_device)
    with pytest.raises(TypeError):    # float64
        rk.tactile_render(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):   # a tensor left on the CPU
        rk.tactile_render(args[0], args[1].cpu(), *args[2:], **kw)
    cargs, ckw = _camera_scene(2, 0, cuda_device)
    with pytest.raises(ValueError):   # wrong shape
        rk.camera_render(cargs[0][:, :2], *cargs[1:], **ckw)


@pytest.mark.cuda
def test_sensor_step_on_the_card_matches_the_cpu(cuda_device):
    """Three sensors-on env steps from one reset, CUDA tensors (kernels) vs CPU
    tensors (plain versions); noise and delays off. Depth, seg and the tactile
    image agree off the silhouette pixels; each renderer launches once per step."""
    import dataclasses

    cfg = default_task_config()
    cfg = cfg.replace(
        randomize=dataclasses.replace(cfg.randomize, domain_randomize=False),
        env=dataclasses.replace(cfg.env, tactile=True, external_cam=True, depth_cam=True, seg_cam=True,
                                action_delay_prob_max=0.0, plug_obs_delay_prob=0.0,
                                tactile_delay_prob=0.0, img_delay_prob=0.0, seg_delay_prob=0.0,
                                seg_prob_noise=0.0, max_skip_tactile=1, max_skip_img=1))
    model, subs = build_kuka_openhand(), build_subassembly_set()
    n = 8
    to = lambda x: (type(x)(*[to(y) for y in x]) if isinstance(x, tuple)
                    else (x.to(cuda_device) if isinstance(x, torch.Tensor) else x))
    with torch.no_grad():
        s_cpu = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, "cpu"), n)
        s_gpu = to(s_cpu)
        before = profiling.launches()
        for _ in range(3):
            a = torch.zeros((n, 6))
            s_cpu, o_cpu = insertion.step(cfg, model, subs, s_cpu, a, insertion.make_generator(1, "cpu"))
            s_gpu, o_gpu = insertion.step(cfg, model, subs, s_gpu, a.to(cuda_device),
                                          insertion.make_generator(1, cuda_device))
        torch.cuda.synchronize()
    after = profiling.launches()
    assert after["tactile_render"] == before["tactile_render"] + 3
    assert after["camera_render"] == before["camera_render"] + 3
    assert float((o_gpu.seg.cpu() != o_cpu.seg).float().mean()) < 5e-3
    # depth carries ±1 mm noise from two generators (÷ 0.5 m), the tactile image σ 0.01
    assert float(((o_gpu.img.cpu() - o_cpu.img).abs() > 6e-3).float().mean()) < 5e-3
    d = (o_gpu.tactile.cpu() - o_cpu.tactile).abs()
    assert float(d.mean()) < 0.012 and float((d > 0.08).float().mean()) < 5e-3


# ------------------------------------------------ the kernels' edge cases


def _edge_problem(n, c, device, seed=3):
    """A contact set that stays bounded over the iterations (short lever arms),
    with env 0 free of active contacts, every contact of env 1 active and a
    third of env 2's inert by weight (where n allows)."""
    mass, I_inv, v, w, cs = sk.random_problem(n, c, seed=seed, lever=0.01)
    cs["depth"][0] = -np.abs(cs["depth"][0]) - 1e-4
    if n > 1:
        cs["depth"][1] = np.abs(cs["depth"][1]) + 1e-4
    if n > 2:
        cs["weight"][2, ::3] = 0.0
    T = lambda x: torch.as_tensor(x, device=device)
    return T(mass), T(I_inv), T(v), T(w), ContactSet(**{k: T(x) for k, x in cs.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(8, 255), (8, 37), (8, 200), (8, 256), (1, 255), (256, 255), (2, 1)])
def test_cuda_solver_edge_cases(cuda_device, n, c):
    """No active contact, every contact active, C not a multiple of 32, one
    env, 256 envs: the kernel solves only the active contacts, and must agree
    with the plain version that solves all of them."""
    args = _edge_problem(n, c, cuda_device)
    out = sk.solve_contacts_fused(*args, H)
    torch.cuda.synchronize()
    _assert_solver_tolerances(out, sk.solve_contacts_fused_plain(*args, H))
    cs = args[4]
    inert = ~((cs.depth > 0) & (cs.weight != 0))
    assert not bool(out.lam_n[inert].any()) and not bool(out.lam_t[inert].any())
    # env 0 has no active contact: it keeps its velocity, bit for bit
    assert torch.equal(out.v[0], args[2][0]) and torch.equal(out.w[0], args[3][0])
    assert not bool(out.dx[0].any()) and not bool(out.dth[0].any())
    if n > 1:
        assert int(((cs.depth[1] > 0) & (cs.weight[1] != 0)).sum()) == c
        assert bool((out.lam_n[1] > 0).any())


@pytest.mark.cuda
def test_cuda_solver_is_deterministic(cuda_device):
    """No atomics and a fixed order of summation: two launches on the same
    inputs give bit-identical outputs."""
    mass, I_inv, v, w, cs = sk.random_problem(256, 255, seed=8)
    T = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (T(mass), T(I_inv), T(v), T(w), ContactSet(**{k: T(x) for k, x in cs.items()}))
    a = sk.solve_contacts_fused(*args, H)
    b = sk.solve_contacts_fused(*args, H)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _tactile_rows(p, device, seed=11):
    """12 packed-row inputs (two per section family, tilted cameras): the
    first six ray origins inside the prism, the rest 2 cm below its base; p
    pixels with a gel mask of zeros and ones."""
    rng = np.random.default_rng(seed)
    r = 12
    oh = np.eye(6, dtype=np.float32)[np.arange(r) % 6]
    hx = rng.uniform(0.008, 0.02, r).astype(np.float32)
    hy = (hx * rng.uniform(0.8, 1.2, r)).astype(np.float32)
    length = rng.uniform(0.03, 0.06, r).astype(np.float32)
    o = np.stack([0.2 * hx, 0.1 * hy, np.full(r, -0.02)], -1).astype(np.float32)
    o[:6] = np.stack([0.2 * hx[:6], -0.2 * hy[:6], 0.3 * length[:6]], -1)
    # Rodrigues rotations by small random tilts
    w = rng.normal(size=(r, 3)) * 0.3
    th = np.linalg.norm(w, axis=-1)[:, None, None]
    k = w / th[:, :, 0]
    K = np.zeros((r, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 0] = -k[:, 2], k[:, 1], k[:, 2]
    K[:, 1, 2], K[:, 2, 0], K[:, 2, 1] = -k[:, 0], -k[:, 1], k[:, 0]
    M = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)).astype(np.float32)
    force = rng.uniform(0, 8, r).astype(np.float32)
    rays = rng.normal(size=(p, 3)) * 0.6 + np.array([0.0, 0.0, 1.0])
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(np.float32)
    mask = (rng.uniform(size=p) > 0.2).astype(np.float32)
    T = lambda a: torch.as_tensor(a, device=device)
    return [T(a) for a in (M, o, oh, hx, hy, length, force, rays)], T(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1001, 1002, 4100, 64, 3])
@pytest.mark.parametrize("exact", [True, False])
def test_tactile_kernel_ragged_pixels_and_interior_origins(cuda_device, p, exact):
    """A pixel count that is not a multiple of 4 (scalar loads and stores) or
    of a block's pixels, rows whose origin is inside the prism (the interior
    gradient) beside rows outside it, glow and a gel mask with holes."""
    args, mask = _tactile_rows(p, cuda_device)
    kw = dict(mask_flat=mask, glow=0.15, exact=exact, iters=12, max_range=0.06, max_deformation=0.01,
              force_range=10.0)
    out = rk.tactile_render(*args, **kw)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (12, p, 3)
    ref = rk.tactile_render_plain(*args, **kw)
    err = (out - ref).abs()
    assert bool(torch.isfinite(out).all())
    if p >= 64:
        assert float((err > 1e-3).float().mean()) < 5e-3 and float(err[err <= 1e-3].max()) < 2e-4
        assert float((out[:6] > 0.2).float().mean()) > 0.3      # interior origins are lit
    else:
        assert int((err > 1e-3).sum()) <= 1
    assert not bool(out[:, mask == 0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [None, "gauss", "ih4"])
def test_tactile_kernel_is_deterministic(cuda_device, kind):
    """Two launches on the same inputs (and, with noise, the same seed) give
    bit-identical images."""
    args, kw = _tactile_scene(16, 4, cuda_device)
    nkw = dict(noise_std=0.01, noise_kind=kind) if kind else {}
    draw = lambda: rk.tactile_render(
        *args, **kw, **nkw, generator=insertion.make_generator(3, cuda_device) if kind else None)
    a, b = draw(), draw()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_ppo_learns_on_fixed_seed_budget(cuda_device):
    """The port's counterpart of tests/test_env_ppo.py::
    test_ppo_learns_on_fixed_seed_budget, on the card at the same budget and
    criterion: 8 envs, 60 epochs of horizon 16, 2 mini-epochs, lr 1e-3; the
    critic loss's mean over the first 15 epochs must exceed 1.5x its mean over
    the last 15, and every epoch's KL must be finite."""
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    c = ppo.PPOConfig(horizon=16, mini_epochs=2, learning_rate=1e-3)
    _, _, state, train_epoch = ppo.build(cfg, c, model, subs, 8, 0, device=cuda_device)
    c_losses, kls = [], []
    for _ in range(60):
        state, m = train_epoch(state)
        c_losses.append(m["c_loss"])
        kls.append(m["kl"])
    head, tail = float(np.mean(c_losses[:15])), float(np.mean(c_losses[-15:]))
    print(f"ppo learning check: c_loss first15 {head:.4f} last15 {tail:.4f} (ratio {head / tail:.2f}); "
          f"kl min {min(kls):.4g} max {max(kls):.4g}; launches of the contact solver "
          f"{profiling.launches()['contact_solver']}")
    assert np.all(np.isfinite(kls)), "KL diverged during the budget"
    assert tail < head / 1.5, f"critic did not learn: first15={head:.4f} last15={tail:.4f}"


@pytest.mark.cuda
def test_dagger_learns_on_fixed_seed_budget(cuda_device):
    """DAgger at scripts/train_s2.sh's modalities (external camera with seg
    and point cloud on; an obs + point-cloud student with the 6-dim action
    head) from the fixed r2b teacher, 64 envs, 24 epochs of horizon 16 and 4
    mini-epochs inside the teacher-only window: the action loss's mean over
    the last 6 epochs must be below its mean over the first 6, and every
    epoch's losses finite."""
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, external_cam=True, seg_cam=True, pcl_cam=True,
                                              render_capacity=0.75))
    tree = restore_path(os.path.join(os.path.dirname(__file__), "..", "checkpoints", "teacher_r2b",
                                     "best_success"))
    teacher = ea.TeacherBundle(
        net=actor_critic_from_jax_params(tree["params"], cuda_device).requires_grad_(False),
        obs_rms=rms_to(tree["obs_rms"], cuda_device), priv_rms=rms_to(tree["priv_rms"], cuda_device))
    da = ea.DAggerConfig(horizon=16, mini_epochs=4, use_obs=True, use_pcl=True, only_bc=True)
    state, train_epoch = ea.build(cfg, da, model, subs, 64, teacher, 0, device=cuda_device)
    losses = []
    for _ in range(24):
        state, m = train_epoch(state)
        assert all(np.isfinite([m["loss"], m["action_loss"], m["episode/reward"]])), m
        losses.append(m["action_loss"])
    head, tail = float(np.mean(losses[:6])), float(np.mean(losses[-6:]))
    print(f"dagger learning check: action_loss first6 {head:.4f} last6 {tail:.4f} (ratio {head / tail:.2f}); "
          f"beta {m['episode/beta']:.4f}; launches of the camera renderer "
          f"{profiling.launches()['camera_render']}")
    assert m["episode/beta"] > 0.99
    assert tail < head, f"the student did not learn: first6={head:.4f} last6={tail:.4f}"


def _collect_cfg():
    cfg = default_task_config()
    return cfg.replace(rl=dataclasses.replace(cfg.rl, max_episode_length=10),
                       env=dataclasses.replace(cfg.env, tactile=True, external_cam=True, depth_cam=True,
                                               seg_cam=True, pcl_cam=True))


@pytest.mark.cuda
def test_collection_launch_counts_on_the_card(cuda_device, tmp_path):
    """The teacher-data collection with every sensor on: one tactile and one
    camera launch and three solver launches per control step, and nothing
    else; one .itraj per finished env, read back with the recorded dtypes."""
    from isaacgyminsertion_tpu_torch.algo.collect import collect_teacher_rollouts
    from isaacgyminsertion_tpu_torch.native import read_trajectory

    cfg, model, subs = _collect_cfg(), build_kuka_openhand(), build_subassembly_set()
    tree = restore_path(os.path.join(os.path.dirname(__file__), "..", "checkpoints", "teacher_r2b",
                                     "best_success"))
    net = actor_critic_from_jax_params(tree["params"], cuda_device)
    profiling.clear_counters("kernels.")
    stats = {}
    n = collect_teacher_rollouts(cfg, model, subs, net, tree["obs_rms"], tree["priv_rms"], 8,
                                 str(tmp_path), total_trajectories=8, chunk=11, device=cuda_device,
                                 stats=stats)
    steps = stats["steps"]
    assert n == 8 and steps == 11 and stats["writer"] == "native .itraj"
    assert profiling.launches() == dict(contact_solver=3 * steps, contact_gen=3 * steps, tactile_render=steps,
                                         camera_render=steps)
    d = read_trajectory(str(tmp_path / "traj_000000.itraj"))
    assert d["obs"].dtype == np.float32 and d["done"].dtype == np.bool_ and d["done"][-1]
    for k in ("tactile", "img", "seg", "pcl"):       # float16 / int8 are stored as float32
        assert d[k].dtype == np.float32 and np.isfinite(d[k]).all(), k
    assert set(np.unique(d["seg"])) <= {0.0, 1.0, 2.0, 3.0}


@pytest.mark.cuda
def test_itraj_round_trip_of_a_card_collected_chunk(cuda_device, tmp_path):
    """A chunk stacked on the card reaches the host in one copy with every
    array's bytes intact, and the logger's .itraj files hold them exactly."""
    from isaacgyminsertion_tpu_torch.algo.collect import host_copy
    from isaacgyminsertion_tpu_torch.data.logger import DataLoggerSim
    from isaacgyminsertion_tpu_torch.native import read_trajectory

    cfg, model, subs = _collect_cfg(), build_kuka_openhand(), build_subassembly_set()
    gen = insertion.make_generator(0, cuda_device)
    recs = []
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, gen, 4)
        for t in range(3):
            act = torch.full((4, 6), 0.1, device=cuda_device)
            state, out = insertion.step(cfg, model, subs, state, act, gen)
            recs.append(dict(obs=out.obs, rewards=out.rew, done=torch.full((4,), t == 2, device=cuda_device),
                             tactile=out.tactile[:, 0].half(), seg=out.seg[:, 0].to(torch.int8),
                             pcl=out.pcl[:, 0].half(), step=torch.full((4,), t, device=cuda_device)))
    chunk = {k: torch.stack([r[k] for r in recs]) for k in recs[0]}
    host = host_copy(chunk)
    for k, v in chunk.items():
        ref = v.cpu().numpy()
        assert host[k].dtype == ref.dtype and host[k].shape == ref.shape, k
        np.testing.assert_array_equal(host[k], ref, err_msg=k)
    lg = DataLoggerSim(str(tmp_path), 4, total_trajectories=4)
    lg.add_chunk(host)
    lg.close()
    for i in range(4):
        d = read_trajectory(str(tmp_path / f"traj_{i:06d}.itraj"))
        for k, v in host.items():
            np.testing.assert_array_equal(d[k], v[:, i].astype(d[k].dtype), err_msg=k)
