"""The sensors-on slice, port vs JAX reference, from one shared JAX reset:
three control steps of the banked student_r3 (tactile + seg + point cloud,
latent injected into the frozen r2b teacher) in both packages, every sensor on.

DR, the action/observation delays, the sensor delays and the seg/pcl noise
probabilities are off, so the physics is deterministic given state and
action. What stays random, from different generators in the two packages:
the tactile pixel noise (σ 0.01), the depth noise (±1 mm) and which pixels
the point cloud samples. Both envs are therefore stepped with the JAX
student's action, so the physics holds the state-only slice's 1e-5; the port's student is
held to the JAX student on its own sensor frames with a looser tolerance.

The port follows the reference's FUSED render path. Off the TPU the
reference's env would take its XLA path, so the test points the env's two
render calls at `fused=True` (Pallas in interpret mode, as the reference's
render tests run it); nothing in the JAX package changes. The two paths of the
reference are not interchangeable: for a gel camera whose origin lies inside
a trapezoid plug they shade differently (`test_reference_paths_differ_...`)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu import assets as j_assets
from isaacgyminsertion_tpu.algo import ext_adapt as j_ea
from isaacgyminsertion_tpu.envs import insertion as j_env
from isaacgyminsertion_tpu.envs.config import default_task_config as j_default_cfg
from isaacgyminsertion_tpu.models.actor_critic import ActorCriticSplit
from isaacgyminsertion_tpu.models.student import MultiModalModel
from isaacgyminsertion_tpu.physics import robot as j_robot
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch import assets as t_assets
from isaacgyminsertion_tpu_torch.algo import ext_adapt as t_ea
from isaacgyminsertion_tpu_torch.algo.trainer import StudentEvaluator
from isaacgyminsertion_tpu_torch.envs import insertion as t_env
from isaacgyminsertion_tpu_torch.envs.config import default_task_config as t_default_cfg
from isaacgyminsertion_tpu_torch.models import zoo
from isaacgyminsertion_tpu_torch.physics import robot as t_robot

torch.set_num_threads(1)

N = 3
CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
TEACHER = os.path.join(CKPTS, "teacher_r2b", "best_success")
STUDENT = os.path.join(CKPTS, "student_r3", "best_success")
FLAGS = dict(use_obs=True, use_tactile=True, use_seg=True, use_pcl=True, only_bc=False)


def _sensors_on(cfg):
    return cfg.replace(
        randomize=dataclasses.replace(cfg.randomize, domain_randomize=False),
        env=dataclasses.replace(
            cfg.env, tactile=True, external_cam=True, depth_cam=True, seg_cam=True, pcl_cam=True,
            compute_contact_gt=True, action_delay_prob_max=0.0, plug_obs_delay_prob=0.0,
            tactile_delay_prob=0.0, img_delay_prob=0.0, seg_delay_prob=0.0, pcl_prob_noise=0.0,
            seg_prob_noise=0.0))


def _close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture
def fused_reference(monkeypatch):
    """The reference env's render calls, sent through its fused (Pallas) path."""
    monkeypatch.setattr(j_env.tact_mod, "render_tactile",
                        functools.partial(j_env.tact_mod.render_tactile, fused=True))
    monkeypatch.setattr(j_env.cam_mod, "render_depth_seg",
                        functools.partial(j_env.cam_mod.render_depth_seg, fused=True))


def test_three_student_steps_match(fused_reference):
    j_cfg, t_cfg = _sensors_on(j_default_cfg()), _sensors_on(t_default_cfg())
    jm, tm = j_robot.build_kuka_openhand(), t_robot.build_kuka_openhand()
    jsub, tsub = j_assets.build_subassembly_set(), t_assets.build_subassembly_set()
    js = j_env.reset_all(j_cfg, jm, jsub, jax.random.PRNGKey(0), N)
    ts = t_env.env_state_from_numpy(jax.device_get(js), "cpu")
    assert ts.tactile_queue.dtype == torch.float16 and tuple(ts.tactile_queue.shape) == (N, 1, 3, 64, 64, 3)
    assert tuple(ts.pcl_queue.shape) == (N, 1, 800, 3) and tuple(ts.contact_queue.shape)[:2] == (N, 1)
    np.testing.assert_array_equal(np.asarray(js.img_refresh_rate), ts.img_refresh_rate.numpy())

    # the JAX student, as the reference's eval drives it
    t_tree, s_tree = j_restore(TEACHER), j_restore(STUDENT)
    j_da = j_ea.DAggerConfig(**FLAGS)
    teacher = j_ea.TeacherBundle(params=t_tree["params"], obs_rms=t_tree["obs_rms"],
                                 priv_rms=t_tree["priv_rms"])
    j_student = MultiModalModel(use_obs=True, use_tactile=True, use_seg=True, use_pcl=True,
                                latent_dim=8, num_points_goal=0)
    j_act = j_ea.make_student_act(j_cfg, j_da, ActorCriticSplit(), teacher, j_student)

    def j_policy(state):
        da_like = j_ea.DAggerState(
            student_params=None, opt_state=None, stud_obs_rms=s_tree["stud_obs_rms"],
            pcl_rms=s_tree["pcl_rms"], env_state=state, rng=jnp.zeros((2,), jnp.uint32),
            epoch=jnp.zeros((), jnp.int32), agent_steps=jnp.zeros(()))
        return j_act(s_tree["student_params"], da_like, state.obs_stud_queue,
                     j_ea._prev_out_of(state, j_cfg))[0]

    j_policy = jax.jit(j_policy)
    j_step = jax.jit(lambda s, a: j_env.step(j_cfg, jm, jsub, s, a))
    # the port's student, as its evaluator loads it
    runner = StudentEvaluator(t_cfg, t_ea.DAggerConfig(**FLAGS), tm, tsub, N, TEACHER, STUDENT,
                              device="cpu")
    t_act = t_ea.make_student_act(t_cfg, t_ea.DAggerConfig(**FLAGS), runner.teacher)
    gen = t_env.make_generator(0, "cpu")

    with torch.no_grad():
        for k in range(3):
            a_j = np.asarray(j_policy(js))
            a_t = t_act(runner.student, ts.obs_stud_queue, t_ea._prev_out_of(ts, t_cfg))[0].numpy()
            if k == 0:
                # identical (empty) sensor queues: the two students agree to fp32 rounding
                _close(a_j, a_t, 1e-4, 1e-4, "student action on the reset state")
            else:
                # each student sees its own noisy frames and its own sampled points
                assert np.abs(a_j - a_t).max() < 0.25, (k, np.abs(a_j - a_t).max())
            js, oj = j_step(js, jnp.asarray(a_j))
            ts, ot = t_env.step(t_cfg, tm, tsub, ts, torch.as_tensor(a_j.copy()), gen)
            # physics as in the state-only slice
            _close(js.phys.q, ts.phys.q, 1e-5, 1e-5, f"q step {k}")
            _close(js.phys.plug_pos, ts.phys.plug_pos, 1e-5, 1e-5, f"plug_pos step {k}")
            _close(js.phys.plug_quat, ts.phys.plug_quat, 1e-5, 1e-5, f"plug_quat step {k}")
            _close(oj.obs, ot.obs, 1e-4, 1e-4, f"obs step {k}")
            _close(oj.rew, ot.rew, 1e-5, 1e-5, f"rew step {k}")
            # tactile: render tolerance + two independent draws of σ 0.01 noise + f16 storage
            tj, tt = np.asarray(oj.tactile), ot.tactile.numpy()
            assert tt.shape == tj.shape and np.isfinite(tt).all()
            d = np.abs(tj - tt)
            assert d.mean() < 0.012 and (d > 0.08).mean() < 5e-3, (k, d.mean(), (d > 0.08).mean())
            fresh = np.abs(tj).reshape(N, -1).max(1) > 0      # envs whose tactile frame refreshed
            np.testing.assert_array_equal(fresh, np.abs(tt).reshape(N, -1).max(1) > 0)
            # depth (normalized by −far = −0.5): ±1 mm noise on each side → 4e-3, + f16 storage
            dj, dt_ = np.asarray(oj.img), ot.img.numpy()
            assert (np.abs(dj - dt_) > 6e-3).mean() < 5e-3, (k, (np.abs(dj - dt_) > 6e-3).mean())
            # seg ids equal off the silhouette pixels
            sj, st = np.asarray(oj.seg), ot.seg.numpy()
            assert (sj != st).mean() < 5e-3, (k, (sj != st).mean())
            assert set(np.unique(st).tolist()) <= {0.0, 1.0, 2.0, 3.0}
            # point cloud: the plug and socket slices sample the same surfaces. Each side
            # draws its own 400 pixels, so the centroids agree within 2 mm or, on a wide
            # surface, 4 standard errors of the difference of two 400-point means
            pj, pt = np.asarray(oj.pcl)[:, 0], ot.pcl.numpy()[:, 0]
            for sl in (slice(0, 400), slice(400, 800)):
                cj, ct = pj[:, sl].mean(1), pt[:, sl].mean(1)
                tol = np.maximum(2e-3, 4.0 * np.sqrt(2.0 / 400.0) * pj[:, sl].std(1))
                assert (np.abs(cj - ct) < tol).all(), (k, sl, np.abs(cj - ct), tol)
                np.testing.assert_array_equal(np.abs(pj[:, sl]).sum((1, 2)) > 0,
                                              np.abs(pt[:, sl]).sum((1, 2)) > 0)
            # contact ground truth: equal off the reference's random dropout
            gj, gt = np.asarray(oj.contacts), ot.contacts.numpy()
            assert (np.abs(gj - gt) > 1e-3).mean() < 0.11
    assert ts.global_step == 3 and not bool(ts.reset_buf.any())
    assert float(ts.tactile_queue.float().abs().max()) > 0 and float(ts.pcl_queue.abs().max()) > 0


def test_render_capacity_gathers_the_consumers():
    """render_capacity < 1: the rows that consume a frame this step are
    rendered and scattered back; the others keep their frame; nothing is
    dropped while the consumers fit the capacity; the CycleGAN hook
    translates the gathered rows."""
    cfg = _sensors_on(t_default_cfg())
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, render_capacity=0.75, compute_contact_gt=False))
    model, subs = t_robot.build_kuka_openhand(), t_assets.build_subassembly_set()
    n = 16
    gen = t_env.make_generator(3, "cpu")
    with torch.no_grad():
        s = t_env.reset_all(cfg, model, subs, gen, n)
        full = cfg.replace(env=dataclasses.replace(cfg.env, render_capacity=1.0))
        s_full = s
        for k in range(3):
            a = torch.zeros((n, 6))
            prev = s.tactile_queue[:, 0].clone()
            s, out = t_env.step(cfg, model, subs, s, a, gen)
            s_full, out_full = t_env.step(full, model, subs, s_full, a, t_env.make_generator(9, "cpu"))
            refresh = ((s.frame + s.tactile_refresh_offset) % s.tactile_refresh_rate) == 0
            kept = ~refresh
            assert bool((s.tactile_queue[:, 0][kept] == prev[kept]).all())      # no refresh: frame kept
            assert bool((s.tactile_queue[:, 0][refresh].float().abs().flatten(1).max(1).values > 0).all())
            # k = 16 rows are gathered at 16 envs (rounded up to a multiple of 8): nothing overflows
            assert float(out.extras["render_overflow"][0]) == 0.0
            _close(s.phys.q.numpy(), s_full.phys.q.numpy(), 1e-6, 1e-6, "physics does not depend on it")
            same = (out.seg == out_full.seg).float().mean()
            assert float(same) > 0.995                                          # same frames either way
    # the CycleGAN hook runs on the gathered rows: a kept frame stays as it was,
    # the translated ones stay finite and in [0, 1]
    gan = zoo.init_like_flax(zoo.ResnetGenerator(), torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        prev = s.tactile_queue[:, 0].clone()
        s, out = t_env.step(cfg, model, subs, s, torch.zeros((n, 6)), gen, gan=gan)
    kept = ((s.frame + s.tactile_refresh_offset) % s.tactile_refresh_rate) != 0
    assert bool((s.tactile_queue[:, 0][kept] == prev[kept]).all())
    assert bool(torch.isfinite(out.tactile).all()) and 0.0 <= float(out.tactile.min()) <= float(out.tactile.max()) <= 1.0
