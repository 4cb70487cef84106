"""Offline training, the tactile regressor and the collectors, port vs JAX
package. No JAX env is compiled or stepped here: the runners are held to the
JAX ones on synthetic trajectories, and the collectors run the port's env,
whose files the JAX dataset classes read.

- `OfflineRunner`, started from the JAX runner's parameters, in two
  configurations (obs + point cloud only-BC, offline_r5's recipe; obs latent
  with the frozen-teacher action regularization): per-step losses 1e-5,
  parameters 2e-5 after 6 steps (an element whose reference gradient is zero
  to rounding: 2 · Σ lr until its first real one), the learning rate at
  every step 1e-7; the held-out loss and `_rms_of` as the JAX runner's.
- `TactileRegressionRunner`: the same epoch losses and parameters after
  `fit`, weights carried both ways.
- `collect_teacher_rollouts` on the port's CPU env (2 envs, a 10-step
  episode, every sensor on at small point counts): its files read by the JAX
  `TrajectoryDataset` and `DataNormalizer`, each record field equal to its
  recomputation from the port's own env, pre- or post-step; then an offline
  epoch on them and the replay eval with the normalizer's RMS.
- `collect_rotating_plug`: quaternions against the JAX rotation ops 1e-6,
  images against the port's `render_tactile` on the same poses."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgyminsertion_tpu.algo import offline_runner as j_off
from isaacgyminsertion_tpu.algo import tactile_runner as j_tac
from isaacgyminsertion_tpu.data import dataset as j_ds
from isaacgyminsertion_tpu.models.actor_critic import ActorCriticSplit as JActorCritic
from isaacgyminsertion_tpu.models.running_mean_std import RMSState as JRMS
from isaacgyminsertion_tpu.ops import rotations as j_rot
from isaacgyminsertion_tpu_torch.algo import collect as t_collect
from isaacgyminsertion_tpu_torch.algo import offline_runner as t_off
from isaacgyminsertion_tpu_torch.algo import tactile_runner as t_tac
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import insertion
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.models.actor_critic import actor_critic_from_jax_params
from isaacgyminsertion_tpu_torch.models.running_mean_std import rms_normalize, rms_to
from isaacgyminsertion_tpu_torch.models.student import student_to_jax_params, tactile_head_from_jax_params
from isaacgyminsertion_tpu_torch.physics.kinematics import forward_kinematics, site_pose
from isaacgyminsertion_tpu_torch.physics.robot import SITE_FINGERTIP_CENTERED, build_kuka_openhand
from isaacgyminsertion_tpu_torch.sensors.tactile import TactileConfig, render_tactile
from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

TEACHER = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "teacher_r2b", "best_success")
CONFIGS = {
    # offline_r5's recipe: obs + point cloud, 6-dim tanh action head (a cloud
    # of 800 points: the plug and socket PointNets, as the banked student)
    "r5_obs_pcl_bc": dict(only_bc=True, use_pcl=True),
    # obs → 8-dim latent, regularized through a frozen (tiny, random) teacher
    "obs_latent_teacher": dict(only_bc=False),
}


def _synthetic_dir(path, seed=0, n=6, t=12, points=800):
    rng = np.random.default_rng(seed)
    os.makedirs(path)
    for i in range(n):
        f32 = lambda *s, scale=1.0: (scale * rng.normal(size=(t,) + s)).astype(np.float32)
        np.savez_compressed(os.path.join(path, f"traj_{i:06d}.npz"), **dict(
            student_obs=f32(15), obs=f32(15), priv_info=f32(64), latent=f32(8),
            actions=np.tanh(f32(6)), pcl=f32(points, 3, scale=0.05).astype(np.float16),
            done_idx=np.asarray(t - 1)))
    return path


def _tiny_teacher(path):
    """A random flax teacher checkpoint (the JAX layout, the teacher's widths)."""
    net = JActorCritic(num_actions=6, obs_dim=15, priv_dim=64)
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, 15)), jnp.zeros((1, 64)))
    rms = lambda d, s: JRMS(mean=np.full(d, 0.1, np.float32), var=np.full(d, s, np.float32),
                            count=np.asarray(100.0, np.float32))
    tree = {"params": jax.tree_util.tree_map(np.asarray, params), "obs_rms": rms(15, 2.0),
            "priv_rms": rms(64, 0.5)}
    import pickle

    with open(path + ".ckpt", "wb") as f:
        pickle.dump(tree, f)
    return path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# Where an element's reference gradient is zero to rounding (below GRAD_ZERO
# of that step's largest gradient element), Adam scales the rounding noise up
# to as much as lr a step, in both packages, until the element's first real
# gradient outweighs it in the moments. So an element is held to 2e-5, or to
# 2 · Σ lr over the steps before its first real gradient where that is larger.
# The attention key biases never get one (the softmax is invariant to a shift
# shared by all keys); a channel of the conv before the tactile soft-argmax
# gets none while every pixel of it is active, or none is.
GRAD_ZERO = 1e-5


def _noise_lr(grads, lrs):
    """{leaf: Σ lr over the steps before each element's first gradient above
    rounding}, from the reference's gradients (one flax tree a step)."""
    out, real = {}, {}
    for g, lr in zip(grads, lrs, strict=True):
        flat = _flat(g)
        scale = max(float(np.abs(v).max()) for v in flat.values())
        for key, v in flat.items():
            real[key] = real.get(key, False) | (np.abs(v) > GRAD_ZERO * scale)
            out[key] = out.get(key, 0.0) + np.where(real[key], 0.0, lr)
    return out


def _assert_params(pj, pt, noise_lr):
    """Parameters 2e-5, or 2 · Σ lr of the steps before the element's first
    real gradient where that is larger."""
    assert sorted(pj) == sorted(pt) == sorted(noise_lr)
    for key in pj:
        tol = np.maximum(2e-5, 2 * noise_lr[key])
        err = np.abs(pt[key] - pj[key])
        assert (err <= tol).all(), (key, float(err.max()), int((tol > 2e-5).sum()), tol.size)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_offline_runner_matches_jax(tmp_path, name):
    data = _synthetic_dir(str(tmp_path / "data"))
    teacher = _tiny_teacher(str(tmp_path / "teacher")) if name == "obs_latent_teacher" else ""
    kw = dict(epochs=1, batch_size=8, learning_rate=1e-3, warmup_steps=2, **CONFIGS[name])
    j = j_off.OfflineRunner(j_off.OfflineConfig(**kw), data, str(tmp_path / "j"), teacher_ckpt=teacher)
    t = t_off.OfflineRunner(t_off.OfflineConfig(**kw), data, str(tmp_path / "t"), teacher_ckpt=teacher,
                            device="cpu")
    assert t.dataset.files == j.dataset.files and t.val_dataset.files == j.val_dataset.files
    assert (t.teacher is None) == (j.teacher is None) == (name != "obs_latent_teacher")
    t.load_params(j.params)
    sched = optax.warmup_cosine_decay_schedule(0.0, kw["learning_rate"], kw["warmup_steps"],
                                               max(t.total_steps, kw["warmup_steps"] + 1))
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    batches = list(t.dataset.batches(kw["batch_size"], np.random.default_rng(0)))
    assert len(batches) == t.total_steps == 6
    grad_j = jax.jit(jax.grad(lambda p, b: j._loss(p, b)[0]))
    grads = []
    for k, batch in enumerate(batches):
        lr = t.lr_at(t.updates)
        assert abs(lr - float(sched(k))) < 1e-7, k
        prepared = j._prepare(batch, rng_j, True)
        grads.append(grad_j(j.params, prepared))
        j.params, j.opt_state, aux_j = j._train_step(j.params, j.opt_state, prepared)
        aux_t = t.train_step(t._prepare(batch, rng_t, True))
        assert sorted(aux_t) == sorted(aux_j)
        for key in aux_j:
            np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {k} {key}")
        if k == 0:   # lr 0 at the first update: AdamW leaves every parameter as it was
            assert lr == 0.0
    pj, pt = _flat(j.params), _flat(student_to_jax_params(t.student.state_dict()))
    _assert_params(pj, pt, _noise_lr(grads, [t.lr_at(k) for k in range(t.updates)]))
    vb = next(t.val_dataset.batches(len(t.val_dataset), np.random.default_rng(1)))
    vj = j._eval_step(j.params, j._prepare(vb, rng_j, False))
    vt = t.eval_step(t._prepare(vb, rng_t, False))
    np.testing.assert_allclose(float(vt["loss"]), float(vj["loss"]), rtol=1e-5)
    for key in ("student_obs", "pcl", "obs"):
        rj, rt = j._rms_of(key), t._rms_of(key)
        for a, b in zip(rt, rj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_offline_run_writes_flax_checkpoints_the_jax_package_loads(tmp_path):
    """`run`: metrics, `last` and the held-out `best`, `student_params` in the
    flax layout, loaded back by `restore` and by the JAX package."""
    from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore

    data = _synthetic_dir(str(tmp_path / "data"), points=48)
    cfg = t_off.OfflineConfig(epochs=2, batch_size=8, only_bc=True, use_pcl=True)
    t = t_off.OfflineRunner(cfg, data, str(tmp_path / "out"), device="cpu")
    m = t.run()
    assert np.isfinite(m["train/loss"]) and np.isfinite(m["val/loss"]) and t.updates == 12
    rows = [json.loads(x) for x in open(tmp_path / "out" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [6, 12]
    assert {"last.ckpt", "best_reward.ckpt"} <= set(os.listdir(tmp_path / "out"))
    tree = j_restore(str(tmp_path / "out" / "last"))
    assert "pn_scene" in tree["student_params"]["params"]          # 48 points: the scene slice only
    back = t_off.OfflineRunner(cfg, data, str(tmp_path / "back"), seed=5, device="cpu")
    back.restore(str(tmp_path / "out" / "last"))
    for a, b in zip(back.student.state_dict().values(), t.student.state_dict().values()):
        assert torch.equal(a, b)


def test_tactile_regressor_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    tactile = rng.random((20, 3, 16, 16, 3)).astype(np.float32)
    targets = rng.normal(size=(20, 7)).astype(np.float32)
    cfg = dict(batch_size=8, epochs=3)
    j = j_tac.TactileRegressionRunner(j_tac.TactileRunnerConfig(**cfg), str(tmp_path / "j"))
    t = t_tac.TactileRegressionRunner(t_tac.TactileRunnerConfig(**cfg), str(tmp_path / "t"), device="cpu")
    j.params = j.net.init(jax.random.PRNGKey(0), jnp.asarray(tactile[:1]))
    j.opt_state = j.tx.init(j.params)
    t.load_params(j.params)
    # the reference's gradient at each of its steps' inputs (its loss, the MSE)
    grad_j = jax.jit(jax.grad(lambda p, x, y: jnp.mean(jnp.square(j.net.apply(p, x) - y))))
    step_j, grads = j._train_step, []

    def recording_step(params, opt_state, x, y):
        grads.append(grad_j(params, x, y))
        return step_j(params, opt_state, x, y)

    j._train_step = recording_step
    np.testing.assert_allclose(t.predict(tactile), j.predict(tactile), rtol=1e-5, atol=1e-6)
    lj, lt = j.fit(tactile, targets), t.fit(tactile, targets)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    rows = [[json.loads(x)["train/tactile_loss"] for x in open(tmp_path / d / "metrics.jsonl")]
            for d in ("j", "t")]
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-5)
    assert len(t.epoch_losses) == 3
    pj, pt = _flat(j.params), _flat(student_to_jax_params(t.net.state_dict()))
    assert len(grads) == 6
    _assert_params(pj, pt, _noise_lr(grads, [3e-4] * 6))
    # the checkpoint is the reference's {"params": <flax tree>}; port → JAX → port
    saved = restore_path(str(tmp_path / "t" / "last"))["params"]
    np.testing.assert_allclose(np.asarray(j.net.apply(saved, jnp.asarray(tactile))), t.predict(tactile),
                               rtol=1e-5, atol=1e-6)
    again = tactile_head_from_jax_params(saved)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), t.net.state_dict().values()))


def _sensors_cfg():
    cfg0 = default_task_config()
    return cfg0.replace(
        rl=dataclasses.replace(cfg0.rl, max_episode_length=10),
        env=dataclasses.replace(cfg0.env, tactile=True, external_cam=True, depth_cam=True, seg_cam=True,
                                pcl_cam=True, total_points=64, num_points=24, num_points_socket=24,
                                num_points_goal=0))


def test_collect_on_the_port_env_read_by_the_jax_dataset(tmp_path, monkeypatch):
    cfg, model, subs = _sensors_cfg(), build_kuka_openhand(), build_subassembly_set()
    tree = restore_path(TEACHER)
    net = actor_critic_from_jax_params(tree["params"], "cpu")
    data = str(tmp_path / "trajs")
    stats = {}
    n = t_collect.collect_teacher_rollouts(cfg, model, subs, net, tree["obs_rms"], tree["priv_rms"],
                                           n_envs=2, out_dir=data, total_trajectories=2, chunk=11,
                                           device="cpu", stats=stats)
    assert n == 2 and stats["steps"] == 11 and stats["files"] == 2
    manifest = json.load(open(os.path.join(data, "manifest.json")))
    assert manifest["count"] == 2 and manifest["files"] == ["traj_000000.itraj", "traj_000001.itraj"]
    keys = ("obs", "student_obs", "priv_info", "actions", "latent", "eef_pos", "eef_quat", "rewards",
            "done", "success", "plug_pos", "plug_quat", "socket_pos", "socket_quat", "tactile", "img",
            "seg", "pcl")
    ds = j_ds.TrajectoryDataset(data, keys=keys, normalizer=None)
    # a 10-step episode times out at its 9th step (progress ≥ max_episode_length - 1)
    assert len(ds) == 2 * 8 and [len(d["done"]) for d in ds._trajs] == [9, 9]
    assert [d["done"].tolist() for d in ds._trajs] == [[False] * 8 + [True]] * 2
    stats_j = j_ds.DataNormalizer(data).run()
    assert sorted(stats_j) == sorted(j_ds.NORM_KEYS) and stats_j["pcl"]["mean"].shape == (3,)

    # the same rollout again, each field recomputed from the port's env state
    gen = insertion.make_generator(0, "cpu")
    obs_rms, priv_rms = rms_to(tree["obs_rms"], "cpu"), rms_to(tree["priv_rms"], "cpu")
    want = {k: [] for k in keys}
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, gen, 2)
        for _ in range(9):
            priv = insertion.priv_info_of(cfg, model, state)
            mu, _, _, latent, _ = net(rms_normalize(obs_rms, state.obs_queue),
                                   rms_normalize(priv_rms, priv))
            act = torch.clamp(mu, -1.0, 1.0)
            eq, et = site_pose(model, forward_kinematics(model, state.phys.q), SITE_FINGERTIP_CENTERED)
            pre = dict(obs=state.obs_queue, student_obs=state.obs_stud_queue, priv_info=priv, actions=act,
                       latent=latent, eef_pos=et, eef_quat=eq)
            state, out = insertion.step(cfg, model, subs, state, act, gen)
            post = dict(plug_pos=state.phys.plug_pos, plug_quat=state.phys.plug_quat,
                        socket_pos=state.params.socket_pos, socket_quat=state.params.socket_quat,
                        rewards=out.rew, done=out.reset, success=out.extras["successes"],
                        tactile=out.tactile[:, 0].half(), img=out.img[:, 0].half(),
                        seg=out.seg[:, 0].to(torch.int8), pcl=out.pcl[:, 0].half())
            for k, v in {**pre, **post}.items():
                want[k].append(v.numpy())
    for i in range(2):
        for k in keys:
            got = ds._trajs[i][k]
            w = np.stack(want[k])[:, i]
            assert got.shape == w.shape, k
            np.testing.assert_array_equal(got, w.astype(got.dtype), err_msg=k)

    # an offline epoch on the collection, then its replay with the normalizer's RMS
    seen = {}
    from isaacgyminsertion_tpu_torch.algo import trainer

    make = trainer.make_student_eval_fn

    def spy(*a, **kw):
        fn = make(*a, **kw)

        def evaluate(student, seed):
            seen["student"] = student
            return fn(student, seed)
        return evaluate

    monkeypatch.setattr(trainer, "make_student_eval_fn", spy)
    runner = t_off.OfflineRunner(t_off.OfflineConfig(epochs=1, batch_size=4, only_bc=True, use_pcl=True,
                                                     val_fraction=0.0), data, str(tmp_path / "out"),
                                 device="cpu")
    assert np.isfinite(runner.run()["train/loss"])
    sr = runner.replay_eval(cfg, n_envs=2, seed=0)
    assert 0.0 <= sr <= 1.0 and runner.replay_success == sr
    s = runner.normalizer.stats
    for key, rms in (("student_obs", seen["student"].stud_obs_rms), ("pcl", seen["student"].pcl_rms)):
        np.testing.assert_array_equal(rms.mean.numpy(), s[key]["mean"])
        np.testing.assert_allclose(rms.var.numpy(), s[key]["std"] ** 2, rtol=1e-7)
        assert float(rms.count) == 1e8
    with pytest.raises(ValueError, match="teacher_ckpt"):
        t_off.OfflineRunner(t_off.OfflineConfig(epochs=0, val_fraction=0.0), data, str(tmp_path / "o2"),
                            device="cpu").replay_eval(cfg, n_envs=2)


def test_collect_rotating_plug(tmp_path):
    cfg, model, subs = _sensors_cfg(), build_kuka_openhand(), build_subassembly_set()
    out = str(tmp_path / "rot")
    assert t_collect.collect_rotating_plug(cfg, model, subs, 2, out, n_steps=3, device="cpu") == 6
    with np.load(out + ".npz") as d:
        tactile, quat, pos = d["tactile"], d["plug_quat"], d["plug_pos"]
    assert tactile.shape == (2, 3, 3, 64, 64, 3) and quat.shape == (2, 3, 4) and pos.shape == (2, 3)
    assert np.isfinite(tactile).all() and tactile.min() >= 0.0 and tactile.max() <= 1.0
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, "cpu"), 2)
    q0 = state.phys.plug_quat.numpy()
    np.testing.assert_array_equal(pos, state.phys.plug_pos.numpy())
    from isaacgyminsertion_tpu_torch.physics.engine import fingertip_poses

    tip_q, tip_t = fingertip_poses(model, forward_kinematics(model, state.phys.q))
    p = state.params
    for t in range(3):
        z = jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (2, 1))
        dq = j_rot.quat_from_angle_axis(jnp.full((2,), 0.05 * t), z)
        np.testing.assert_allclose(quat[:, t], np.asarray(j_rot.quat_mul(dq, jnp.asarray(q0))), atol=1e-6)
        img = render_tactile(TactileConfig(), tip_q, tip_t, torch.as_tensor(quat[:, t]), state.phys.plug_pos,
                             p.kind_onehot, p.plug_hx, p.plug_hy, p.plug_length,
                             force=torch.full((2, 3), 5.0))
        assert float(np.abs(tactile[:, t] - img.numpy()).mean()) < 1e-4
