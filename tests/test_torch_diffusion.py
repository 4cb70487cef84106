"""The port's diffusion policy (`models/diffusion.py`) and its runner
(`algo/diffusion_runner.py`) against the reference, on the same weights,
step indices and noise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isaacgyminsertion_tpu.algo.diffusion_runner import DiffusionConfig as JaxConfig
from isaacgyminsertion_tpu.algo.diffusion_runner import DiffusionRunner as JaxRunner
from isaacgyminsertion_tpu.models import diffusion as jdiff
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch.algo.diffusion_runner import DiffusionConfig, DiffusionRunner
from isaacgyminsertion_tpu_torch.data.logger import DataLoggerSim
from isaacgyminsertion_tpu_torch.models import diffusion, zoo

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
B, CHUNK, ACT, OBS = 2, 8, 6, 15


def np_tree(tree):
    """A flax tree (dict or FrozenDict, jax leaves) as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), rtol=tol, atol=tol, err_msg=what)


@functools.cache
def _policies():
    """(reference policy, its flax params, the port's policy, its UNet on those params)."""
    jpol = jdiff.DiffusionPolicy(act_dim=ACT, chunk=CHUNK, obs_dim=OBS)
    params = np_tree(jax.jit(jpol.init)(jax.random.PRNGKey(0)))
    return jpol, params, diffusion.DiffusionPolicy(act_dim=ACT, chunk=CHUNK, obs_dim=OBS), \
        diffusion.unet_from_jax_params(params, ACT, OBS)


def test_embedding_schedule_and_unet_match_the_reference():
    t = np.asarray([0, 5, 42, 99], np.int32)
    _close(diffusion.timestep_embedding(torch.as_tensor(t), 128),
           jdiff.timestep_embedding(jnp.asarray(t), 128), 1e-5, "timestep_embedding")
    for a, b in zip(diffusion.make_beta_schedule(), jdiff.make_beta_schedule()):
        _close(a, b, 1e-6, "beta schedule")
    steps = jnp.linspace(99, 0, 8).astype(jnp.int32)
    assert diffusion.ddim_steps(100, 8) == np.asarray(steps).tolist() == [99, 84, 70, 56, 42, 28, 14, 0]

    jpol, params, pol, net = _policies()
    fresh = pol.init(torch.Generator().manual_seed(0))
    assert _shapes(zoo.to_jax_params(fresh)) == _shapes(params)
    x, tt, obs = RNG.normal(size=(B, CHUNK, ACT)).astype(np.float32), np.asarray([3, 77]), \
        RNG.normal(size=(B, OBS)).astype(np.float32)
    j_out = jax.jit(jdiff.UNet1D().apply)(params, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(obs))
    with torch.no_grad():
        t_out = net(torch.as_tensor(x), torch.as_tensor(tt), torch.as_tensor(obs))
    assert tuple(t_out.shape) == (B, CHUNK, ACT)
    _close(t_out, j_out, 1e-5, "UNet1D")


def _shapes(tree):
    return {k: _shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(np.shape(tree))


def test_loss_ema_and_ddim_match_the_reference():
    """The loss with t and ε from the reference's own key schedule (split →
    randint, normal), the EMA update (1e-5) and the 8-step DDIM sample from
    the same x_T (1e-4)."""
    jpol, params, pol, net = _policies()
    actions = np.tanh(RNG.normal(size=(B, CHUNK, ACT))).astype(np.float32)
    obs = RNG.normal(size=(B, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    t = np.asarray(jax.random.randint(k1, (B,), 0, 100))
    eps = np.asarray(jax.random.normal(k2, actions.shape))
    j_loss = jax.jit(jpol.loss)(params, key, jnp.asarray(actions), jnp.asarray(obs))
    with torch.no_grad():
        t_loss = pol.loss(net, torch.as_tensor(actions), torch.as_tensor(obs), t=torch.as_tensor(t).long(),
                          eps=torch.as_tensor(eps))
    _close(t_loss, j_loss, 1e-5, "loss")

    other = jax.tree_util.tree_map(lambda a: a + RNG.normal(size=a.shape).astype(np.float32), params)
    ema = pol.ema_copy(net)
    pol.ema_update(ema, diffusion.unet_from_jax_params(other, ACT, OBS))
    j_ema = jpol.ema_update(params, other)
    jax.tree_util.tree_map(lambda a, b: _close(a, b, 1e-5, "ema"), zoo.to_jax_params(ema), np_tree(j_ema))

    key = jax.random.PRNGKey(9)
    x_T = np.asarray(jax.random.normal(key, (B, CHUNK, ACT)))   # the reference's draw from `rng`
    j_sample = jpol.sample_ddim(params, key, jnp.asarray(obs))
    t_sample = pol.sample_ddim(net, torch.as_tensor(obs), x=torch.as_tensor(x_T))
    _close(t_sample, j_sample, 1e-4, "sample_ddim")
    assert float(t_sample.abs().max()) <= 1.0 + 1e-6


def _logged_dir(path, n_envs=3, steps=12):
    """Trajectories written by the port's logger: one episode per env."""
    lg = DataLoggerSim(str(path), n_envs, total_trajectories=n_envs, use_native=False)
    f32 = lambda *s: RNG.normal(size=(steps, n_envs) + s).astype(np.float32)
    done = np.zeros((steps, n_envs), bool)
    done[-1] = True
    lg.add_chunk(dict(obs=f32(15), student_obs=f32(15), priv_info=f32(64), actions=np.tanh(f32(6)),
                      latent=f32(8), eef_pos=f32(3), eef_quat=f32(4), rewards=f32(), done=done,
                      plug_pos=f32(3), plug_quat=f32(4), socket_pos=f32(3), socket_quat=f32(4)))
    lg.close()
    return str(path)


def test_runner_steps_match_the_reference(tmp_path, monkeypatch):
    """Three `DiffusionRunner` steps against the reference's `train_step` on
    the same batches, step indices and noise (its key schedule): parameters
    and EMA parameters 2e-5; the port's checkpoint is read by the reference's
    `restore_path` and loads back; `predict` gives finite chunks in [-1, 1].
    The reference runner's init (seed 0) takes the jitted init's parameters
    of `_policies` (the same key): its eager init takes 10 s on the CPU."""
    data = _logged_dir(tmp_path / "data")
    cfg = dict(chunk=CHUNK, batch_size=4, epochs=1)
    monkeypatch.setattr(jdiff.DiffusionPolicy, "init", lambda self, rng: _policies()[1])
    j = JaxRunner(JaxConfig(**cfg), data, str(tmp_path / "jax"))
    t = DiffusionRunner(DiffusionConfig(**cfg), data, str(tmp_path / "port"), device="cpu")
    zoo.load_jax_params(t.net, np_tree(j.params))
    zoo.load_jax_params(t.ema, np_tree(j.params))
    params, ema, opt = j.params, j.ema_params, j.opt_state
    rng, steps = jax.random.PRNGKey(1), 0
    for batch in j.dataset.batches(4, np.random.default_rng(0)):
        rng, k = jax.random.split(rng)
        k1, k2 = jax.random.split(k)
        actions, obs = batch["actions"], batch["student_obs"][:, 0]
        t_idx = torch.as_tensor(np.asarray(jax.random.randint(k1, (4,), 0, 100))).long()
        eps = torch.as_tensor(np.asarray(jax.random.normal(k2, actions.shape)))
        params, ema, opt, j_loss = j._train_step(params, ema, opt, k, jnp.asarray(actions), jnp.asarray(obs))
        t_loss = t.train_step(torch.as_tensor(actions), torch.as_tensor(obs), t=t_idx, eps=eps)
        _close(t_loss, j_loss, 1e-5, f"loss {steps}")
        steps += 1
        if steps == 3:
            break
    assert steps == 3
    for mine, ref in ((zoo.to_jax_params(t.net), params), (zoo.to_jax_params(t.ema), ema)):
        pj, pt = _flat(np_tree(ref)), _flat(mine)
        assert sorted(pj) == sorted(pt)
        for k in pj:
            assert np.abs(pt[k] - pj[k]).max() <= 2e-5, (k, float(np.abs(pt[k] - pj[k]).max()))

    m = t.run()
    assert np.isfinite(m["train/diffusion_loss"]) and len(t.losses) == len(t.dataset) // 4
    tree = j_restore(str(tmp_path / "port" / "last"))
    assert sorted(tree) == ["ema_params", "params"]
    before = [p.detach().clone() for p in t.ema.parameters()]
    t.restore(str(tmp_path / "port" / "last"))
    assert all(torch.equal(a, b) for a, b in zip(before, t.ema.parameters()))
    out = t.predict(np.zeros((3, OBS), np.float32), generator=torch.Generator().manual_seed(0))
    assert tuple(out.shape) == (3, CHUNK, ACT) and bool(torch.isfinite(out).all())
    assert float(out.abs().max()) <= 1.0 + 1e-6
