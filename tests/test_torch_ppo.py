"""The pieces of the port's PPO against the JAX package: the running
normalizer's update, the Gaussian policy helpers, the clipped Adam against
optax, flax's default initialization and the flax parameter layout."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgyminsertion_tpu.models import actor_critic as j_ac
from isaacgyminsertion_tpu.models import running_mean_std as j_rms
from isaacgyminsertion_tpu_torch.algo import ppo as t_ppo
from isaacgyminsertion_tpu_torch.models import actor_critic as t_ac
from isaacgyminsertion_tpu_torch.models import running_mean_std as t_rms

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)


def _close(port, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("shape", [(3,), ()])
def test_rms_update_and_unnormalize_match(shape):
    """Two updates at [T, N, D] on a vector state and at [T, N] on the scalar
    state (the value normalizer), then normalize and unnormalize: 1e-6."""
    rng = np.random.default_rng(0)
    js, ts = j_rms.rms_init(shape), t_rms.rms_init(shape)
    for k in range(2):
        batch = (rng.normal(size=(5, 7) + shape) * (k + 2.0) + 1.5).astype(np.float32)
        js, ts = j_rms.rms_update(js, jnp.asarray(batch)), t_rms.rms_update(ts, torch.as_tensor(batch))
        for f, a, b in zip(("mean", "var", "count"), js, ts):
            assert tuple(b.shape) == np.asarray(a).shape
            _close(b, a, 1e-6, f"{f} after update {k}")
    x = rng.normal(size=(4,) + shape).astype(np.float32)
    _close(t_rms.rms_normalize(ts, torch.as_tensor(x)), j_rms.rms_normalize(js, jnp.asarray(x)), 1e-6)
    _close(t_rms.rms_unnormalize(ts, torch.as_tensor(x)), j_rms.rms_unnormalize(js, jnp.asarray(x)),
           1e-6)
    # the population variance (ddof 0), not torch.var's default
    b = np.arange(6.0, dtype=np.float32).reshape(6, 1) if shape else np.arange(6.0, dtype=np.float32)
    one = t_rms.rms_update(t_rms.RMSState(torch.zeros(shape), torch.zeros(shape), torch.tensor(0.0)),
                           torch.as_tensor(b))
    _close(one.var, np.full(shape, np.var(b)), 1e-6)


def test_policy_helpers_match():
    rng = np.random.default_rng(1)
    mu, mu1 = (rng.normal(size=(9, 6)).astype(np.float32) for _ in range(2))
    log_std = (rng.normal(size=(6,)) * 0.3).astype(np.float32)
    sig0, sig1 = (np.exp(rng.normal(size=(9, 6)) * 0.2).astype(np.float32) for _ in range(2))
    acts = rng.normal(size=(9, 6)).astype(np.float32)
    T = torch.as_tensor
    _close(t_ac.gaussian_neglogp(T(acts), T(mu), T(log_std)),
           j_ac.gaussian_neglogp(jnp.asarray(acts), jnp.asarray(mu), jnp.asarray(log_std)), 1e-6)
    _close(t_ac.policy_kl(T(mu), T(sig0), T(mu1), T(sig1)),
           j_ac.policy_kl(jnp.asarray(mu), jnp.asarray(sig0), jnp.asarray(mu1), jnp.asarray(sig1)), 1e-6)
    # sample_actions on the noise the JAX key draws
    key = jax.random.PRNGKey(3)
    ja, jn = j_ac.sample_actions(jnp.asarray(mu), jnp.asarray(log_std), key)
    eps = np.array(jax.random.normal(key, mu.shape, jnp.float32))
    ta, tn = t_ac.sample_actions(T(mu), T(log_std), noise=T(eps))
    _close(ta, ja, 1e-6, "actions")
    _close(tn, jn, 1e-6, "neglogp")
    # from a generator: the same shape, and the noise is a standard normal
    gen = torch.Generator().manual_seed(0)
    big = T(np.zeros((20000, 6), np.float32))
    a, _ = t_ac.sample_actions(big, T(np.zeros(6, np.float32)), gen)
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1.0) < 0.02


def test_clipped_adam_matches_optax():
    """The port's clip by global norm + Adam against optax.chain(
    clip_by_global_norm, adam) for 3 steps (one under the norm, two over),
    then a learning-rate change through inject_hyperparams: 1e-6."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 4), "b": (4,), "c": (3, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.inject_hyperparams(optax.adam)(learning_rate=1e-3))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.as_tensor(p0[k].copy())) for k in shapes]
    opt = t_ppo.make_optimizer(tp, 1e-3)
    for step, scale in enumerate((0.05, 3.0, 10.0, 3.0)):
        if step == 3:   # the LR change of the KL schedule / the anneal ladder
            opt_state[1].hyperparams["learning_rate"] = jnp.asarray(2.5e-4)
            t_ppo.set_lr(opt, 2.5e-4)
        g = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
        assert (norm < 1.0) == (step == 0)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tp, shapes):
            p.grad = torch.as_tensor(g[k].copy())
        t_norm = t_ppo.clip_by_global_norm_(tp, 1.0)
        _close(t_norm, norm, 1e-6, f"norm at step {step}")
        opt.step()
        for p, k in zip(tp, shapes):
            _close(p.detach(), jp[k], 1e-6, f"{k} after step {step}")
    # truncate_grads=False: an infinite max norm clips nothing
    for p in tp:
        p.grad = torch.full_like(p, 7.0)
    t_ppo.clip_by_global_norm_(tp, float("inf"))
    assert all(bool((p.grad == 7.0).all()) for p in tp)


def test_fresh_init_has_flax_statistics():
    """Per layer of the full-width teacher: kernels drawn like flax's
    lecun_normal (std 1/sqrt(fan_in), truncated at 2 std of the underlying
    normal), zero biases, zero log_std."""
    net = t_ac.init_like_flax(t_ac.ActorCriticSplit(obs_dim=15), torch.Generator().manual_seed(0))
    flax_params = j_ac.ActorCriticSplit(obs_dim=15).init(jax.random.PRNGKey(0), jnp.zeros((1, 15)),
                                                         jnp.zeros((1, 64)))
    ref = t_ac.convert_jax_params(flax_params)
    sd = net.state_dict()
    assert sd.keys() == ref.keys()
    for k, w in sd.items():
        r = ref[k]
        assert w.shape == r.shape, k
        if not k.endswith(".weight"):
            assert not bool(w.any()) and not bool(r.any()), k       # biases and log_std: zeros
            continue
        fan_in, n = w.shape[1], w.numel()
        bound = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        tol = 5.0 / np.sqrt(2.0 * n)      # 5 sigma of a sample std over n draws
        for name, x in (("port", w), ("flax", r)):
            std = float(x.std())
            assert abs(std * np.sqrt(fan_in) - 1.0) < tol, (k, name, std)
            assert float(x.abs().max()) <= bound + 1e-6, (k, name)
            assert abs(float(x.mean())) < 5.0 * std / np.sqrt(n), (k, name)
        # nn.Linear's own init (Kaiming uniform, std 1/sqrt(3 fan_in)) is not this
        if n > 1000:
            assert abs(float(w.std()) * np.sqrt(3.0 * fan_in) - 1.0) > 0.3, k


def test_flax_layout_round_trip():
    """to_jax_params inverts convert_jax_params exactly, and flax's
    ActorCriticSplit.apply on the converted tree equals the port's forward
    (1e-5)."""
    flax_net = j_ac.ActorCriticSplit(obs_dim=15)
    params = flax_net.init(jax.random.PRNGKey(1), jnp.zeros((1, 15)), jnp.zeros((1, 64)))
    net = t_ac.init_like_flax(t_ac.ActorCriticSplit(obs_dim=15), torch.Generator().manual_seed(4))
    tree = t_ac.to_jax_params(net.state_dict())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.device_get(params))
    back = t_ac.convert_jax_params(tree)
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k
    again = t_ac.to_jax_params(t_ac.convert_jax_params(jax.device_get(params)))
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(jax.device_get(params))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    obs, priv = rng.normal(size=(8, 15)).astype(np.float32), rng.normal(size=(8, 64)).astype(np.float32)
    j_out = flax_net.apply(tree, jnp.asarray(obs), jnp.asarray(priv))
    with torch.no_grad():
        t_out = net(torch.as_tensor(obs), torch.as_tensor(priv))
    for name, a, b in zip(("mu", "log_std", "value", "latent"), t_out, j_out[:4]):
        _close(a.detach(), b, 1e-5, name)
