"""One whole PPO train epoch, the port against the JAX package on the same
inputs: the JAX package's `ppo.build` makes the env state, the params and the
normalizers at 4 envs (DR and delays off, as in `tests/test_torch_slice.py`);
the port starts from their conversions and is handed the action noise of
each rollout step and the permutation of each mini-epoch that the JAX key
chain draws (`rng, k_act = split(rng)` per step, then `rng, kp = split(rng)`
and `permutation(kp, B)` per mini-epoch). After one epoch of horizon 4 and 2
mini-epochs (B = 16 in minibatches of 8, 4 Adam steps) the two must agree:
the params to 2e-5 but for at most 0.01% of their elements, and those within
2 · lr · steps (Adam moves an element by ~lr a step whatever its gradient's
size, so a gradient entry at the level of rounding, whose sign the two
summation orders can flip, parts the two by up to 2 · lr a step); the three
normalizers to 1e-5, the losses and diagnostics to 1e-4 relative,
`agent_steps` exactly, the env's q and plug pose to 1e-5.

Two cases share one JAX reset: the default options, and the options on
(anchor-KL, an active critic warmup with its normalizer freeze, the KL
learning-rate schedule, the success mask on the timeout bootstrap). Their JAX
epochs are compiled side by side in two threads (XLA compiles with the GIL
released), which keeps the file's time on an empty compile cache near that of
one case."""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgyminsertion_tpu import assets as j_assets
from isaacgyminsertion_tpu.algo import ppo as j_ppo
from isaacgyminsertion_tpu.envs.config import default_task_config as j_default_cfg
from isaacgyminsertion_tpu.physics import robot as j_robot
from isaacgyminsertion_tpu_torch import assets as t_assets
from isaacgyminsertion_tpu_torch.algo import ppo as t_ppo
from isaacgyminsertion_tpu_torch.envs import insertion as t_env
from isaacgyminsertion_tpu_torch.envs.config import default_task_config as t_default_cfg
from isaacgyminsertion_tpu_torch.models.actor_critic import (
    actor_critic_from_jax_params,
    to_jax_params,
)
from isaacgyminsertion_tpu_torch.models.running_mean_std import rms_to
from isaacgyminsertion_tpu_torch.physics import robot as t_robot

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

N, HORIZON, MINI_EPOCHS = 4, 4, 2
OPTIONS = {
    "default": {},
    "options_on": dict(anchor_coef=0.5, critic_warmup_steps=8.0, lr_schedule="kl",
                       bootstrap_mask_success=True),
}


def _deterministic(cfg):
    return cfg.replace(
        randomize=dataclasses.replace(cfg.randomize, domain_randomize=False),
        env=dataclasses.replace(cfg.env, action_delay_prob_max=0.0, plug_obs_delay_prob=0.0))


def _jax_case(world, case):
    """A case's JAX start state (its optimizer state and anchor) and its
    compiled epoch."""
    j_cfg_ppo = j_ppo.PPOConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS, **OPTIONS[case])
    if j_cfg_ppo.lr_schedule == "kl":   # as j_ppo.build chooses the optimizer
        tx = optax.chain(optax.clip_by_global_norm(j_cfg_ppo.grad_norm),
                         optax.inject_hyperparams(optax.adam)(learning_rate=j_cfg_ppo.learning_rate))
    else:
        tx = optax.chain(optax.clip_by_global_norm(j_cfg_ppo.grad_norm),
                         optax.adam(j_cfg_ppo.learning_rate))
    js = world["j_state"]
    js = js._replace(opt_state=tx.init(js.params),
                     anchor_params=js.params if j_cfg_ppo.anchor_coef > 0 else None)
    j_epoch = j_ppo.make_train_epoch(world["j_cfg"], j_cfg_ppo, world["j_model"], world["j_subs"],
                                     world["net"], tx)
    return js, jax.jit(j_epoch).lower(js).compile()


@pytest.fixture(scope="module")
def world():
    """One JAX build (env reset, params, normalizers) shared by both cases,
    and each case's compiled JAX epoch."""
    j_cfg, t_cfg = _deterministic(j_default_cfg()), _deterministic(t_default_cfg())
    j_model, j_subs = j_robot.build_kuka_openhand(), j_assets.build_subassembly_set()
    net, _, j_state, _ = j_ppo.build(j_cfg, j_ppo.PPOConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS),
                                     j_model, j_subs, N, jax.random.PRNGKey(0))
    w = dict(j_cfg=j_cfg, t_cfg=t_cfg, j_model=j_model, j_subs=j_subs, net=net, j_state=j_state,
             t_model=t_robot.build_kuka_openhand(), t_subs=t_assets.build_subassembly_set())
    with ThreadPoolExecutor(len(OPTIONS)) as pool:
        w["jax_cases"] = dict(zip(OPTIONS, pool.map(functools.partial(_jax_case, w), OPTIONS)))
    return w


def _key_chain(rng, n_act):
    """The action noise of each rollout step and the permutation of each
    mini-epoch, as the JAX epoch draws them."""
    noise, perms = [], []
    for _ in range(HORIZON):
        rng, k_act = jax.random.split(rng)
        noise.append(torch.as_tensor(np.array(jax.random.normal(k_act, (N, n_act), jnp.float32))))
    for _ in range(MINI_EPOCHS):
        rng, kp = jax.random.split(rng)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(kp, HORIZON * N))).long())
    return noise, perms


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_one_train_epoch_matches_the_jax_package(world, case):
    t_cfg_ppo = t_ppo.PPOConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS, **OPTIONS[case])
    js, j_epoch = world["jax_cases"][case]
    js2, jm = j_epoch(js)

    host = jax.device_get(js)
    t_net = actor_critic_from_jax_params(host.params, "cpu").train()
    ts = t_ppo.PPOState(
        net=t_net, optimizer=t_ppo.make_optimizer(t_net.parameters(), t_cfg_ppo.learning_rate),
        obs_rms=rms_to(host.obs_rms, "cpu"), priv_rms=rms_to(host.priv_rms, "cpu"),
        value_rms=rms_to(host.value_rms, "cpu"),
        env_state=t_env.env_state_from_numpy(host.env_state, "cpu"),
        env_gen=t_env.make_generator(0, "cpu"), train_gen=t_env.make_generator(1, "cpu"),
        epoch=0, agent_steps=0,
        anchor=t_ppo.frozen_copy(t_net) if t_cfg_ppo.anchor_coef > 0 else None)
    noise, perms = _key_chain(js.rng, world["t_cfg"].env.num_actions)
    t_epoch = t_ppo.TrainEpoch(world["t_cfg"], t_cfg_ppo, world["t_model"], world["t_subs"])
    ts2, tm = t_epoch(ts, noise=noise, perms=perms)

    # the parameters after 4 clipped Adam steps
    j_params, t_params = _flat(jax.device_get(js2.params)), _flat(to_jax_params(t_net.state_dict()))
    assert j_params.keys() == t_params.keys()
    steps = MINI_EPOCHS * MINI_EPOCHS     # minibatches of B // mini_epochs rows
    moved, off, size = 0, 0, 0
    for k in j_params:
        err = np.abs(t_params[k] - j_params[k])
        assert err.max() <= 2 * t_cfg_ppo.learning_rate * steps, (k, err.max())
        off += int((err > 2e-5 + 1e-4 * np.abs(j_params[k])).sum())
        size += err.size
        moved += not np.allclose(j_params[k], np.asarray(_flat(jax.device_get(js.params))[k]))
    assert off <= 1e-4 * size, (off, size)
    warm = t_cfg_ppo.critic_warmup_steps > 0
    assert moved == (8 if warm else len(j_params))   # in the warmup only critic_mlp and value
    # the three normalizers
    for name in ("obs_rms", "priv_rms", "value_rms"):
        for f, a, b in zip(("mean", "var", "count"), getattr(js2, name), getattr(ts2, name)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name}.{f}")
    if warm:   # the warmup freezes the obs/priv statistics
        np.testing.assert_array_equal(ts2.obs_rms.mean.numpy(), np.asarray(host.obs_rms.mean))
    # losses and diagnostics
    assert set(jm) <= set(tm), set(jm) - set(tm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert ("kl_anchor" in tm) == (t_cfg_ppo.anchor_coef > 0)
    if t_cfg_ppo.lr_schedule == "kl":
        j_lr = float(js2.opt_state[1].hyperparams["learning_rate"])
        np.testing.assert_allclose(ts2.optimizer.param_groups[0]["lr"], j_lr, rtol=1e-6)
        assert j_lr != t_cfg_ppo.learning_rate
    # counters and the env
    assert ts2.agent_steps == int(js2.agent_steps) == HORIZON * N and ts2.epoch == int(js2.epoch) == 1
    for f in ("q", "plug_pos", "plug_quat"):
        np.testing.assert_allclose(getattr(ts2.env_state.phys, f).numpy(),
                                   np.asarray(getattr(js2.env_state.phys, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
