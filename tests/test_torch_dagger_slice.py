"""One whole DAgger epoch, the port against the JAX package on the same
inputs: the port resets the env (4 envs, DR and delays off, as in
`tests/test_torch_ppo_slice.py`; the port's reset takes a second where the
JAX package's eager one takes half a minute) and the state is handed to the
JAX package as its own `EnvState`; the JAX package initializes an obs-only
student (its 8-dim latent injected into the frozen teacher actor); the
teacher on both sides is the banked r2b. The port starts from the
conversions and is handed the mix uniforms of each rollout step and the
permutation of each mini-epoch that the JAX key chain draws
(`rng, k_mix = split(rng)` per step, then `rng, kp = split(rng)` and
`permutation(kp, B)` per mini-epoch).

The epoch starts at agent_steps 8 with β annealed over 32 steps and no
teacher-only window, so β is 0.75, 0.625, 0.5 and 0.375 over the horizon of 4
and both the teacher's and the student's actions are executed. After one
epoch (B = 16 in minibatches of 8, 4 Adam steps) the two must agree: the
parameters to 2e-5 but for at most 0.01% of their elements, and those within
2 · lr · steps; the normalizers to 1e-5; the losses and rollout metrics to
1e-4 relative; β per step to 1e-6; agent_steps exactly; the env's q and plug
pose to 1e-5. This is the file's only JAX env compile; the port's epoch runs
while it compiles."""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgyminsertion_tpu import assets as j_assets
from isaacgyminsertion_tpu.algo import ext_adapt as j_ea
from isaacgyminsertion_tpu.envs import insertion as j_env
from isaacgyminsertion_tpu.envs.config import default_task_config as j_default_cfg
from isaacgyminsertion_tpu.models.actor_critic import ActorCriticSplit as JActorCritic
from isaacgyminsertion_tpu.models.running_mean_std import rms_init as j_rms_init
from isaacgyminsertion_tpu.models.student import MultiModalModel as JStudent
from isaacgyminsertion_tpu.physics import engine as j_engine
from isaacgyminsertion_tpu.physics import robot as j_robot
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch import assets as t_assets
from isaacgyminsertion_tpu_torch.algo import ext_adapt as t_ea
from isaacgyminsertion_tpu_torch.envs import insertion as t_env
from isaacgyminsertion_tpu_torch.envs.config import default_task_config as t_default_cfg
from isaacgyminsertion_tpu_torch.models.actor_critic import actor_critic_from_jax_params
from isaacgyminsertion_tpu_torch.models.running_mean_std import rms_to
from isaacgyminsertion_tpu_torch.models.student import student_from_jax_params, student_to_jax_params
from isaacgyminsertion_tpu_torch.physics import robot as t_robot

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

N, HORIZON, MINI_EPOCHS = 4, 4, 2
START_STEPS, ANNEAL = 8, 32.0
TEACHER = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "teacher_r2b", "best_success")


def _deterministic(cfg):
    return cfg.replace(
        randomize=dataclasses.replace(cfg.randomize, domain_randomize=False),
        env=dataclasses.replace(cfg.env, action_delay_prob_max=0.0, plug_obs_delay_prob=0.0))


def _jax_env_state(t_state):
    """The JAX package's EnvState holding a port EnvState's values (integers
    as int32, a fresh key for the env's own draws)."""
    def a(x):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)

    tp = t_state.params
    params = j_engine.PhysicsParams(**{
        k: (j_engine.MaterialParams(**{c: a(v) for c, v in tp.contact._asdict().items()})
            if k == "contact" else a(getattr(tp, k))) for k in j_engine.PhysicsParams._fields})
    phys = j_engine.PhysicsState(**{k: a(v) for k, v in t_state.phys._asdict().items()})
    rest = {k: a(getattr(t_state, k)) for k in j_env.EnvState._fields
            if k not in ("phys", "params", "rng", "global_step")}
    return j_env.EnvState(phys=phys, params=params, rng=jax.random.PRNGKey(3),
                          global_step=jnp.asarray(t_state.global_step, jnp.int32), **rest)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _key_chain(rng):
    """The mix uniforms of each rollout step and the permutation of each
    mini-epoch, as the JAX epoch draws them."""
    mix, perms = [], []
    for _ in range(HORIZON):
        rng, k_mix = jax.random.split(rng)
        mix.append(torch.as_tensor(np.array(jax.random.uniform(k_mix, (N, 1)))))
    for _ in range(MINI_EPOCHS):
        rng, kp = jax.random.split(rng)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(kp, HORIZON * N))).long())
    return mix, perms


def _port_epoch(js, t_cfg, da):
    """The port's epoch from the JAX start state, on the JAX key chain's draws."""
    host = jax.device_get(js)
    tree = j_restore(TEACHER)
    teacher = t_ea.TeacherBundle(
        net=actor_critic_from_jax_params(tree["params"], "cpu").requires_grad_(False),
        obs_rms=rms_to(tree["obs_rms"], "cpu"), priv_rms=rms_to(tree["priv_rms"], "cpu"))
    net = student_from_jax_params(host.student_params, da, t_cfg.env, "cpu").train()
    ts = t_ea.DAggerState(
        net=net, optimizer=t_ea.student_optimizer(net, da), stud_obs_rms=rms_to(host.stud_obs_rms, "cpu"),
        pcl_rms=rms_to(host.pcl_rms, "cpu"), env_state=t_env.env_state_from_numpy(host.env_state, "cpu"),
        env_gen=t_env.make_generator(0, "cpu"), train_gen=t_env.make_generator(1, "cpu"),
        epoch=0, agent_steps=START_STEPS)
    mix, perms = _key_chain(js.rng)
    te = t_ea.TrainEpoch(t_cfg, da, t_robot.build_kuka_openhand(), t_assets.build_subassembly_set(), teacher)
    ts2, tm = te(ts, mix=mix, rows=perms)
    return host, te, mix, ts2, tm


@pytest.fixture(scope="module")
def epochs():
    """The JAX start state (the port's reset, the JAX student and optimizer),
    the JAX epoch's result, and the port's epoch from the same state."""
    j_cfg, t_cfg = _deterministic(j_default_cfg()), _deterministic(t_default_cfg())
    model, subs = j_robot.build_kuka_openhand(), j_assets.build_subassembly_set()
    da = j_ea.DAggerConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS, teacher_only_steps=0.0,
                           beta_anneal_steps=ANNEAL)
    tree = j_restore(TEACHER)
    teacher = j_ea.TeacherBundle(params=tree["params"], obs_rms=tree["obs_rms"], priv_rms=tree["priv_rms"])
    student = JStudent(use_obs=True)
    tx = optax.chain(optax.clip_by_global_norm(da.grad_norm), optax.adam(da.learning_rate))
    j_env.nominal_grasp_arm_q(model)   # the reference caches it eagerly; its step reads the cache
    with torch.no_grad():
        env_state = _jax_env_state(t_env.reset_all(t_cfg, t_robot.build_kuka_openhand(),
                                                   t_assets.build_subassembly_set(),
                                                   t_env.make_generator(0, "cpu"), N))
    params = jax.jit(lambda k: student.init(k, obs=jnp.zeros((N, 15))))(jax.random.PRNGKey(1))
    js = j_ea.DAggerState(
        student_params=params, opt_state=jax.jit(tx.init)(params), stud_obs_rms=j_rms_init((15,)),
        pcl_rms=j_rms_init((3,)), env_state=env_state, rng=jax.random.PRNGKey(2),
        epoch=jnp.zeros((), jnp.int32), agent_steps=jnp.asarray(START_STEPS, jnp.float32))
    epoch = j_ea.make_train_epoch(j_cfg, da, model, subs,
                                  JActorCritic(num_actions=6, obs_dim=15, priv_dim=64), teacher, student, tx)
    t_da = t_ea.DAggerConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS, teacher_only_steps=0.0,
                             beta_anneal_steps=ANNEAL)
    lowered = jax.jit(epoch).lower(js)
    with ThreadPoolExecutor(1) as pool:   # XLA compiles with the GIL released
        compiled = pool.submit(lowered.compile)
        port = _port_epoch(js, t_cfg, t_da)
        js2, jm = compiled.result()(js)
    return (js, js2, jm, t_da) + port


def test_one_dagger_epoch_matches_the_jax_package(epochs):
    js, js2, jm, da, host, te, mix, ts2, tm = epochs
    net = ts2.net

    # β per step, and both actions executed
    betas = [te.beta(START_STEPS + t * N) for t in range(HORIZON)]
    j_betas = [float(jnp.clip(1.0 - jnp.float32(START_STEPS + t * N) / ANNEAL, 0.0, 1.0))
               for t in range(HORIZON)]
    np.testing.assert_allclose(betas, j_betas, rtol=0, atol=1e-6)
    assert all(0.0 < b < 1.0 for b in betas)
    teacher_acts = torch.stack([m[:, 0] < b for m, b in zip(mix, betas)])
    assert teacher_acts.any() and not teacher_acts.all()
    np.testing.assert_allclose(tm["episode/beta"], float(jm["episode/beta"]), rtol=0, atol=1e-6)
    # the parameters after 4 clipped Adam steps
    j_params, t_params = _flat(jax.device_get(js2.student_params)), _flat(student_to_jax_params(net.state_dict()))
    assert j_params.keys() == t_params.keys()
    steps = MINI_EPOCHS * MINI_EPOCHS     # minibatches of B // mini_epochs rows
    off = size = 0
    for k in j_params:
        err = np.abs(t_params[k] - j_params[k])
        assert err.max() <= 2 * da.learning_rate * steps, (k, err.max())
        off += int((err > 2e-5 + 1e-4 * np.abs(j_params[k])).sum())
        size += err.size
        # with one token the attention's softmax is 1: its query and key get no gradient
        frozen = "/query/" in k or "/key/" in k
        assert np.array_equal(j_params[k], _flat(host.student_params)[k]) == frozen, k
    assert off <= 1e-4 * size, (off, size)
    # the normalizers
    for name in ("stud_obs_rms", "pcl_rms"):
        for f, a, b in zip(("mean", "var", "count"), getattr(js2, name), getattr(ts2, name)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5, err_msg=f"{name}.{f}")
    # losses and rollout metrics
    assert set(jm) <= set(tm), set(jm) - set(tm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert tm["latent_loss"] == 0.0 and tm["action_loss"] > 0.0
    # counters and the env
    assert ts2.agent_steps == int(js2.agent_steps) == START_STEPS + HORIZON * N
    assert ts2.epoch == int(js2.epoch) == 1
    for f in ("q", "plug_pos", "plug_quat"):
        np.testing.assert_allclose(getattr(ts2.env_state.phys, f).numpy(),
                                   np.asarray(getattr(js2.env_state.phys, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
