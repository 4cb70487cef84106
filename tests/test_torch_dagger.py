"""The pieces of DAgger training, port vs JAX package, without an env.

The JAX package's `make_split_replay_epoch` is built directly on a synthetic
reservoir (its jits are lazy, so no env step is traced) and its reservoir
writes (`scatter_a`, `scatter_b`) and minibatch updates (`update`,
`update_strat`) are called on synthetic batches made with numpy; the port's
`Reservoir` and `TrainEpoch.update` get the same batches and the draws of the
JAX key chain (the slot uniforms, `uniform(key, (B,))`, and the minibatch rows,
`randint` per mini-epoch). For several epochs in a row the JAX epoch's own
host logic runs (`SplitEpoch.__call__`, with its rollout replaced by one that
hands out the synthetic batches), so the stratified reservoir's freeze is the
reference's.

Tolerances: reservoirs, slots, fills and cursors exact; parameters 2e-5 but
for at most 0.01% of their elements, and those within 2 · lr · steps (as in
`tests/test_torch_ppo_slice.py`); losses 1e-4 relative. Also here: phase 3
against `optax.multi_transform` (frozen parameters bitwise unchanged), the
latent loss with latent injection, the fresh student against flax's init,
`student_to_jax_params` on the banked students, a port checkpoint through
both packages' loaders, and a learning check on the port alone."""

import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgyminsertion_tpu.algo import ext_adapt as j_ea
from isaacgyminsertion_tpu.envs.config import default_task_config as j_default_cfg
from isaacgyminsertion_tpu.models.actor_critic import ActorCriticSplit as JActorCritic
from isaacgyminsertion_tpu.models.running_mean_std import RMSState as JRMS
from isaacgyminsertion_tpu.models.student import MultiModalModel as JStudent
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch.algo import ext_adapt as t_ea
from isaacgyminsertion_tpu_torch.algo import ppo as t_ppo
from isaacgyminsertion_tpu_torch.algo.trainer import DAggerTrainer, StudentEvaluator
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs.config import default_task_config as t_default_cfg
from isaacgyminsertion_tpu_torch.models.actor_critic import actor_critic_from_jax_params
from isaacgyminsertion_tpu_torch.models.running_mean_std import rms_to
from isaacgyminsertion_tpu_torch.models.student import (
    convert_flax_params,
    init_student_like_flax,
    student_from_jax_params,
    student_to_jax_params,
)
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
from isaacgyminsertion_tpu_torch.utils.checkpoint import restore_path

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
TEACHER = os.path.join(CKPTS, "teacher_r2b", "best_success")
N, HORIZON, MINI_EPOCHS = 4, 4, 2
B = N * HORIZON                       # 16 samples an epoch, minibatches of 8, 2 of them
MB, N_MB = B // MINI_EPOCHS, MINI_EPOCHS
P_PLUG = P_SOCKET = 16                # a small point cloud (32 points)
FLAGS = {"r5": dict(use_obs=True, use_pcl=True, only_bc=True),
         "r3": dict(use_obs=True, use_tactile=True, use_seg=True, use_pcl=True, only_bc=False)}


def _cfgs():
    small = lambda c: c.replace(env=dataclasses.replace(c.env, num_points=P_PLUG,
                                                        num_points_socket=P_SOCKET))
    return small(j_default_cfg()), small(t_default_cfg())


def _batch(rng, da, n=B):
    """A synthetic flattened batch in the rollout's key order and dtypes (the
    env's frames: tactile and seg float16, the point cloud float32)."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    empty = np.zeros((n, 0), np.float32)
    return dict(
        obs=f32(n, 15), student_obs=f32(n, 15),
        t_actions=rng.uniform(-1, 1, (n, 6)).astype(np.float32), latent_gt=f32(n, 8),
        tactile=rng.uniform(0, 1, (n, 1, 3, 64, 64, 3)).astype(np.float16) if da["use_tactile"] else empty,
        img=empty,
        seg=rng.integers(0, 4, (n, 1, 54, 96)).astype(np.float16) if da["use_seg"] else empty,
        pcl=(0.05 * f32(n, 1, P_PLUG + P_SOCKET, 3)) if da["use_pcl"] else empty)


def _rms(rng, dim):
    return (rng.normal(size=(dim,)).astype(np.float32) * 0.1,
            rng.uniform(0.5, 2.0, (dim,)).astype(np.float32), np.float32(100.0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_params(j_params, t_net, lr, steps):
    """Parameters to 2e-5, but for at most 0.01% of their elements, and those
    within 2 · lr · steps (a gradient entry at rounding level can flip sign
    between two orders of summation, and Adam moves it ~lr a step)."""
    j, t = _flat(jax.device_get(j_params)), _flat(student_to_jax_params(t_net.state_dict()))
    assert j.keys() == t.keys()
    off = size = 0
    for k in j:
        err = np.abs(t[k] - j[k])
        assert err.max() <= 2 * lr * steps, (k, err.max())
        off += int((err > 2e-5 + 1e-4 * np.abs(j[k])).sum())
        size += err.size
    assert off <= 1e-4 * size, (off, size)


def _assert_losses(j_aux, t_aux):
    for k in ("action_loss", "latent_loss", "loss"):
        np.testing.assert_allclose(t_aux[k], float(j_aux[k]), rtol=1e-4, atol=1e-7, err_msg=k)


@functools.lru_cache(maxsize=None)
def _teachers():
    """The banked r2b teacher in both packages (read once for the file)."""
    tree = j_restore(TEACHER)
    j_teacher = j_ea.TeacherBundle(params=tree["params"], obs_rms=tree["obs_rms"], priv_rms=tree["priv_rms"])
    t_teacher = t_ea.TeacherBundle(
        net=actor_critic_from_jax_params(tree["params"], "cpu").requires_grad_(False),
        obs_rms=rms_to(tree["obs_rms"], "cpu"), priv_rms=rms_to(tree["priv_rms"], "cpu"))
    return j_teacher, t_teacher


def _j_student(flags):
    da = FLAGS[flags]
    e = _cfgs()[0].env
    return JStudent(use_obs=da["use_obs"], use_tactile=da.get("use_tactile", False),
                    use_seg=da.get("use_seg", False), use_pcl=da["use_pcl"],
                    latent_dim=6 if da["only_bc"] else 8, bc_mode=da["only_bc"],
                    num_points=e.num_points, num_points_socket=e.num_points_socket, num_points_goal=0)


def _da_flags(flags):
    da = FLAGS[flags]
    return dict(use_tactile=da.get("use_tactile", False), use_seg=da.get("use_seg", False),
                use_pcl=da["use_pcl"])


@functools.lru_cache(maxsize=None)
def _params0(flags):
    """The JAX student's initial parameters for one configuration (one
    init compile per configuration, whatever the world)."""
    sample = _batch(np.random.default_rng(0), _da_flags(flags), n=2)
    j_da = j_ea.DAggerConfig(**FLAGS[flags])

    @jax.jit
    def init(key, frames, student_obs):   # one compile, not one per eager op
        out0 = SimpleNamespace(**frames, priv_info=None)
        norms = SimpleNamespace(stud_obs_rms=j_rms((15,)), pcl_rms=j_rms((3,)))
        return _j_student(flags).init(key, **j_ea._student_inputs(j_da, norms, student_obs, out0))

    return init(jax.random.PRNGKey(1), {k: jnp.asarray(sample[k]) for k in t_ea.FRAME_KEYS},
                jnp.asarray(sample["student_obs"]))


def _replay0(flags, capacity):
    """The JAX package's zero reservoir of `capacity` rows for a configuration."""
    j_cfg = _cfgs()[0]
    sample = _batch(np.random.default_rng(0), _da_flags(flags), n=2)
    j_da = j_ea.DAggerConfig(replay_size=capacity, **FLAGS[flags])
    env_like = SimpleNamespace(obs_queue=jnp.zeros((N, 15)), obs_stud_queue=jnp.zeros((N, 15)))
    out_like = SimpleNamespace(**{k: jnp.asarray(np.repeat(sample[k][:1], N, 0)) for k in t_ea.FRAME_KEYS})
    return j_ea._replay_arrays(j_cfg, j_da, env_like, out_like, N, K=capacity)


@functools.lru_cache(maxsize=None)
def _scatter_epoch(flags, capacity):
    """A JAX split epoch built only for its reservoir write (`scatter_b`):
    no student, no optimizer, nothing traced but the scatter."""
    j_da = j_ea.DAggerConfig(horizon=HORIZON, replay_size=capacity, **FLAGS[flags])
    replay0 = _replay0(flags, capacity)
    return replay0, j_ea.make_split_replay_epoch(_cfgs()[0], j_da, None, None, None, None, None, None,
                                                 replay0, N)


class World:
    """One student configuration in both packages: the JAX student and its
    split epoch on a synthetic reservoir, the port's student (the same
    parameters), its optimizer and epoch. `world(...)` shares one per
    configuration between the tests that only read it."""

    def __init__(self, flags, replay_size, phase3=False, **da_kw):
        da = FLAGS[flags]
        j_cfg, t_cfg = _cfgs()
        rng = np.random.default_rng(0)
        self.j_da = j_ea.DAggerConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS, replay_size=replay_size,
                                      **da, **da_kw)
        self.t_da = t_ea.DAggerConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS, replay_size=replay_size,
                                      **da, **da_kw)
        j_teacher, self.t_teacher = _teachers()
        self.j_student = _j_student(flags)
        self.da_flags = _da_flags(flags)
        _batch(rng, self.da_flags, n=2)       # the sample `_params0` initializes from
        tx = optax.chain(optax.clip_by_global_norm(self.j_da.grad_norm), optax.adam(self.j_da.learning_rate))
        self.params0 = _params0(flags)
        if phase3:
            labels = jax.tree_util.tree_map(lambda m: "train" if m else "freeze",
                                            j_ea.decoder_only_mask(self.params0))
            tx = optax.multi_transform({"train": tx, "freeze": optax.set_to_zero()}, labels)
        self.opt0 = jax.jit(tx.init)(self.params0)
        self.replay0 = _replay0(flags, replay_size)
        self.ep = j_ea.make_split_replay_epoch(j_cfg, self.j_da, None, None,
                                               JActorCritic(num_actions=6, obs_dim=15, priv_dim=64),
                                               j_teacher, self.j_student, tx, self.replay0, N)
        self.rms = [_rms(rng, 15), _rms(rng, 3)]
        self.t_net = student_from_jax_params(jax.device_get(self.params0), self.t_da, t_cfg.env, "cpu").train()
        self.t_opt = t_ea.student_optimizer(self.t_net, self.t_da, phase3)
        self.t_epoch = t_ea.TrainEpoch(t_cfg, self.t_da, None, None, self.t_teacher)
        self.t_student = t_ea.StudentBundle(self.t_net, rms_to(JRMS(*self.rms[0]), "cpu"),
                                            rms_to(JRMS(*self.rms[1]), "cpu"))
        self.j_rms = [JRMS(*map(jnp.asarray, r)) for r in self.rms]


world = functools.lru_cache(maxsize=None)(World)


def _compiled_world(*args, **kw):
    """`world(...)` with its JAX update compiled (a call on the zero
    reservoir fills the jit's cache)."""
    w = world(*args, **kw)
    w.ep.update(w.params0, w.opt0, w.j_rms[0], w.j_rms[1], w.replay0, jnp.asarray(B, jnp.int32),
                jax.random.PRNGKey(0))
    return w


@pytest.fixture(scope="module", autouse=True)
def ahead():
    """Builds the latent and phase-3 worlds on a second thread from the
    module's first test on: XLA compiles with the GIL released, so they
    compile while the reservoir and replay tests run."""
    with ThreadPoolExecutor(1) as pool:
        yield {"r3": pool.submit(_compiled_world, "r3", B, latent_loss_coef=0.5),
               "phase3": pool.submit(_compiled_world, "r5", B, phase3=True)}


def j_rms(shape):
    return JRMS(jnp.zeros(shape), jnp.ones(shape), jnp.asarray(1e-4))


def _copy(replay):
    """A copy of a JAX reservoir: the JAX scatter donates (deletes) its input."""
    return {k: jnp.array(v, copy=True) for k, v in replay.items()}


def _t_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _uniform(key):
    return torch.as_tensor(np.array(jax.random.uniform(key, (B,))))


def _randint(key, shape, fill):
    return np.array(jax.random.randint(key, shape, 0, jnp.maximum(jnp.asarray(fill, jnp.int32), 1)))


def _rows_uniform(key, fill):
    rows = []
    for _ in range(MINI_EPOCHS):
        key, kp = jax.random.split(key)
        rows.append(torch.as_tensor(_randint(kp, (N_MB, MB), fill)).long())
    return rows


def _rows_strat(key, fill_a, fill_b, k_a):
    rows = []
    for _ in range(MINI_EPOCHS):
        key, ka, kb = jax.random.split(key, 3)
        a = _randint(ka, (N_MB, MB // 2), fill_a)
        b = _randint(kb, (N_MB, MB - MB // 2), fill_b)
        rows.append(torch.as_tensor(np.concatenate([a, k_a + b], axis=1)).long())
    return rows


def _assert_rows_equal(j_rows: dict, t_rows: dict, lo, hi):
    for k, v in j_rows.items():
        t = t_rows[k][lo:hi].numpy()
        assert t.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(t, np.asarray(v), err_msg=k)


# ------------------------------------------------------------------ reservoir

@pytest.mark.parametrize("cursor, capacity", [(0, 40), (32, 40), (4, 4)],
                         ids=["before_fill", "across_fill", "full_with_duplicate_slots"])
def test_reservoir_write_matches_the_jax_scatter(cursor, capacity):
    """One write at a cursor before, across and after the fill: the port's
    reservoir (allocation, dtypes, slots, duplicates, drops) equals the JAX
    scatter's output exactly."""
    replay0, ep = _scatter_epoch("r5", capacity)
    batch = _batch(np.random.default_rng(3), _da_flags("r5"))
    key = jax.random.PRNGKey(7)
    j_out = ep.scatter_b(_copy(replay0), _j_batch(batch), jnp.asarray(cursor, jnp.int32), key)
    res = t_ea.Reservoir(capacity)
    res.cursor = cursor
    res.write(_t_batch(batch), _uniform(key))
    assert res.cursor == cursor + B and res.fill_b == min(cursor + B, capacity)
    _assert_rows_equal(j_out, res.rows, 0, capacity)
    slot = t_ea.reservoir_slots(cursor, _uniform(key), capacity)
    kept = slot[slot < capacity]
    if cursor >= capacity:   # the case was chosen so that two samples draw one slot, and one is dropped
        assert kept.unique().numel() < kept.numel() and kept.numel() < B


def test_reservoir_slots_above_2_24_match_the_jax_scatter():
    """Above 2²⁴ samples the float32 of g + 1 rounds: at a capacity of 2²⁴ and
    a cursor past it, each of 2,048 samples lands in the slot the JAX scatter
    gives it (a float64 or integer product would move about a quarter). The
    JAX epoch is built on a reservoir of one int32 field, the sample's id."""
    cap, cursor, horizon, n_envs = 2 ** 24, 2 ** 24 + 12_345, 64, 32
    n = horizon * n_envs
    j_cfg, _ = _cfgs()
    da = j_ea.DAggerConfig(horizon=horizon, replay_size=cap)
    ep = j_ea.make_split_replay_epoch(j_cfg, da, None, None, None, None, None, None,
                                      {"ids": jnp.zeros((cap,), jnp.int32)}, n_envs)
    key = jax.random.PRNGKey(11)
    ids = np.arange(1, n + 1, dtype=np.int32)
    j_buf = np.asarray(ep.scatter_b(ep.replay_b, {"ids": jnp.asarray(ids)},
                                    jnp.asarray(cursor, jnp.int32), key)["ids"])
    res = t_ea.Reservoir(cap)
    res.cursor = cursor
    u = torch.as_tensor(np.array(jax.random.uniform(key, (n,))))
    res.write({"ids": torch.as_tensor(ids)}, u)
    t_buf = res.rows["ids"].numpy()
    hit = np.flatnonzero(j_buf)
    assert 1900 < hit.size <= n
    np.testing.assert_array_equal(np.flatnonzero(t_buf), hit)
    np.testing.assert_array_equal(t_buf[hit], j_buf[hit])
    # the exact product would put many of these samples elsewhere
    g1 = cursor + np.arange(n) + 1
    exact = (u.numpy().astype(np.float64) * g1).astype(np.int64)
    f32 = (u.numpy() * g1.astype(np.float32)).astype(np.int64)
    assert (exact != f32).mean() > 0.1


# ------------------------------------------------------------- replay epochs

def _patched_epochs(w, batches, k_res, k_upd):
    """The JAX epoch's host logic (`SplitEpoch.__call__`) with its rollout
    replaced by one that hands out the synthetic batches and keys."""
    def fake_rollout(state):
        e = state.epoch
        return state._replace(epoch=e + 1), _j_batch(batches[e]), {}, k_res[e], k_upd[e]

    call = type(w.ep).__call__
    cells = dict(zip(call.__code__.co_freevars, call.__closure__))
    cells["rollout_jit"].cell_contents = fake_rollout
    return j_ea.DAggerState(student_params=w.params0, opt_state=w.opt0, stud_obs_rms=w.j_rms[0],
                            pcl_rms=w.j_rms[1], env_state=None, rng=None, epoch=0, agent_steps=0)


@pytest.mark.parametrize("stratify", [False, True], ids=["uniform", "stratified"])
def test_replay_epochs_match_the_jax_package(stratify):
    """Four epochs of reservoir writes and updates at K = 48, β annealed over
    64 samples (B = 16): the uniform reservoir fills in epoch 3 and samples in
    epoch 4; the stratified A half (24 rows) collects in epochs 1-3 (β 1,
    0.75, 0.5 ≥ 0.5), past its fill, and freezes in epoch 4, as in the JAX
    run; the reservoirs, cursors, fills, parameters and losses agree after
    each epoch."""
    w = World("r5", 48, replay_stratify=stratify, beta_anneal_steps=64.0)
    rng = np.random.default_rng(5)
    epochs = 4
    batches = [_batch(rng, w.da_flags) for _ in range(epochs)]
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * epochs)
    k_res, k_upd = keys[:epochs], keys[epochs:]
    j_state = _patched_epochs(w, batches, k_res, k_upd)
    res, te = w.t_epoch.reservoir, w.t_epoch
    frozen_at = None
    for e in range(epochs):
        j_state, jm = w.ep(j_state)
        te.scatter(_t_batch(batches[e]), _uniform(k_res[e]), _uniform(jax.random.fold_in(k_res[e], 1)))
        assert res.cursor == w.ep.cursor == B * (e + 1)
        if stratify:
            assert (res.cursor_a, res.a_frozen) == (w.ep.cursor_a, w.ep.a_frozen), e
            if res.a_frozen and frozen_at is None:
                frozen_at = e
            rows = _rows_strat(k_upd[e], res.fill_a, res.fill_b, res.k_a)
            _assert_rows_equal(w.ep.replay_a, res.rows, 0, res.k_a)
        else:
            rows = _rows_uniform(k_upd[e], res.fill_b)
        _assert_rows_equal(w.ep.replay_b, res.rows, res.k_a, res.k_a + res.k_b)
        aux = te.update(w.t_student, w.t_opt, res.rows, B, None, rows=rows)
        _assert_losses(jm, {k: float(v) for k, v in aux.items()})
        _assert_params(j_state.student_params, w.t_net, w.t_da.learning_rate, (e + 1) * MINI_EPOCHS * N_MB)
    if stratify:
        assert frozen_at == 3 and res.cursor_a == 48 and res.fill_a == 24


# ---------------------------------------------- latent loss, phase 3, no replay

def _one_update(w, seed):
    """One epoch's update of both packages on a synthetic batch written into
    a reservoir of exactly B rows in order (cursor 0: slot = sample)."""
    batch = _batch(np.random.default_rng(seed), w.da_flags)
    key_res, key_upd = jax.random.split(jax.random.PRNGKey(seed))
    replay = w.ep.scatter_b(_copy(w.replay0), _j_batch(batch), jnp.asarray(0, jnp.int32), key_res)
    j_params, _, j_aux = w.ep.update(w.params0, w.opt0, w.j_rms[0], w.j_rms[1], replay,
                                     jnp.asarray(B, jnp.int32), key_upd)
    w.t_epoch.scatter(_t_batch(batch), _uniform(key_res))
    aux = w.t_epoch.update(w.t_student, w.t_opt, w.t_epoch.reservoir.rows, B, None,
                           rows=_rows_uniform(key_upd, B))
    return j_params, j_aux, {k: float(v) for k, v in aux.items()}


def test_latent_loss_with_latent_injection_matches(ahead):
    """student_r3's configuration (tactile + seg + point cloud, the student's
    latent injected into the frozen teacher actor) with the latent term on:
    the gradient flows through the teacher's actor into the student."""
    w = ahead["r3"].result()
    j_params, j_aux, t_aux = _one_update(w, 9)
    assert t_aux["latent_loss"] > 0 and abs(t_aux["loss"] - t_aux["action_loss"] - 0.5 * t_aux["latent_loss"]) < 1e-5
    _assert_losses(j_aux, t_aux)
    _assert_params(j_params, w.t_net, w.t_da.learning_rate, MINI_EPOCHS * N_MB)
    assert not any(p.grad is not None and p.grad.abs().sum() > 0 for p in w.t_teacher.net.parameters())


def test_phase3_matches_optax_multi_transform(ahead):
    """Phase 3: only the decoder and the latent head train, clipped by their
    own global norm; every other parameter stays bitwise unchanged."""
    w = ahead["phase3"].result()
    before = _flat(student_to_jax_params(w.t_net.state_dict()))
    j_params, j_aux, t_aux = _one_update(w, 13)
    _assert_losses(j_aux, t_aux)
    _assert_params(j_params, w.t_net, w.t_da.learning_rate, MINI_EPOCHS * N_MB)
    j_after, t_after = _flat(jax.device_get(j_params)), _flat(student_to_jax_params(w.t_net.state_dict()))
    trained = [k for k in before if "/decoder/" in k or "/latent_head/" in k]
    assert trained and len(trained) < len(before)
    for k in before:
        if k in trained:
            assert not np.array_equal(t_after[k], before[k]), k
        else:
            np.testing.assert_array_equal(t_after[k], before[k], err_msg=k)
            np.testing.assert_array_equal(j_after[k], before[k], err_msg=k)


# ------------------------------------------------------ models and checkpoints

@pytest.mark.parametrize("flags", ["r5", "r3"])
def test_fresh_student_follows_the_flax_init(flags, ahead):
    """The port's fresh student has the reference's parameter tree (names
    and shapes, so its widths are those flax infers) and flax's initial
    statistics: zero biases, unit norm scales, kernels with the std of
    `lecun_normal` over their fan-in (to 15% where they hold ≥ 2,000 elements)."""
    j_cfg, t_cfg = _cfgs()
    da = t_ea.DAggerConfig(**FLAGS[flags])
    net = init_student_like_flax(t_ea._make_student(t_cfg, da), torch.Generator().manual_seed(0))
    t = _flat(student_to_jax_params(net.state_dict()))
    w = ahead["r3" if flags == "r3" else "phase3"].result()
    j = _flat(jax.device_get(w.params0))
    assert {k: v.shape for k, v in t.items()} == {k: v.shape for k, v in j.items()}
    for k, v in t.items():
        if k.endswith("/bias"):
            assert not v.any(), k
        elif k.endswith("/scale"):
            assert (v == 1).all(), k
        elif v.size >= 2000:
            np.testing.assert_allclose(v.std(), j[k].std(), rtol=0.15, err_msg=k)


@pytest.mark.parametrize("name", ["student_r5", "student_r3"])
def test_student_to_jax_params_inverts_convert_flax_params(name):
    tree = restore_path(os.path.join(CKPTS, name, "best_success"))["student_params"]
    back = student_to_jax_params(convert_flax_params(tree))
    a, b = _flat(tree), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32 and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    net = student_from_jax_params(tree, t_ea.DAggerConfig(**FLAGS[name[-2:]]),
                                  t_default_cfg().env, "cpu")
    leaves = _flat(student_to_jax_params(net.state_dict()))
    with torch.no_grad():      # the tree holds copies: moving the parameters leaves it as it was
        for p in net.parameters():
            p.add_(1.0)
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)


def test_a_port_checkpoint_loads_into_both_packages(tmp_path):
    """After one epoch, the trainer's checkpoint (`last.ckpt`) loads into the
    port's `StudentEvaluator` as the student-eval CLI loads it, and the JAX
    package's loader and student give the port student's outputs."""
    cfg, model, subs = t_default_cfg(), build_kuka_openhand(), build_subassembly_set()
    da = t_ea.DAggerConfig(horizon=2, mini_epochs=1)
    trainer = DAggerTrainer(cfg, da, model, subs, 2, str(tmp_path), TEACHER, device="cpu")
    trainer.state, _ = trainer.train_epoch(trainer.state)
    trainer.ckpt.save_last(trainer._ckpt_tree(), trainer.state.agent_steps)
    runner = StudentEvaluator(cfg, da, model, subs, 2, TEACHER, str(tmp_path / "last"), device="cpu")
    sd, loaded = trainer.state.net.state_dict(), runner.student.net.state_dict()
    assert sd.keys() == loaded.keys() and all(torch.equal(sd[k], loaded[k]) for k in sd)
    for a, b in zip(runner.student.stud_obs_rms, trainer.state.stud_obs_rms):
        assert torch.equal(a, b)
    j_tree = j_restore(str(tmp_path / "last"))
    assert set(j_tree) == {"student_params", "stud_obs_rms", "pcl_rms"}
    np.testing.assert_array_equal(np.asarray(j_tree["stud_obs_rms"].count),
                                  trainer.state.stud_obs_rms.count.numpy())
    obs = np.random.default_rng(0).normal(size=(3, 15)).astype(np.float32)
    j_out = jax.jit(JStudent(use_obs=True).apply)(j_tree["student_params"], obs=jnp.asarray(obs))
    with torch.no_grad():
        t_out = trainer.state.net(obs=torch.as_tensor(obs))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)


def test_dagger_learns_on_a_fixed_teacher():
    """The port's counterpart of tests/test_student.py::
    test_dagger_epoch_runs_and_learns_signal: a fresh PPO network as a fixed
    teacher, 4 envs, 4 epochs of horizon 4 in the teacher-only window; the
    loss falls and β stays above 0.999."""
    cfg, model, subs = t_default_cfg(), build_kuka_openhand(), build_subassembly_set()
    net, _, pstate, _ = t_ppo.build(cfg, t_ppo.PPOConfig(horizon=4, mini_epochs=2), model, subs, N, 0,
                                    device="cpu")
    teacher = t_ea.TeacherBundle(net=net.requires_grad_(False), obs_rms=pstate.obs_rms,
                                 priv_rms=pstate.priv_rms)
    da = t_ea.DAggerConfig(horizon=4, mini_epochs=2, teacher_only_steps=1e9)
    state, train_epoch = t_ea.build(cfg, da, model, subs, N, teacher, 1, device="cpu")
    losses = []
    for _ in range(4):
        state, m = train_epoch(state)
        losses.append(m["loss"])
    assert np.all(np.isfinite(losses)) and state.agent_steps == 4 * 16
    assert m["episode/beta"] > 0.999
    # the epoch's spans: the teacher's and the student's forwards, the Adam steps
    assert 0 < m["time/rollout.policy_s"] + m["time/env_s"] <= m["time/rollout_s"]
    assert 0 < m["time/update.adam_step_s"] <= m["time/update_s"]
    assert losses[-1] < losses[0]
