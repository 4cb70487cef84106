"""The port's CycleGAN runner (`algo/gan_runner.py`) and its sim→real hook on
the env's tactile frames against the reference, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isaacgyminsertion_tpu.algo.gan_runner import CycleGANConfig as JaxConfig
from isaacgyminsertion_tpu.algo.gan_runner import CycleGANRunner as JaxRunner
from isaacgyminsertion_tpu.models.zoo import PatchDiscriminator as JaxDiscriminator
from isaacgyminsertion_tpu.models.zoo import ResnetGenerator as JaxGenerator
from isaacgyminsertion_tpu.utils.checkpoint import restore_path as j_restore
from isaacgyminsertion_tpu_torch import cli
from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea
from isaacgyminsertion_tpu_torch.algo.gan_runner import CycleGANConfig, CycleGANRunner
from isaacgyminsertion_tpu_torch.algo.trainer import DAggerTrainer
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import insertion
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.models import zoo
from isaacgyminsertion_tpu_torch.models.student import convert_flax_params
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
from isaacgyminsertion_tpu_torch.sensors import tactile as tact_mod

torch.set_num_threads(1)

TEACHER = "checkpoints/teacher_r2b/best_success"


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


# an element whose reference gradient is below GRAD_ZERO of the step's largest
# is zero to rounding: Adam's first moments then carry the rounding noise and
# its update can take either sign: up to 2 lr away from the reference's. A
# conv kernel's gradient sums over the batch and every pixel behind the
# GroupNorms, and the two packages' gradients of one element differ by up to
# ~2e-5 of the step's largest, hence 1e-4 (PR 7's dense students: 1e-5)
GRAD_ZERO = 1e-4


def _sync_adam(opt, nets, names, state):
    """Load an optax adam state (count, first and second moments as flax
    trees per net) into a torch Adam over `nets`' parameters."""
    adam = state[0]
    for net, name in zip(nets, names):
        mu = convert_flax_params(np_tree(adam.mu[name]))
        nu = convert_flax_params(np_tree(adam.nu[name]))
        for key, p in net.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[key].clone(),
                            "exp_avg_sq": nu[key].clone()}


def _grads_of(old, new, b1=0.5):
    """The gradient of a step, from the first moments before and after it."""
    return {k: (np.asarray(new[k], np.float64) - b1 * np.asarray(old[k], np.float64)) / (1.0 - b1)
            for k in new}


def _reference_runner(shape, seed=0):
    """The reference's `CycleGANRunner` as its `__init__` builds it (nets,
    parameters drawn as it draws them, `optax.adam(lr, b1=0.5)` and its
    states), with the inits jitted: its eager ones take 14 s on the CPU."""
    j = object.__new__(JaxRunner)
    j.cfg = JaxConfig()
    j.G_ab, j.G_ba, j.D_a, j.D_b = JaxGenerator(), JaxGenerator(), JaxDiscriminator(), JaxDiscriminator()
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    dummy = jnp.zeros((1,) + shape)
    init_g, init_d = jax.jit(j.G_ab.init), jax.jit(j.D_a.init)   # one compile each for the twin nets
    j.params = {"g_ab": init_g(k[0], dummy), "g_ba": init_g(k[1], dummy),
                "d_a": init_d(k[2], dummy), "d_b": init_d(k[3], dummy)}
    j.tx_g = optax.adam(j.cfg.learning_rate, b1=0.5)
    j.tx_d = optax.adam(j.cfg.learning_rate, b1=0.5)
    j.opt_g = j.tx_g.init({"g_ab": j.params["g_ab"], "g_ba": j.params["g_ba"]})
    j.opt_d = j.tx_d.init({"d_a": j.params["d_a"], "d_b": j.params["d_b"]})
    return j


def test_cyclegan_steps_match_the_reference(tmp_path):
    """Three steps at 16 × 16 against the reference's step function (from
    `_make_train_step()`, jitted) on the same weights and batches. Each step
    starts both packages from the reference's parameters and Adam moments, so
    that an element's first update, which Adam takes as ±lr whatever the size
    of its gradient, cannot carry a rounding difference into the next step:
    losses 1e-5; every parameter of the four nets 2e-5, or 2 lr where the
    reference's gradient is zero to rounding. The port's checkpoint is read by
    the reference's `restore_path` and its `g_ab` applied by the reference's
    `ResnetGenerator` equals the port's `translate` (1e-4)."""
    shape = (16, 16, 3)
    j = _reference_runner(shape)
    t = CycleGANRunner(CycleGANConfig(epochs=1, batch_size=4), str(tmp_path / "port"),
                       image_shape=shape, device="cpu")
    step = jax.jit(j._make_train_step())
    params, opt_g, opt_d = j.params, j.opt_g, j.opt_d
    lr = t.cfg.learning_rate
    rng = np.random.default_rng(0)
    for i in range(3):
        for name, net in t.nets.items():
            zoo.load_jax_params(net, np_tree(params[name]))
        _sync_adam(t.opt_g, (t.G_ab, t.G_ba), ("g_ab", "g_ba"), opt_g)
        _sync_adam(t.opt_d, (t.D_a, t.D_b), ("d_a", "d_b"), opt_d)
        a = rng.uniform(-1, 1, (4,) + shape).astype(np.float32)
        b = np.tanh(rng.normal(size=(4,) + shape)).astype(np.float32)
        mu_old = {**_flat(np_tree(opt_g[0].mu)), **_flat(np_tree(opt_d[0].mu))}
        params, opt_g, opt_d, m_j = step(params, opt_g, opt_d, jnp.asarray(a), jnp.asarray(b))
        m_t = t.train_step(torch.as_tensor(a), torch.as_tensor(b))
        for k in ("g_loss", "d_loss", "cycle", "adv"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i} {k}")
        grads = _grads_of(mu_old, {**_flat(np_tree(opt_g[0].mu)), **_flat(np_tree(opt_d[0].mu))})
        pj, pt = _flat(np_tree(params)), _flat(t.jax_params())
        assert sorted(pj) == sorted(pt) == sorted(grads)
        for group in ("g_", "d_"):
            scale = max(float(np.abs(g).max()) for k, g in grads.items() if k.startswith(group))
            for key in (k for k in pj if k.startswith(group)):
                tol = np.where(np.abs(grads[key]) > GRAD_ZERO * scale, 2e-5, 2 * lr)
                err = np.abs(pt[key] - pj[key])
                assert (err <= tol).all(), (i, key, float(err.max()), int((tol > 2e-5).sum()))

    # fit writes last.ckpt in the reference's layout
    sim = rng.uniform(-1, 1, (8,) + shape).astype(np.float32)
    real = rng.uniform(-1, 1, (9,) + shape).astype(np.float32)
    m = t.fit(sim, real)
    assert len(t.step_metrics) == 2 and all(np.isfinite(v) for v in m.values())
    tree = j_restore(str(tmp_path / "port" / "last"))
    assert sorted(tree["params"]) == ["d_a", "d_b", "g_ab", "g_ba"]
    x = sim[:2]
    out_j = jax.jit(JaxGenerator().apply)(tree["params"]["g_ab"], jnp.asarray(x))
    np.testing.assert_allclose(t.translate(x).numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def world():
    cfg = cli._set_path(default_task_config(), "env.tactile", True)
    return cfg, build_kuka_openhand(), build_subassembly_set()


@pytest.mark.parametrize("capacity", [1.0, 0.5])
def test_env_hook_translates_the_rendered_frames(world, capacity):
    """Four env steps with the generator: each leaves in the tactile queue
    what the same step without it leaves when its renderer hands out the
    generator's translation of the frames it rendered (the same state and
    RNG state), for all rows rendered and for the gathered render-on-demand
    rows; fresh frames go in and stay in [0, 1]."""
    cfg, model, subs = world
    cfg = cli._set_path(cfg, "env.render_capacity", capacity)
    g = zoo.init_like_flax(zoo.ResnetGenerator(), torch.Generator().manual_seed(3)).eval()
    render = tact_mod.render_tactile

    def translated(*args, **kw):
        img = render(*args, **kw)
        return (g(img.reshape((-1,) + img.shape[2:]) * 2.0 - 1.0).reshape(img.shape) + 1.0) * 0.5

    gen = insertion.make_generator(0, "cpu")
    fresh = 0
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, gen, 2)
        for _ in range(4):
            gen_b = insertion.make_generator(0, "cpu")
            gen_b.set_state(gen.get_state())
            act = torch.zeros((2, 6))
            s_hook, _ = insertion.step(cfg, model, subs, state, act, gen, gan=g)
            tact_mod.render_tactile = translated
            try:
                s_ref, _ = insertion.step(cfg, model, subs, state, act, gen_b)
            finally:
                tact_mod.render_tactile = render
            assert torch.equal(s_hook.tactile_queue, s_ref.tactile_queue)
            slot = s_hook.tactile_queue[:, 0].float()
            assert float(slot.min()) >= 0.0 and float(slot.max()) <= 1.0
            fresh += int((slot != state.tactile_queue[:, 0].float()).flatten(1).any(1).sum())
            state = s_hook
    assert fresh > 0


def test_dagger_trainer_runs_the_generator_in_the_rollout(world, tmp_path):
    """`DAggerTrainer(gan_ckpt_path=)` loads `g_ab` of a CycleGAN checkpoint
    and its rollout step runs it on the tactile frames."""
    cfg, model, subs = world
    runner = CycleGANRunner(CycleGANConfig(epochs=1, batch_size=2), str(tmp_path / "gan"),
                            image_shape=(64, 64, 3), device="cpu")
    runner.ckpt.save_last({"params": runner.jax_params()}, 0)
    da = ea.DAggerConfig(horizon=1, mini_epochs=1, use_tactile=True)
    trainer = DAggerTrainer(cfg, da, model, subs, 2, str(tmp_path / "s"), TEACHER,
                            gan_ckpt_path=str(tmp_path / "gan" / "last"), device="cpu")
    gan = trainer.train_epoch.gan
    assert isinstance(gan, zoo.ResnetGenerator) and not gan.training
    sd = runner.G_ab.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in gan.state_dict().items())
    calls = []
    gan.register_forward_hook(lambda m, i, o: calls.append(tuple(i[0].shape)))
    env_state, sample, m, beta = trainer.train_epoch.rollout_step(trainer.state, trainer.state.env_state, 0)
    assert calls == [(6, 64, 64, 3)] and bool(torch.isfinite(m).all())
    assert tuple(sample["tactile"].shape[:2]) == (2, cfg.env.tactile_history_len)
