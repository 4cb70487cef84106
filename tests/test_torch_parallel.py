"""Data-parallel PPO (`parallel/`, `algo/ppo.py` with `dp=`) on the CPU.

The sharded epoch runs on two gloo ranks, spawned processes that meet
through a `file://` rendezvous, and is held to the port's single-process
epoch on the same inputs: one `reset_all` of the whole batch split by rows,
the same network, the same action noise (each rank gets its rows) and the
same permutations of the global batch, with DR, delays and sensor noise off.
The bars are those of `tests/test_multichip.py` (loss and reward rtol 2e-4,
sensor queues 2e-3), the parameters those of the PPO slice test (2e-5, but
for at most 0.01% of the elements, which stay within 2 · lr · steps: Adam
moves an element by ~lr a step whatever its gradient's size, so a gradient
at the level of rounding, whose sign the two summation orders can flip,
parts the two runs by up to 2 · lr a step). The two ranks end bitwise equal.
The single-process epoch is held to the JAX package's by
`tests/test_torch_ppo_slice.py`, so no JAX epoch is compiled here.

The sensors-on case runs 48 envs: at 16 the 0.75 capacity selects every row
(k = 16), while at 48 the global selection (k = 40) differs from what each
rank would select from its own 24 rows (all of them). The renderers' noise is
patched off on both sides; the point clouds sample their points from each
side's own generator, so they are held by their centroids, as in
`tests/test_torch_student_slice.py`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from isaacgyminsertion_tpu_torch.algo import ppo
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import insertion
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.models.actor_critic import ActorCriticSplit, init_like_flax
from isaacgyminsertion_tpu_torch.models.running_mean_std import rms_init
from isaacgyminsertion_tpu_torch.parallel import dryrun, mesh
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand

torch.set_num_threads(1)

HORIZON, MINI_EPOCHS, WORLD = 2, 2, 2
CASES = {"state_only": 16, "sensors_on": 48}
_ENV = default_task_config().env
OBS_DIM, PRIV_DIM = _ENV.num_obs_hist * _ENV.num_observations, _ENV.num_states


def _cfg(sensors: bool):
    cfg = default_task_config()
    env = dict(action_delay_prob_max=0.0, plug_obs_delay_prob=0.0)
    if sensors:
        env.update(tactile=True, external_cam=True, depth_cam=True, seg_cam=True, pcl_cam=True,
                   render_capacity=0.75, tactile_delay_prob=0.0, img_delay_prob=0.0,
                   seg_delay_prob=0.0, pcl_prob_noise=0.0, seg_prob_noise=0.0)
    return cfg.replace(randomize=dataclasses.replace(cfg.randomize, domain_randomize=False),
                       env=dataclasses.replace(cfg.env, **env))


def _noise_off_and_record(setattr_, selections: list):
    """The renderers' pixel and depth noise off; each render selection
    appended to `selections` as (global step, sorted global rows)."""
    render_tactile, render_depth_seg = insertion.tact_mod.render_tactile, insertion.cam_mod.render_depth_seg
    select = insertion.render_selection

    def recorded(prio, capacity, global_step, dp=None):
        sel = select(prio, capacity, global_step, dp)
        lo = 0 if dp is None else dp.rows(prio.shape[0] * dp.world_size)[0]
        selections.append((global_step, sorted((sel + lo).tolist())))
        return sel

    setattr_(insertion.tact_mod, "render_tactile",
             lambda *a, **kw: render_tactile(*a, **{**kw, "noise_std": 0.0}))
    setattr_(insertion.cam_mod, "render_depth_seg",
             lambda *a, **kw: render_depth_seg(*a, **{**kw, "generator": None}))
    setattr_(insertion, "render_selection", recorded)


def _state(net, env_state, rank=0):
    return ppo.PPOState(
        net=net, optimizer=ppo.make_optimizer(net.parameters(), ppo.PPOConfig().learning_rate),
        obs_rms=rms_init((OBS_DIM,)), priv_rms=rms_init((PRIV_DIM,)), value_rms=rms_init(()),
        env_state=env_state, env_gen=insertion.make_generator(mesh.rank_seed(5, rank), "cpu"),
        train_gen=insertion.make_generator(mesh.rank_seed(6, rank), "cpu"), epoch=0, agent_steps=0)


def _rank_epoch(rank, init_method, inputs, out_dir):
    """A rank of the sharded epoch: its rows of the saved inputs → its end
    state, metrics and render selections in `out_dir/rank<r>.pt`."""
    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    dp = mesh.init("gloo", rank, WORLD, init_method, "cpu")
    try:
        selections = []
        if data["sensors"]:
            _noise_off_and_record(setattr, selections)
        net = ActorCriticSplit(obs_dim=OBS_DIM, priv_dim=PRIV_DIM)
        net.load_state_dict(data["params"])
        state = _state(net, mesh.shard_env_batch(data["env_state"], dp), rank)
        lo, hi = dp.rows(data["n"])
        te = ppo.TrainEpoch(_cfg(data["sensors"]), ppo.PPOConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS),
                            build_kuka_openhand(), build_subassembly_set(), dp=dp)
        state, metrics = te(state, noise=[x[lo:hi] for x in data["noise"]], perms=data["perms"])
        torch.save(dict(metrics=metrics, params=net.state_dict(), digest=dryrun.state_digest(state),
                        rms=[list(r) for r in (state.obs_rms, state.priv_rms, state.value_rms)],
                        env_state=state.env_state, agent_steps=state.agent_steps,
                        rows=torch.tensor(te.render_rows), selections=selections),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.close(dp)


@pytest.fixture(scope="module")
def model_subs():
    return build_kuka_openhand(), build_subassembly_set()


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_epoch_matches_the_single_process(case, model_subs, monkeypatch, tmp_path):
    sensors, n = case == "sensors_on", CASES[case]
    cfg, (model, subs) = _cfg(sensors), model_subs
    ppo_cfg = ppo.PPOConfig(horizon=HORIZON, mini_epochs=MINI_EPOCHS)
    with torch.no_grad():
        env_state = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, "cpu"), n)
    net = init_like_flax(ActorCriticSplit(obs_dim=OBS_DIM, priv_dim=PRIV_DIM), torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    noise = [torch.as_tensor(rng.standard_normal((n, cfg.env.num_actions)), dtype=torch.float32)
             for _ in range(HORIZON)]
    perms = [torch.as_tensor(rng.permutation(HORIZON * n)) for _ in range(MINI_EPOCHS)]
    inputs = str(tmp_path / "inputs.pt")
    torch.save(dict(sensors=sensors, n=n, params=net.state_dict(), env_state=env_state, noise=noise,
                    perms=perms), inputs)
    # the sharded epoch runs in the two spawned ranks while this process runs the single one
    ctx = tmp.spawn(_rank_epoch, args=(f"file://{tmp_path / 'rendezvous'}", inputs, str(tmp_path)),
                    nprocs=WORLD, join=False)

    selections = []
    if sensors:
        _noise_off_and_record(monkeypatch.setattr, selections)
    single = _state(net, env_state)
    te = ppo.TrainEpoch(cfg, ppo_cfg, model, subs)
    single, m1 = te(single, noise=noise, perms=perms)
    while not ctx.join(timeout=300):
        pass
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    # the two ranks end bitwise equal
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    m2 = ranks[0]["metrics"]
    assert {k: v for k, v in m2.items() if not k.startswith("time/")} == \
        {k: v for k, v in ranks[1]["metrics"].items() if not k.startswith("time/")}
    assert ranks[0]["agent_steps"] == single.agent_steps == HORIZON * n
    _close(m1["loss"], m2["loss"], 2e-4, 0.0, "loss")
    _close(m1["episode/reward"], m2["episode/reward"], 2e-4, 0.0, "reward")
    for k in ("a_loss", "c_loss", "kl", "diag/adv_std", "diag/value_mean", "diag/return_mean"):
        _close(m1[k], m2[k], 1e-3, 1e-6, k)
    for a, b in zip((single.obs_rms, single.priv_rms, single.value_rms), ranks[0]["rms"]):
        for x, y in zip(a, b):
            _close(x, y, 1e-5, 1e-5, "normalizer")
    # parameters: 2e-5, but for ≤ 0.01% of the elements, within 2 · lr · steps
    steps = MINI_EPOCHS * 2
    d = np.concatenate([np.abs(p.detach().numpy() - ranks[0]["params"][k].numpy()).ravel()
                        for k, p in net.state_dict().items()])
    assert (d > 2e-5).mean() <= 1e-4 and d.max() <= 2 * ppo_cfg.learning_rate * steps, \
        ((d > 2e-5).sum(), d.max())
    # the env: each rank stepped its own rows
    halves = [mesh.shard_env_batch(single.env_state, mesh.DataParallel(r, WORLD, None, "cpu", "gloo"))
              for r in range(WORLD)]
    for half, rank in zip(halves, ranks):
        _close(half.phys.q, rank["env_state"].phys.q, 1e-5, 1e-5, "q")
    if not sensors:
        return
    # the global selection: the rows the single process rendered, split over the ranks
    k = insertion.render_count(n, cfg.env.render_capacity)
    assert k < n
    rows = ranks[0]["rows"] + ranks[1]["rows"]
    assert rows.eq(k).all(), rows
    assert len(selections) == 2 * HORIZON
    for i, (gs, sel) in enumerate(selections):
        got = ranks[0]["selections"][i][1] + ranks[1]["selections"][i][1]
        assert ranks[0]["selections"][i][0] == gs and sorted(got) == sel and len(sel) == k
    for half, rank in zip(halves, ranks):
        for name in ("tactile_queue", "img_queue", "seg_queue"):
            _close(getattr(half, name).float(), getattr(rank["env_state"], name).float(), 0.0, 2e-3, name)
        # point clouds: the same rows filled, the plug and socket slices' centroids close
        pj, pt = half.pcl_queue[:, 0].numpy(), rank["env_state"].pcl_queue[:, 0].numpy()
        for sl in (slice(0, 400), slice(400, 800)):
            np.testing.assert_array_equal(np.abs(pj[:, sl]).sum((1, 2)) > 0, np.abs(pt[:, sl]).sum((1, 2)) > 0)
            tol = np.maximum(2e-3, 4.0 * np.sqrt(2.0 / 400.0) * pj[:, sl].std(1))
            assert (np.abs(pj[:, sl].mean(1) - pt[:, sl].mean(1)) < tol).all(), sl
    assert float(single.env_state.tactile_queue.float().abs().max()) > 0


def test_dryrun_on_two_cpu_ranks_prints_both_ok_lines_and_the_ranks_draw_apart(capsys):
    results = dryrun.dryrun(2, "gloo", "cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2) ok:" in out and "dryrun_multichip(2) sensors-on ok:" in out
    zero = {"contact_solver": 0, "contact_gen": 0, "tactile_render": 0, "camera_render": 0}
    for spec_i, want in enumerate((zero,) * 2):
        assert [r[spec_i]["counts"] for r in results] == [want] * 2   # CPU: the plain versions
        assert {r[spec_i]["agent_steps"] for r in results} == {2 * 8}
    # one seed, two ranks: their envs and their action noise are not the same draws
    a, b = results[0][0]["first"], results[1][0]["first"]
    assert a["socket_pos"] != b["socket_pos"] and a["noise"] != b["noise"]


def test_shard_env_batch_splits_rows_and_raises_on_an_uneven_split(model_subs):
    cfg, (model, subs) = default_task_config(), model_subs
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, "cpu"), 6)
    half = mesh.shard_env_batch(state, mesh.DataParallel(1, 2, None, torch.device("cpu"), "gloo"))
    assert torch.equal(half.phys.q, state.phys.q[3:]) and half.global_step == state.global_step
    assert torch.equal(half.params.socket_pos, state.params.socket_pos[3:])
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_env_batch(state, mesh.DataParallel(0, 4, None, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="do not split"):
        ppo.build(cfg, ppo.PPOConfig(horizon=2), model, subs, 6, 0,
                  dp=mesh.DataParallel(0, 4, None, torch.device("cpu"), "gloo"))


def test_rank_seeds_keep_rank_0_and_part_every_rank_on_the_cpu():
    assert mesh.rank_seed(7, 0) == 7
    draws = {float(torch.rand(1, generator=insertion.make_generator(mesh.rank_seed(7, r), "cpu")))
             for r in range(4)}
    assert len(draws) == 4


def test_collectives_are_the_identity_without_dp():
    x = torch.randn((5, 3, 4), generator=torch.Generator().manual_seed(0))
    assert mesh.size(None) == 1
    assert mesh.all_reduce_(x, None) is x and mesh.broadcast_(x, None) is x
    assert mesh.all_gather_rows(x, None) is x
    assert torch.equal(mesh.sum_(x, None), torch.sum(x)) and torch.equal(mesh.mean(x, None), torch.mean(x))
    n, m, v = mesh.moments(x, (0, 1), None)
    assert n == 15 and torch.equal(m, torch.mean(x, dim=(0, 1)))
    assert torch.equal(v, torch.var(x, dim=(0, 1), correction=0))


def test_the_rank_selections_chip_smoke_holds_are_what_each_rank_selects(monkeypatch):
    from isaacgyminsertion_tpu_torch.utils import capture

    n_rank, world, cap = 24, 2, 0.75
    sels = capture.rank_selections(n_rank, world, cap, "cpu", steps=6)
    prio = torch.randint(0, 3, (n_rank * world,), generator=insertion.make_generator(0, "cpu"))
    monkeypatch.setattr(mesh, "all_gather_rows", lambda t, dp: prio)   # the gathered global vector
    for step, per_rank in enumerate(sels):
        assert sum(len(s) for s in per_rank) == insertion.render_count(n_rank * world, cap)
        for r, got in enumerate(per_rank):
            dp = mesh.DataParallel(r, world, None, torch.device("cpu"), "gloo")
            want = insertion.render_selection(prio[r * n_rank:(r + 1) * n_rank], cap, step, dp)
            assert torch.equal(got, want), (step, r)
