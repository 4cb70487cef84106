"""The port's grasp datasets (`envs/grasp_gen.py`), the resets that replay
them, the PPO training path that takes them and the pointer-jumping FK,
against the reference on the CPU. No JAX env step is compiled."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.envs.grasp_gen import load_grasp_data as j_load_grasp_data
from isaacgyminsertion_tpu.ops import rotations as j_rot
from isaacgyminsertion_tpu.physics import kinematics as j_kin
from isaacgyminsertion_tpu.physics.robot import SITE_FINGERTIP_CENTERED
from isaacgyminsertion_tpu.physics.robot import build_kuka_openhand as j_build_robot
from isaacgyminsertion_tpu_torch import cli
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import grasp_gen, insertion, vec_env
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.physics import kinematics
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand

torch.set_num_threads(1)

REF_DTYPES = {"sub_idx": np.int32, "dof_pos": np.float32, "socket_pos": np.float32,
              "socket_quat": np.float32, "plug_pos_hand": np.float32, "plug_quat_hand": np.float32}


@pytest.fixture(scope="module")
def world():
    return default_task_config(), build_kuka_openhand(), build_subassembly_set()


@pytest.fixture(scope="module")
def grasp_file(world, tmp_path_factory):
    """The port's generator at 4 envs × 1 round × 3 settling steps."""
    cfg, model, subs = world
    path = str(tmp_path_factory.mktemp("grasp") / "grasps.npz")
    n = grasp_gen.generate_grasp_dataset(cfg, model, subs, 4, 1, path, settle_steps=3, device="cpu")
    return path, n


def test_generated_file_has_the_reference_layout(grasp_file, world):
    path, n = grasp_file
    with np.load(path) as d:
        assert sorted(d.files) == sorted(REF_DTYPES)
        for k, dtype in REF_DTYPES.items():
            assert d[k].dtype == dtype and d[k].shape[0] == n, k
        assert d["dof_pos"].shape[1:] == (15,) and d["plug_quat_hand"].shape[1:] == (4,)
    assert n > 0     # settled grasps hold over 3 steps


def test_load_grasp_data_matches_the_reference(grasp_file, world, tmp_path):
    """The port's table and counts equal the reference's on the port's file
    with one synthetically tilted row added; the port drops that row (its
    table equals the one of the file without it)."""
    path, n = grasp_file
    _, model, subs = world
    n_sub = len(subs.names)
    with np.load(path) as d:
        raw = {k: d[k] for k in d.files}
    tilted = {k: v[-1:].copy() for k, v in raw.items()}
    tilted["plug_quat_hand"][:] = np.asarray([np.sin(0.45), 0, 0, np.cos(0.45)])
    bad_path = str(tmp_path / "grasps_bad.npz")
    np.savez_compressed(bad_path, **{k: np.concatenate([raw[k], tilted[k]]) for k in raw})
    mine = grasp_gen.load_grasp_data(bad_path, n_sub=n_sub, model=model)
    ref = j_load_grasp_data(bad_path, n_sub=n_sub, model=j_build_robot())
    for a, b, name in zip(mine, ref, grasp_gen.GraspData._fields):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b, name in zip(mine, grasp_gen.load_grasp_data(path, n_sub=n_sub, model=model),
                          grasp_gen.GraspData._fields):
        np.testing.assert_array_equal(a, b, err_msg=f"{name}: the tilted row was not dropped")
    # without a model nothing is filtered
    assert int(grasp_gen.load_grasp_data(bad_path, n_sub=n_sub).count.sum()) == n + 1


def _one_row_table(cfg, model, subs, rng):
    """One row per subassembly: dofs and socket poses of an analytic reset,
    small random plug-in-hand poses."""
    n_sub = len(subs.names)
    with torch.no_grad():
        st = insertion.reset_all(cfg, model, subs, insertion.make_generator(11, "cpu"), n_sub)
    quat = np.concatenate([0.05 * rng.normal(size=(n_sub, 3)), np.ones((n_sub, 1))], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    rows = dict(
        sub_idx=np.arange(n_sub, dtype=np.int32), dof_pos=st.phys.q.numpy(),
        socket_pos=st.params.socket_pos.numpy(), socket_quat=st.params.socket_quat.numpy(),
        plug_pos_hand=(np.asarray([0.0, 0.0, -0.05]) + 0.005 * rng.normal(size=(n_sub, 3))).astype(np.float32),
        plug_quat_hand=quat.astype(np.float32))
    return rows


def test_reset_from_the_table(world, tmp_path):
    """Every env starts from its subassembly's row: the arm and base dofs and
    the socket pose equal the row's (the fingers are closed onto the plug
    again, as the reference closes them), the plug pose equals the
    reference's `tf_combine(site_pose(forward_kinematics(q_row)), row)`
    (1e-5). Resets inside `step` replay the table too."""
    cfg, model, subs = world
    rows = _one_row_table(cfg, model, subs, np.random.default_rng(0))
    path = str(tmp_path / "rows.npz")
    np.savez_compressed(path, **rows)
    table = grasp_gen.load_grasp_data(path, n_sub=len(subs.names))
    assert (table.count == 1).all()
    n = 8
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, insertion.make_generator(3, "cpu"), n, grasp_data=table)
    sub = state.sub_idx.numpy()
    q_row = rows["dof_pos"][sub]
    keep = [0, 1, 2, 3, 4, 5, 6, 7, 10]              # arm and hand-base joints
    np.testing.assert_array_equal(state.phys.q.numpy()[:, keep], q_row[:, keep])
    np.testing.assert_array_equal(state.params.socket_pos.numpy(), rows["socket_pos"][sub])
    np.testing.assert_array_equal(state.params.socket_quat.numpy(), rows["socket_quat"][sub])
    jm = j_build_robot()
    hq, ht = j_kin.site_pose(jm, j_kin.forward_kinematics(jm, jnp.asarray(q_row)), SITE_FINGERTIP_CENTERED)
    pq, pp = j_rot.tf_combine(hq, ht, jnp.asarray(rows["plug_quat_hand"][sub]),
                              jnp.asarray(rows["plug_pos_hand"][sub]))
    np.testing.assert_allclose(state.phys.plug_pos.numpy(), np.asarray(pp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.phys.plug_quat.numpy(), np.asarray(pq), rtol=1e-5, atol=1e-5)

    # _reset_idx inside step: the reset envs take their rows again
    state = state._replace(reset_buf=torch.tensor([True, False] * (n // 2)))
    with torch.no_grad():
        s2, out = insertion.step(cfg, model, subs, state, torch.zeros((n, 6)),
                                 insertion.make_generator(4, "cpu"), grasp_data=table)
    assert bool(torch.isfinite(out.rew).all())
    np.testing.assert_array_equal(s2.params.socket_pos.numpy(), rows["socket_pos"][s2.sub_idx.numpy()])


def test_reset_without_a_table_draws_as_before(world):
    """Without a table the reset draws exactly as the analytic resets did
    before grasp datasets were ported (the values of that code at seed 3,
    4 envs, then a masked reset of envs 0 and 2, then three uniforms)."""
    cfg, model, subs = world
    gen = insertion.make_generator(3, "cpu")
    with torch.no_grad():
        s = insertion.reset_all(cfg, model, subs, gen, 4)
        assert s.params.socket_scale.tolist() == [1.0167717933654785, 1.0329498052597046,
                                                  1.0296680927276611, 1.0647684335708618]
        assert s.phys.q.double().sum().item() == pytest.approx(16.378623939468525, rel=1e-6)
        assert s.phys.plug_pos.double().sum().item() == pytest.approx(2.33141509629786, rel=1e-6)
        mask = torch.tensor([True, False, True, False])
        s2 = insertion._reset_idx(cfg, model, subs, s._replace(reset_buf=mask), mask, gen)
        assert s2.params.socket_scale.tolist() == [1.0283063650131226, 1.0329498052597046,
                                                   1.0930838584899902, 1.0647684335708618]
        assert s2.phys.q.double().sum().item() == pytest.approx(17.257221993990242, rel=1e-6)
    assert torch.rand(3, generator=gen).tolist() == [0.441534161567688, 0.7592723369598389,
                                                      0.9568637609481812]


def test_forward_kinematics_jump_matches_the_serial_walk(world):
    _, model, _ = world
    q = np.random.default_rng(2).uniform(-1.5, 1.5, (5, 15)).astype(np.float32)
    jump = kinematics.forward_kinematics_jump(model, torch.as_tensor(q))
    serial = kinematics.forward_kinematics(model, torch.as_tensor(q))
    jm = j_build_robot()
    ref_jump = j_kin.forward_kinematics_jump(jm, jnp.asarray(q))
    ref_serial = j_kin.forward_kinematics(jm, jnp.asarray(q))
    for a, b, c, d, name in zip(jump, serial, ref_jump, ref_serial, kinematics.FK._fields):
        for other in (b, c, d):
            np.testing.assert_allclose(a.numpy(), np.asarray(other), rtol=1e-5, atol=1e-5, err_msg=name)


def test_grasp_task_and_training_cli_take_the_dataset(grasp_file, tmp_path):
    """`vec_env.make("FactoryTaskGraspTactile")` writes a dataset; the PPO
    training CLI parses `grasp_dataset=` and trains one epoch on the CPU with
    resets from it; `FactoryTaskOptimizeTactile` builds the sys-id task."""
    task = vec_env.make("FactoryTaskGraspTactile", num_envs=2, device="cpu")
    n = task.run(n_rounds=1, out_path=str(tmp_path / "g.npz"), settle_steps=2)
    with np.load(tmp_path / "g.npz") as d:
        assert d["sub_idx"].shape == (n,)
    assert isinstance(vec_env.make("FactoryTaskOptimizeTactile", device="cpu"), vec_env.SysIdTask)
    path, _ = grasp_file
    argv = ["train.algo=PPO", "test=False", f"grasp_dataset={path}", "num_envs=2",
            "train.ppo.horizon_length=2", "train.ppo.mini_epochs=1", "max_epochs=1", "seed=0",
            "task.rl.max_episode_length=2", "eval_freq_steps=1e12", "device=cpu", f"output={tmp_path / 'ppo'}"]
    args = cli.parse_args(argv)
    assert args["grasp_dataset"] == path and args["task"].grasp_at_init is False
    assert cli.parse_args(["task.grasp_dataset=x.npz"])["grasp_dataset"] == "x.npz"
    tr = cli.main(argv)
    table = tr.train_epoch.grasp_data
    assert isinstance(table, grasp_gen.GraspData) and tr.state.agent_steps == 4
    assert all(bool(torch.isfinite(p).all()) for p in tr.net.parameters())
    assert cli.main(argv[:-1] + ["task.grasp_at_init=True", f"output={tmp_path / 'ppo2'}"]) \
        .train_epoch.grasp_data is None
