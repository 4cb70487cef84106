"""The data layer, port vs JAX package, on synthetic numpy data: the logger
writes the same trajectory files for the same chunks (both writers), the
`.itraj` files of the two packages are the same bytes and each reads the
other's, and the normalizer, the split, the batches and the `data_io`
utilities give the same results.

Tolerances: files, arrays, splits and batches exact; normalizer statistics
1e-6 relative."""

import os
import warnings

import numpy as np
import pytest

from isaacgyminsertion_tpu import native as j_native
from isaacgyminsertion_tpu.data import data_io as j_io
from isaacgyminsertion_tpu.data import dataset as j_ds
from isaacgyminsertion_tpu.data import logger as j_log
from isaacgyminsertion_tpu_torch import native as t_native
from isaacgyminsertion_tpu_torch.data import data_io as t_io
from isaacgyminsertion_tpu_torch.data import dataset as t_ds
from isaacgyminsertion_tpu_torch.data import logger as t_log

N_ENVS, T = 3, 7


def _chunks(seed=0, n_chunks=3):
    """Rollout chunks in the collector's key order and dtypes ([T, N, ...]),
    with episodes of several lengths, a 1-step episode (dropped) and the
    sensor side arrays in their float16 / int8 storage types."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=(T, N_ENVS) + s).astype(np.float32)
    out = []
    for c in range(n_chunks):
        done = rng.random((T, N_ENVS)) < 0.3
        if c == 0:
            done[0, 2] = done[1, 2] = True      # env 2: a 1-step trajectory
        out.append(dict(
            obs=f32(15), student_obs=f32(15), priv_info=f32(64), actions=f32(6), latent=f32(8),
            eef_pos=f32(3), eef_quat=f32(4), rewards=f32(), done=done,
            success=(rng.random((T, N_ENVS)) < 0.5).astype(np.float32),
            plug_pos=f32(3), plug_quat=f32(4), socket_pos=f32(3), socket_quat=f32(4),
            img=f32(6, 8).astype(np.float16), seg=rng.integers(0, 4, (T, N_ENVS, 6, 8)).astype(np.int8),
            pcl=f32(10, 3).astype(np.float16),
        ))
    return out


def _read_dir(path, read):
    files = sorted(f for f in os.listdir(path) if f.endswith((".npz", ".itraj")))
    out = {}
    for f in files:
        if f.endswith(".itraj"):
            out[f] = read(os.path.join(path, f))
        else:
            with np.load(os.path.join(path, f)) as d:
                out[f] = {k: np.asarray(d[k]) for k in d}
    return out


def _assert_same_trees(a, b):
    assert list(a) == list(b)
    for f in a:
        assert sorted(a[f]) == sorted(b[f]), f
        for k in a[f]:
            assert a[f][k].dtype == b[f][k].dtype, (f, k)
            np.testing.assert_array_equal(a[f][k], b[f][k], err_msg=f"{f}:{k}")


@pytest.mark.parametrize("use_native", [True, False], ids=["itraj", "npz"])
def test_logger_writes_the_same_trajectories(tmp_path, use_native, capsys):
    if use_native and (j_native.load() is None or t_native.load() is None):
        pytest.skip("g++ or zlib unavailable")
    dirs = {}
    for name, mod in (("jax", j_log), ("torch", t_log)):
        dirs[name] = str(tmp_path / name)
        lg = mod.DataLoggerSim(dirs[name], N_ENVS, max_len=5, total_trajectories=6,
                               use_native=use_native)
        for ch in _chunks():
            lg.add_chunk(ch)
        lg.close()
    out = capsys.readouterr().out
    assert ("writer native .itraj" if use_native else "writer numpy .npz (use_native=False)") in out
    j = _read_dir(dirs["jax"], j_native.read_trajectory)
    t = _read_dir(dirs["torch"], t_native.read_trajectory)
    assert len(t) == 6 and list(t)[0] == ("traj_000000.itraj" if use_native else "traj_000000.npz")
    _assert_same_trees(j, t)
    lengths = [int(np.asarray(d["done_idx"]).reshape(-1)[0]) + 1 for d in t.values()]
    assert min(lengths) >= 2 and max(lengths) <= 5       # < 2 steps dropped, max_len 5
    if use_native:   # the same bytes: the same format, the same zlib stream
        for f in t:
            assert open(os.path.join(dirs["jax"], f), "rb").read() == \
                open(os.path.join(dirs["torch"], f), "rb").read()


def test_logger_names_its_fallback_writer(tmp_path, capsys, monkeypatch):
    """Where the native writer cannot be built the logger takes the numpy one
    and says so, with the reason."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "SOURCE", str(tmp_path / "missing.cpp"))
    lg = t_log.DataLoggerSim(str(tmp_path / "out"), 1, total_trajectories=1)
    assert lg.writer_name == "numpy .npz"
    lg.close()
    out = capsys.readouterr().out
    assert "writer numpy .npz (native writer unavailable:" in out and "missing.cpp" in out


def test_itraj_is_read_across_the_packages(tmp_path):
    if j_native.load() is None or t_native.load() is None:
        pytest.skip("g++ or zlib unavailable")
    rng = np.random.default_rng(1)
    data = {"obs": rng.normal(size=(9, 15)).astype(np.float32),
            "q": rng.normal(size=(9, 2, 3)),
            "ids": rng.integers(-5, 5, (9,)).astype(np.int32),
            "steps": np.arange(9, dtype=np.int64),
            "px": rng.integers(0, 255, (9, 4)).astype(np.uint8),
            "done": rng.random(9) < 0.5,
            "half": rng.normal(size=(9, 3)).astype(np.float16),    # stored as float32
            "done_idx": np.asarray(8)}
    for writer, reader, sub in ((t_native.NativeTrajectoryWriter, j_native.read_trajectory, "t"),
                                (j_native.NativeTrajectoryWriter, t_native.read_trajectory, "j")):
        w = writer(str(tmp_path / sub), num_workers=2)
        w.submit(data)
        w.close()
        back = reader(str(tmp_path / sub / "traj_000000.itraj"))
        assert sorted(back) == sorted(data)
        for k, v in data.items():
            assert back[k].dtype == t_native.stored_dtype(v.dtype), k
            np.testing.assert_array_equal(back[k].reshape(v.shape), v.astype(back[k].dtype))
    assert open(tmp_path / "t" / "traj_000000.itraj", "rb").read() == \
        open(tmp_path / "j" / "traj_000000.itraj", "rb").read()


def _dataset_dir(path, n=7, seed=2, tactile=False):
    """A directory of npz trajectories of several lengths, one of them failed."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        t = int(rng.integers(4, 14))
        d = dict(student_obs=rng.normal(size=(t, 15)).astype(np.float32),
                 obs=rng.normal(1.0, 2.0, size=(t, 15)).astype(np.float32),
                 actions=rng.uniform(-1, 1, size=(t, 6)).astype(np.float32),
                 latent=rng.normal(size=(t, 8)).astype(np.float32),
                 eef_pos=rng.normal(size=(t, 3)).astype(np.float32),
                 pcl=rng.normal(0.1, 0.02, size=(t, 12, 3)).astype(np.float16),
                 success=np.asarray([0.0] * (t - 1) + [float(i != 3)], np.float32),
                 done_idx=np.asarray(t - 1))
        if tactile:
            d["tactile"] = rng.random((t, 3, 4, 4, 3)).astype(np.float16)
        np.savez_compressed(os.path.join(path, f"traj_{i:06d}.npz"), **d)
    return path


def test_normalizer_matches(tmp_path):
    stats = []
    for name, mod in (("j", j_ds), ("t", t_ds)):
        d = _dataset_dir(str(tmp_path / name))
        stats.append(mod.DataNormalizer(d).run())
        assert os.path.exists(os.path.join(d, "normalization.pkl"))
    j, t = stats
    assert sorted(j) == sorted(t) == sorted({"student_obs", "obs", "eef_pos", "pcl"})
    for k in j:
        for s in ("mean", "std"):
            assert t[k][s].dtype == np.float32
            np.testing.assert_allclose(t[k][s], j[k][s], rtol=1e-6)
    x = np.random.default_rng(3).normal(size=(5, 12, 3)).astype(np.float32)
    nj, nt = j_ds.DataNormalizer(str(tmp_path / "j")), t_ds.DataNormalizer(str(tmp_path / "t"))
    nj.run(), nt.run()    # both load the pickle written above
    np.testing.assert_allclose(nt.normalize("pcl", x), nj.normalize("pcl", x), rtol=1e-6)
    assert nt.normalize("latent", x) is x
    removed = [mod.DataNormalizer.remove_failed_trajectories(str(tmp_path / name), min_len=6)
               for name, mod in (("j", j_ds), ("t", t_ds))]
    assert removed[0] == removed[1] > 0
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))


@pytest.mark.parametrize("seq_len,tactile", [(1, False), (3, True)])
def test_split_and_batches_match(tmp_path, seq_len, tactile):
    d = _dataset_dir(str(tmp_path / "d"), n=9, tactile=tactile)
    split_j = j_ds.split_trajectory_files(d, 0.25, seed=4)
    split_t = t_ds.split_trajectory_files(d, 0.25, seed=4)
    assert split_j == split_t and split_t[1]
    keys = ("student_obs", "actions", "pcl") + (("tactile",) if tactile else ())
    ds = [mod.TrajectoryDataset(d, seq_len=seq_len, keys=keys, files=split_t[0],
                                normalizer=mod.DataNormalizer(d), tactile_diff=tactile)
          for mod in (j_ds, t_ds)]
    assert len(ds[0]) == len(ds[1]) > 10 and ds[0]._index == ds[1]._index
    bj = list(ds[0].batches(4, np.random.default_rng(5), epochs=2))
    bt = list(ds[1].batches(4, np.random.default_rng(5), epochs=2))
    assert len(bt) == 2 * (len(ds[1]) // 4)               # the last partial batch dropped
    for a, b in zip(bj, bt):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape[:2] == (4, seq_len)
            np.testing.assert_array_equal(a[k], b[k])


def test_data_io_matches(tmp_path):
    rng = np.random.default_rng(6)
    grasp_keys = ("sub_idx", "dof_pos", "socket_pos", "socket_quat", "plug_pos_hand", "plug_quat_hand")
    paths = []
    for i in range(2):
        p = str(tmp_path / f"grasp_{i}.npz")
        np.savez(p, **{k: rng.normal(size=(3 + i, 4)).astype(np.float32) for k in grasp_keys})
        paths.append(p)
    assert j_io.merge_grasp_datasets(paths, str(tmp_path / "mj.npz")) == \
        t_io.merge_grasp_datasets(paths, str(tmp_path / "mt.npz")) == 7
    with np.load(tmp_path / "mj.npz") as a, np.load(tmp_path / "mt.npz") as b:
        for k in grasp_keys:
            np.testing.assert_array_equal(a[k], b[k])

    for name in ("j", "t"):
        d = _dataset_dir(str(tmp_path / name))
        np.savez(os.path.join(d, "traj_000000.npz"), **{"img": rng.random((5, 2, 3)).astype(np.float32),
                                                          "done_idx": np.asarray(4)})
        open(os.path.join(d, "traj_000099.npz"), "wb").write(b"not a zip file")
    rj, rt = j_io.inspect_trajectories(str(tmp_path / "j")), t_io.inspect_trajectories(str(tmp_path / "t"))
    assert rj == rt and rt["num_trajectories"] == 7
    assert j_io.cleanup_corrupt_files(str(tmp_path / "j")) == \
        t_io.cleanup_corrupt_files(str(tmp_path / "t")) == 1
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
    src = str(tmp_path / "t" / "traj_000000.npz")
    assert j_io.extract_frames(src, str(tmp_path / "fj")) == t_io.extract_frames(src, str(tmp_path / "ft")) == 5
    assert sorted(os.listdir(tmp_path / "fj")) == sorted(os.listdir(tmp_path / "ft"))
    assert t_io.extract_frames(src, str(tmp_path / "fx"), key="absent") == 0


def test_real_logger_warns_as_the_reference(tmp_path):
    """DataLoggerReal: a 1-step trajectory is dropped with a warning, a key
    missing on some steps is dropped from the whole trajectory with a
    warning, and the files are the reference's."""
    rng = np.random.default_rng(7)
    steps = [(dict(obs=rng.normal(size=15).astype(np.float32), empty=np.zeros(0)),
              rng.normal(size=6).astype(np.float32), i == 4, {"force": np.ones(3)} if i != 2 else {})
             for i in range(5)]
    msgs, trees = [], []
    for name, mod, read in (("j", j_log, j_native.read_trajectory), ("t", t_log, t_native.read_trajectory)):
        lg = mod.DataLoggerReal(str(tmp_path / name), max_len=8)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            lg.add_step(*steps[0][:2], done=True)          # 1 step: discarded
            for obs, act, done, extra in steps:
                lg.add_step(obs, act, done=done, **extra)
            lg.close()
        msgs.append(sorted(str(x.message) for x in w))
        trees.append(_read_dir(str(tmp_path / name), read))
    assert msgs[0] == msgs[1] and len(msgs[1]) == 2
    assert any("1-step" in m for m in msgs[1]) and any("['force']" in m for m in msgs[1])
    _assert_same_trees(*trees)
    assert sorted(trees[1]["traj_000000.npz"]) == ["actions", "done", "done_idx", "obs"]
