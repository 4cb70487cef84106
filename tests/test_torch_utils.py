"""The utilities (`utils/video.py`, `scene_export.py`, `profiling.py`,
`rna.py`) and `PPOTrainer.record_video` against the JAX package's modules
on the same inputs. The envs run in the port only (no JAX env step is
compiled): the JAX functions are handed the port's states as host arrays."""

import contextlib
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.physics.robot import build_kuka_openhand as j_build_robot
from isaacgyminsertion_tpu.utils import rna as j_rna
from isaacgyminsertion_tpu.utils import scene_export as j_scene
from isaacgyminsertion_tpu.utils import video as j_video
from isaacgyminsertion_tpu_torch.algo import ppo
from isaacgyminsertion_tpu_torch.algo.trainer import PPOTrainer
from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import insertion
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
from isaacgyminsertion_tpu_torch.utils import profiling, rna, scene_export, video

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    gen = insertion.make_generator(3, "cpu")
    with torch.no_grad():
        states = [insertion.reset_all(cfg, model, subs, gen, 12)]
        for _ in range(2):
            states.append(insertion.step(cfg, model, subs, states[-1], 0.5 * torch.ones((12, 6)), gen)[0])
    return dict(cfg=cfg, model=model, subs=subs, states=states)


@pytest.fixture(scope="module")
def sensors_world(world):
    """32 envs with every sensor on at render_capacity 0.75 (24 rows a renderer
    a step) and no sensor delay, so a fresh frame's consumers follow from the
    state; just reset."""
    cfg = world["cfg"]
    cfg = cfg.replace(randomize=dataclasses.replace(cfg.randomize, domain_randomize=False),
                      env=dataclasses.replace(cfg.env, tactile=True, external_cam=True, depth_cam=True,
                                              seg_cam=True, pcl_cam=True, render_capacity=0.75,
                                              tactile_delay_prob=0.0, img_delay_prob=0.0, seg_delay_prob=0.0))
    with torch.no_grad():
        state = insertion.reset_all(cfg, world["model"], world["subs"], insertion.make_generator(5, "cpu"), 32)
    return dict(world, cfg=cfg, states=[state])


def _host(tree):
    """A port state as the same NamedTuples of host arrays (what the JAX
    functions read, and what `env_state_from_numpy` takes)."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_host(x) for x in tree])
    return tree


def test_frames_to_video_and_plot_traces_write_the_reference_files(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.uniform(-0.1, 1.1, (6, 54, 96)).astype(np.float32)
    rgb = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    traces = {"actions": rng.normal(size=(30, 6)), "finger_forces": rng.uniform(0, 5, (30, 3)),
              "one": rng.normal(size=30)}
    for name, x in (("depth.gif", frames), ("rgb.gif", rgb)):
        a = video.frames_to_video(x, str(tmp_path / "port" / name))
        b = j_video.frames_to_video(x, str(tmp_path / "jax" / name))
        assert os.path.getsize(a) > 0 and open(a, "rb").read() == open(b, "rb").read(), name
    a = video.plot_traces(traces, str(tmp_path / "port" / "traces.png"), title="t")
    b = j_video.plot_traces(traces, str(tmp_path / "jax" / "traces.png"), title="t")
    assert os.path.getsize(a) > 0 and os.path.getsize(b) > 0
    assert open(a, "rb").read() == open(b, "rb").read()


def test_capture_hands_out_the_envs_own_depth_frames(world, tmp_path):
    cfg, model, subs = world["cfg"], world["model"], world["subs"]
    act = lambda s: torch.tanh(s.obs_queue[:, :6])
    frames, actions, forces = video.capture_eval_rollout(cfg, model, subs, act, n_steps=4, seed=5,
                                                         device="cpu")
    assert frames.shape == (4, 54, 96) and actions.shape == (4, 6) and forces.shape == (4, 3)
    vcfg = video.video_task_config(cfg)
    assert vcfg.env.external_cam and vcfg.env.depth_cam and vcfg.env.seg_cam and not vcfg.env.tactile
    gen = insertion.make_generator(5, "cpu")
    with torch.no_grad():
        s = insertion.reset_all(vcfg, model, subs, gen, 1)
        for t in range(4):
            a = act(s)
            s, out = insertion.step(vcfg, model, subs, s, a, gen)
            np.testing.assert_array_equal(frames[t], -out.img[0, 0].numpy())
            np.testing.assert_array_equal(actions[t], a[0].numpy())
            np.testing.assert_array_equal(forces[t], s.finger_forces_ema[0].numpy())
    assert np.isfinite(frames).all() and 0.0 <= frames.min() and frames.max() <= 1.0 and frames.max() > 0
    paths = video.record_eval_video(cfg, model, subs, act, n_steps=2, out_dir=str(tmp_path), device="cpu")
    assert [os.path.basename(p) for p in paths] == ["rollout.gif", "traces.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_ppo_trainer_record_video_writes_its_two_files(world, tmp_path):
    trainer = PPOTrainer(world["cfg"], ppo.PPOConfig(horizon=2, mini_epochs=1), world["model"],
                         world["subs"], 2, str(tmp_path), device="cpu")
    paths = trainer.record_video(n_steps=3)
    assert paths == [str(tmp_path / "videos" / "rollout.gif"), str(tmp_path / "videos" / "traces.png")]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_scene_export_is_the_reference_bytes(world, tmp_path):
    state = world["states"][-1]
    carried = insertion.env_state_from_numpy(_host(state), "cpu")
    kinds = torch.argmax(state.params.kind_onehot, -1).tolist()
    assert 0 in kinds and any(k != 0 for k in kinds)   # both plug geometries
    for env in range(state.phys.q.shape[0]):
        a = scene_export.export_scene_usda(world["cfg"], world["model"], world["subs"], carried,
                                           str(tmp_path / f"port_{env}.usda"), env=env)
        b = j_scene.export_scene_usda(None, None, None, _host(state), str(tmp_path / f"jax_{env}.usda"),
                                      env=env)
        assert open(a, "rb").read() == open(b, "rb").read(), env


def test_pose_extractor_matches_the_reference(world, tmp_path):
    port, ref = scene_export.PoseExtractor(world["model"]), j_scene.PoseExtractor(j_build_robot())
    for s in world["states"]:
        port.record(s, env=3)
        ref.record(jax.tree_util.tree_map(jnp.asarray, _host(s)), env=3)
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "jax"))
    for name in ("body_position.npy", "body_rotation.npy"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.shape == b.shape and a.shape[0] == 3
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def test_check_determinism_holds_the_env_step_and_catches_fresh_noise(world):
    cfg, model, subs = world["cfg"], world["model"], world["subs"]
    state = world["states"][0]
    step = lambda s: insertion.step(cfg, model, subs, s, 0.3 * torch.ones((12, 6)),
                                    insertion.make_generator(0, "cpu"))
    with torch.no_grad():
        assert profiling.check_determinism(step, state)
    gen = torch.Generator().manual_seed(0)
    assert not profiling.check_determinism(lambda: {"x": torch.randn(3, generator=gen)})
    assert not profiling.check_determinism(lambda: [float("nan"), time.perf_counter()])
    assert profiling.check_determinism(lambda: (float("nan"), torch.full((2,), float("nan")), None))


def test_trace_writes_a_chrome_trace_and_step_timer_is_the_reference(tmp_path, monkeypatch):
    """`trace` writes a Chrome trace that holds the spans opened in it; a span
    opens `record_function` only while a profiler records."""
    opened, record_function = [], torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record_function(name))
    with profiling.span("test.outside"):
        torch.ones(2) + 1
    assert opened == []
    with profiling.trace(str(tmp_path / "tr")) as path:
        with profiling.span("test.outer"):
            with profiling.span("test.outer.inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert opened == ["test.outer", "test.outer.inner"]
    assert path == str(tmp_path / "tr" / "trace.json") and os.path.getsize(path) > 0
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"test.outer", "test.outer.inner", "aten::mm"} <= names and "test.outside" not in names
    with profiling.span("test.outside"):
        pass
    assert opened == ["test.outer", "test.outer.inner"]


def test_a_control_step_records_its_spans_each_inside_its_parent(world):
    cfg, model, subs = world["cfg"], world["model"], world["subs"]
    before = profiling.spans()
    with torch.no_grad():
        insertion.step(cfg, model, subs, world["states"][0], 0.3 * torch.ones((12, 6)),
                       insertion.make_generator(0, "cpu"))
    got = profiling.spans_since(before)
    assert {"env", "env.sync", "physics", "physics.dynamics", "physics.contacts", "sensors"} <= set(got)
    assert "env.reset" not in got and not bool(world["states"][0].reset_buf.any())
    assert got["physics.dynamics"] + got["physics.contacts"] <= got["physics"]
    assert got["env.sync"] + got["physics"] + got["sensors"] <= got["env"]


def test_spans_and_counters_add_no_torch_op_with_tracing_off(sensors_world, monkeypatch):
    """With tracing off, a control step with every sensor on and the spans and
    counters in place issues exactly the torch ops of the same step with both
    stubbed out; a device count reaches `count` as a callable, so that no op
    builds it unless tracing is on."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    w = sensors_world

    def step():
        insertion.step(w["cfg"], w["model"], w["subs"], w["states"][0], 0.3 * torch.ones((32, 6)),
                       insertion.make_generator(0, "cpu"))

    def ops_of_a_step():
        with torch.no_grad(), Ops() as mode:
            step()
        return mode.ops

    with torch.no_grad():
        step()   # the constants a first step caches
    assert profiling.tracing(False) is False
    before, counted, count = profiling.spans(), [], profiling.count
    monkeypatch.setattr(profiling, "count", lambda name, value: counted.append(value) or count(name, value))
    instrumented = ops_of_a_step()
    assert counted and all(isinstance(v, (int, float)) or callable(v) for v in counted)
    assert set(profiling.spans_since(before)) >= {"env", "physics", "sensors.tactile", "sensors.camera"}
    monkeypatch.setattr(profiling, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "count", lambda name, value: None)
    bare = ops_of_a_step()
    assert len(instrumented) > 1000 and instrumented == bare


def test_rows_consumed_counts_the_rendered_rows_whose_frame_is_taken(sensors_world):
    """At render_capacity 0.75 each renderer draws 24 of the 32 rows; the
    consumed rows are those of each selection whose fresh frame the queue
    takes: the tactile refreshes, and the camera's refreshes and first steps."""
    w = sensors_world
    s = w["states"][0]
    # past the first steps, at staggered frames: some rows consume, some do not
    s = s._replace(progress=s.progress + 20, frame=s.frame + torch.arange(32, dtype=s.frame.dtype))
    assert not bool(s.reset_buf.any())
    frame, progress = s.frame + 1, s.progress + 1
    t_upd = ((frame + s.tactile_refresh_offset) % s.tactile_refresh_rate) == 0
    i_refresh = ((frame + s.img_refresh_offset) % s.img_refresh_rate) == 0
    initial = progress < 10
    sel_t = insertion.render_selection(torch.where(t_upd, 0, 1), 0.75, s.global_step)
    sel_c = insertion.render_selection(torch.where(initial, 0, torch.where(i_refresh, 1, 2)), 0.75, s.global_step)
    want = int(t_upd[sel_t].sum()) + int((initial | i_refresh)[sel_c].sum())
    assert len(sel_t) == len(sel_c) == 24 and 0 < want < 48

    profiling.clear_counters("sensors.")
    was = profiling.tracing(True)
    try:
        before = profiling.spans()
        with torch.no_grad():
            insertion.step(w["cfg"], w["model"], w["subs"], s, torch.zeros((32, 6)),
                           insertion.make_generator(0, "cpu"))
        got = profiling.spans_since(before)
    finally:
        profiling.tracing(was)
    assert profiling.counters()["sensors.rows_rendered"] == 48
    assert profiling.counters()["sensors.rows_consumed"] == want
    assert got["sensors.tactile"] + got["sensors.camera"] <= got["sensors"] <= got["env"]
    profiling.clear_counters("sensors.")


def test_rna_forward_init_and_params_match_flax():
    ref = j_rna.RandomNetworkAdversary(obs_dim=15, seed=3)
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    port = rna.RandomNetworkAdversary(obs_dim=15)
    port.load_jax_params(params)
    rng = np.random.default_rng(0)
    obs, z = rng.normal(size=(32, 15)).astype(np.float32), rng.normal(size=(32, 8)).astype(np.float32)
    want = np.asarray(ref.net.apply(ref.params, jnp.asarray(obs), jnp.asarray(z)))
    got = port(torch.as_tensor(obs), torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # to_jax_params round-trips exactly, both ways
    back = port.to_jax_params()
    assert set(back["params"]) == {"Dense_0", "Dense_1", "Dense_2"}
    for layer, leaves in params["params"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][k], v)
    again = rna.RandomNetworkAdversary(obs_dim=15, seed=9).load_jax_params(back)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), port.state_dict().values()))
    # flax's init: lecun-normal kernels (truncated at 2σ), zero biases, over 8 draws each
    flax = [j_rna.RandomNetworkAdversary(obs_dim=15, seed=s).params["params"] for s in range(8)]
    ours = [rna.RandomNetworkAdversary(obs_dim=15, seed=s).to_jax_params()["params"] for s in range(8)]
    for layer, fan_in in (("Dense_0", 23), ("Dense_1", 128), ("Dense_2", 128)):
        f = np.concatenate([np.asarray(p[layer]["kernel"]).ravel() for p in flax])
        o = np.concatenate([p[layer]["kernel"].ravel() for p in ours])
        assert abs(o.std() / f.std() - 1.0) < 0.05 and abs(o.std() * np.sqrt(fan_in) - 1.0) < 0.05, layer
        assert abs(o.mean()) < 0.05 / np.sqrt(fan_in) + 3 * o.std() / np.sqrt(o.size), layer
        assert np.abs(o).max() <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6, layer
        assert all(not p[layer]["bias"].any() for p in ours), layer
    # a perturbation stays in [-1, 1] and moves with the draw and with a refresh
    acts = torch.zeros((4, 6))
    out = port.perturb(torch.Generator().manual_seed(1), torch.zeros((4, 15)), acts)
    assert out.shape == (4, 6) and float(out.abs().max()) <= 1.0 and float(out.abs().max()) > 0
    port.refresh(torch.Generator().manual_seed(2))
    after = port.perturb(torch.Generator().manual_seed(1), torch.zeros((4, 15)), acts)
    assert float((after - out).abs().max()) > 0
