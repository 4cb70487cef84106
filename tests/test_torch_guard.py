"""The port stands alone: no module of isaacgyminsertion_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package; its entry points (the CLI,
sys-id, PBT, the deploy simulator and the kinematic arm among them) refuse to
run on the CPU unless asked; its CLI trains and evaluates the teacher and the
student, collects rotating-plug frames, and reaches the device check with the
grasp-dataset resets and the CycleGAN generator; its kernels have no quiet
fall-back; its native trajectory writer and transport codec build into the
package's `_build/` only."""

import ast
import os

import pytest
import torch

from isaacgyminsertion_tpu_torch import cli, resolve_device

# tiny tensors: intra-op threads would only contend with the other test workers
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = "isaacgyminsertion_tpu_torch"
TEACHER = os.path.join(ROOT, "checkpoints", "teacher_r2b", "best_success")
# scripts/retrain_student_r5.sh → scripts/train_s2.sh (python train.py ... "$@"), with the
# defaults of both and the two arguments student_r5's attempt 4 added
RETRAIN_R5 = ["train.algo=ExtrinsicAdapt", f"checkpoint={TEACHER}", "task.env.numEnvs=256",
              "task.external_cam.external_cam=True", "task.external_cam.seg_cam=True",
              "task.external_cam.pcl_cam=True", "train.ppo.obs_info=True", "train.ppo.pcl_info=True",
              "train.ppo.only_bc=True", "task.reset_at_success=True", "task.reset_at_fails=True",
              "task.rand_inits=True", "task.env.render_capacity=0.75", "output=outputs/student",
              "dagger.replay_size=400000", "dagger.replay_mode=device_split", "eval_freq_steps=2e6",
              "eval_envs=256", "max_epochs=1500", "output=outputs/student_r5",
              "dagger.replay_stratify=True", "dagger.beta_anneal_steps=6e6"]


def _sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, _, files in os.walk(os.path.join(ROOT, PORT)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "isaacgyminsertion_tpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    found = []
    sources = list(_sources())
    assert len(sources) > 30
    for module in ("sensors/raycast.py", "sensors/render_kernels.py", "sensors/tactile.py",
                   "sensors/camera.py", "sensors/pcl.py", "sensors/contact_gt.py", "models/student.py",
                   "algo/ext_adapt.py", "utils/cuda_build.py", "algo/ppo.py", "utils/metrics.py",
                   "envs/vec_env.py", "native/__init__.py", "data/dataset.py", "data/logger.py",
                   "data/data_io.py", "algo/collect.py", "algo/offline_runner.py",
                   "algo/tactile_runner.py", "train_supervised.py", "utils/host_build.py", "sysid.py",
                   "pbt/pbt.py", "pbt/mutation.py", "pbt/driver.py", "pbt/run.py", "deploy/calib.py",
                   "deploy/transport.py", "deploy/hardware_player.py", "deploy/devices.py", "bench.py",
                   "entry.py"):
        assert any(p.endswith(os.path.join(PORT, module)) for p in sources), module
    for path in sources:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    found.append((path, node.module))
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
                arg = node.args[0] if node.args else None
                if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                    found.append((path, arg.value))
    assert not found, found


def test_entry_points_do_not_fall_back_to_the_cpu(tmp_path):
    """resolve_device, and the entry points of sys-id, PBT and the deploy
    stack: without a GPU and without a CPU request they raise."""
    from isaacgyminsertion_tpu_torch import sysid
    from isaacgyminsertion_tpu_torch.deploy.devices import KinematicArm
    from isaacgyminsertion_tpu_torch.deploy.hardware_player import SimInterface
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.pbt import run as pbt_run

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        for call in (lambda: sysid.main(["--traj", str(tmp_path / "rec.npz")]),
                     lambda: pbt_run.main({"WORKSPACE": str(tmp_path / "pbt")}),
                     lambda: SimInterface(default_task_config()),
                     lambda: KinematicArm()):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert not os.path.exists(tmp_path / "pbt")


def test_cli_runs_only_the_teacher_eval(tmp_path):
    """The teacher's eval and its PPO training parse; training runs only on
    the device asked for (no GPU and no device=cpu: it raises); student
    training parses the arguments of scripts/retrain_student_r5.sh and runs
    only on the device asked for; the grasp-dataset resets and the CycleGAN
    generator parse and reach the device check; the other refusals stay."""
    args = cli.parse_args(["train.algo=PPO", "test=True", "checkpoint=x", "num_envs=1024",
                           "task.randomize.domain_randomize=False", "task.rl.max_episode_length=7"])
    assert args["test"] and args["num_envs"] == 1024 and args["checkpoint"] == "x"
    assert args["task"].randomize.domain_randomize is False
    assert args["task"].rl.max_episode_length == 7
    train = ["train.algo=PPO", "test=False", "num_envs=2", "train.ppo.horizon_length=16",
             "train.ppo.mini_epochs=4", "ppo.anchor_coef=0.5", "max_epochs=1",
             f"output={tmp_path}"]
    args = cli.parse_args(train)
    assert not args["test"] and args["ppo"].horizon == 16 and args["ppo"].mini_epochs == 4
    assert args["ppo"].anchor_coef == 0.5 and args["max_epochs"] == 1 and args["device"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(train)
    args = cli.parse_args(RETRAIN_R5)
    d, e = args["dagger"], args["task"].env
    assert args["algo"] == "ExtrinsicAdapt" and not args["test"] and args["num_envs"] == 256
    assert (d.replay_size, d.replay_mode, d.replay_stratify, d.beta_anneal_steps) == (
        400_000, "device_split", True, 6e6)
    assert d.use_obs and d.use_pcl and d.only_bc and not d.use_tactile
    assert e.external_cam and e.seg_cam and e.pcl_cam and e.render_capacity == 0.75
    assert args["task"].reset_at_success and args["task"].reset_at_fails and args["task"].rand_inits
    assert (args["eval_freq_steps"], args["eval_envs"], args["max_epochs"]) == (2e6, 256, 1500)
    assert args["output"] == "outputs/student_r5" and not args["phase3"]
    assert cli.parse_args(["train.algo=ExtrinsicAdapt", "phase3=True"])["phase3"]
    assert cli.parse_args(["train.phase3=True"])["phase3"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["train.algo=ExtrinsicAdapt", "test=False", f"checkpoint={TEACHER}"])
    with pytest.raises(SystemExit, match="checkpoint=<teacher"):
        cli.main(["train.algo=ExtrinsicAdapt", "test=False", "device=cpu"])
    for gan in ("gan_checkpoint=g", "task.tactile.model_G=g"):
        assert cli.parse_args(RETRAIN_R5 + [gan])["gan_checkpoint"] == "g"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cli.main(RETRAIN_R5 + [gan])
    assert cli.parse_args(train + ["grasp_dataset=grasps.npz"])["grasp_dataset"] == "grasps.npz"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(train + ["grasp_dataset=grasps.npz"])
    with pytest.raises(SystemExit, match="student_checkpoint"):
        cli.main(["train.algo=ExtrinsicAdapt", "test=True", "checkpoint=x"])
    with pytest.raises(SystemExit, match="truncate_grads"):
        cli.parse_args(["train.ppo.truncate_grads=0.5"])
    with pytest.raises(SystemExit, match="unknown override"):
        cli.parse_args(["train.ppo.horizon=16"])


def test_cli_parses_the_student_training_recipe():
    scripts = "".join(open(os.path.join(ROOT, "scripts", f)).read()
                      for f in ("train_s2.sh", "retrain_student_r5.sh"))
    for arg in RETRAIN_R5[2:-2]:
        assert arg.split("=")[0] in scripts, arg          # the list above is the scripts'
    args = cli.parse_args(RETRAIN_R5 + ["student_checkpoint=s", "phase3=True", "seed=3"])
    assert args["student_checkpoint"] == "s" and args["phase3"] and args["seed"] == 3


def test_cli_trains_a_student_on_the_cpu_when_asked(tmp_path, capsys):
    """One epoch of DAgger through the CLI on the CPU: it writes the
    checkpoints and metrics, the trainer's `test` repeats its final eval,
    and its last.ckpt loads into the student eval."""
    from isaacgyminsertion_tpu_torch.algo.trainer import StudentEvaluator

    argv = ["train.algo=ExtrinsicAdapt", "test=False", f"checkpoint={TEACHER}", "num_envs=2",
            "device=cpu", "max_epochs=1", "dagger.horizon=2", "dagger.mini_epochs=1", "eval_envs=1",
            "task.rl.max_episode_length=10", f"output={tmp_path}"]
    trainer = cli.main(argv)
    assert trainer.state.agent_steps == 4 and trainer.state.epoch == 1
    assert {"last.ckpt", "best_success.ckpt", "metrics.jsonl", "config.json"} <= set(os.listdir(tmp_path))
    out = capsys.readouterr().out
    assert "[dagger eval] steps=4 success=" in out
    final_sr = float(out.split("[dagger eval] steps=4 success=")[1].split()[0])
    # the trainer's own eval of the student in training: the final eval's seed is its agent_steps
    assert trainer.test(seed=4, eval_envs=1) == final_sr
    assert trainer.test_log(noise_levels=(), eval_envs=1) == {}       # the study's files, no eval
    assert os.path.exists(tmp_path / "noise_study.jsonl")
    args = cli.parse_args(argv)
    runner = StudentEvaluator(args["task"], args["dagger"], None, None, 1, TEACHER, str(tmp_path / "last"),
                              device="cpu")
    assert runner.student.net.state_dict().keys() == trainer.state.net.state_dict().keys()


def test_cli_eval_on_the_cpu_when_asked(capsys):
    ckpt = os.path.join(ROOT, "checkpoints", "teacher_r2b", "best_success")
    sr = cli.main(["train.algo=PPO", "test=True", f"checkpoint={ckpt}", "num_envs=2",
                   "device=cpu", "task.rl.max_episode_length=10"])
    assert 0.0 <= sr <= 1.0
    assert "Success Rate:" in capsys.readouterr().out


# the argument list of scripts/eval_s2.sh (python train.py ... "$@"), with its defaults
EVAL_S2 = ["train.algo=ExtrinsicAdapt", "test=True", "task.env.numEnvs=64",
           "task.external_cam.external_cam=True", "task.external_cam.seg_cam=True",
           "task.external_cam.pcl_cam=True", "train.ppo.pcl_info=True", "train.ppo.obs_info=True",
           "train.ppo.only_bc=True"]


def test_cli_parses_the_student_eval_recipe():
    script = open(os.path.join(ROOT, "scripts", "eval_s2.sh")).read()
    for arg in EVAL_S2:
        assert arg.split("=")[0] in script, arg          # the list above is the script's
    args = cli.parse_args(EVAL_S2 + ["checkpoint=t", "student_checkpoint=s", "noise_study=True",
                                     "task.env.tactile=True", "task.env.render_capacity=0.75",
                                     "train.ppo.tactile_info=True", "train.ppo.seg_info=True",
                                     "dagger.use_img=True", "offline_train.from_offline=True",
                                     "output=outputs/x"])
    assert args["algo"] == "ExtrinsicAdapt" and args["num_envs"] == 64 and args["noise_study"]
    assert args["student_checkpoint"] == "s" and args["output"] == "outputs/x"
    e, d = args["task"].env, args["dagger"]
    assert e.external_cam and e.seg_cam and e.pcl_cam and e.tactile and not e.depth_cam
    assert e.render_capacity == 0.75
    assert d.use_pcl and d.use_obs and d.only_bc and d.use_tactile and d.use_seg and d.use_img


def test_cli_student_eval_on_the_cpu_when_asked(capsys):
    ck = os.path.join(ROOT, "checkpoints")
    argv = [a for a in EVAL_S2 if not a.startswith("task.env.numEnvs")] + [
        f"checkpoint={ck}/teacher_r2b/best_success", f"student_checkpoint={ck}/student_r5/best_success",
        "task.env.numEnvs=2", "task.rl.max_episode_length=10"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):                # no GPU and no device=cpu: it raises
            cli.main(argv)
    sr = cli.main(argv + ["device=cpu"])
    assert 0.0 <= sr <= 1.0
    assert "Success Rate:" in capsys.readouterr().out


def test_kernel_wrappers_dispatch_by_device_without_a_fallback():
    """On CPU tensors a wrapper takes its plain version; asked for the CUDA
    path on CPU tensors it raises, and no wrapper hides a failure in a try."""
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk
    from isaacgyminsertion_tpu_torch.sensors import tactile as tact_mod
    from isaacgyminsertion_tpu_torch.utils import profiling

    args, kw = tact_mod.render_inputs(tact_mod.TactileConfig(),
                                      *[torch.as_tensor(a) for a in rk.random_tactile_inputs(1, 0)])
    before = profiling.launches()["tactile_render"]
    assert tuple(rk.tactile_render(*args, **kw).shape) == (3, 4096, 3)
    assert profiling.launches()["tactile_render"] == before             # the plain version does not count
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.tactile_render_cuda(*args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.camera_rows_cuda(torch.zeros((1, rk.CAMERA_ROW)), torch.zeros((3, 8)), iters=1, near=0.1,
                            far=0.5, plate_hx=0.05, plate_hy=0.04)
    for module in ("sensors/render_kernels.py", "physics/solver_kernel.py"):
        tree = ast.parse(open(os.path.join(ROOT, PORT, module)).read())
        assert not any(isinstance(node, ast.Try) for node in ast.walk(tree)), module


def test_sensor_flags_are_refused():
    """Nothing is refused any more: the sensor flags are served since the
    sensors-on slice, the CycleGAN sim→real hook on tactile frames runs, and
    `vec_env.make` builds the sys-id task on the device asked for."""
    from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.envs import vec_env
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.models import zoo
    from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand

    cfg = cli._set_path(default_task_config(), "env.tactile", True)
    model, subs = build_kuka_openhand(), build_subassembly_set()
    gen = insertion.make_generator(0, "cpu")
    with torch.no_grad():
        state = insertion.reset_all(cfg, model, subs, gen, 2)
        assert tuple(state.tactile_queue.shape) == (2, 1, 3, 64, 64, 3) and state.img_queue.numel() == 0
        gan = zoo.init_like_flax(zoo.ResnetGenerator(), torch.Generator().manual_seed(0)).eval()
        state, out = insertion.step(cfg, model, subs, state, torch.zeros((2, 6)), gen, gan=gan)
        assert tuple(out.tactile.shape) == (2, 1, 3, 64, 64, 3) and bool(torch.isfinite(out.tactile).all())
    task = vec_env.make("FactoryTaskOptimizeTactile", device="cpu")
    assert isinstance(task, vec_env.SysIdTask) and task.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vec_env.make("FactoryTaskOptimizeTactile")


def test_data_entry_points_run_only_on_the_device_asked_for(tmp_path):
    """train_supervised (collect, offline training) and the rotating-plug
    collection raise without a GPU unless device=cpu is given; the CLI parses
    scripts/collect_rotate.sh's arguments."""
    from isaacgyminsertion_tpu_torch import train_supervised

    script = open(os.path.join(ROOT, "scripts", "collect_rotate.sh")).read()
    assert "collect_rotate=True" in script and "task.env.numEnvs=" in script
    args = cli.parse_args(["collect_rotate=True", "task.env.numEnvs=32", "output=outputs/tactile_rot"])
    assert args["collect_rotate"] and args["num_envs"] == 32 and args["output"] == "outputs/tactile_rot"
    assert cli.parse_args(["task.collect_rotate=True"])["collect_rotate"]
    if not torch.cuda.is_available():
        for argv in (["collect=True", f"checkpoint={TEACHER}", f"data_dir={tmp_path}"],
                     [f"data_dir={tmp_path}", "epochs=1"]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                train_supervised.main(argv)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["collect_rotate=True", "num_envs=1", f"output={tmp_path}/r"])
    assert cli.main(["collect_rotate=True", "num_envs=1", f"output={tmp_path}/r", "device=cpu"]) == 60
    assert os.path.exists(tmp_path / "r_rotate.npz")


def test_native_writer_builds_into_the_package_build_dir_only():
    """trajlog.cpp is compiled into isaacgyminsertion_tpu_torch/_build/ under
    a name hashed from its source and flags; nothing is written beside the
    source, and the JAX package's committed library is never the one loaded."""
    from isaacgyminsertion_tpu_torch import native
    from isaacgyminsertion_tpu_torch.utils import host_build

    native_dir = os.path.join(ROOT, PORT, "native")
    jax_native = os.path.join(ROOT, "isaacgyminsertion_tpu", "native")
    before = {d: sorted(os.listdir(d)) for d in (native_dir, jax_native)}
    stamps = {f: os.stat(os.path.join(jax_native, f)).st_mtime_ns for f in before[jax_native]}
    if native.load() is None:
        assert native.BUILD_ERROR
        pytest.skip(f"g++ or zlib unavailable: {native.BUILD_ERROR}")
    build_dir = os.path.realpath(os.path.join(ROOT, PORT, "_build"))
    assert os.path.realpath(host_build.BUILD_DIR) == build_dir
    assert os.path.dirname(os.path.realpath(native.LIB_PATH)) == build_dir
    assert os.path.basename(native.LIB_PATH).startswith("libtrajlog_")
    assert host_build.build_shared("trajlog", native.SOURCE, libs=("z",)) == native.LIB_PATH
    after = {d: sorted(os.listdir(d)) for d in (native_dir, jax_native)}
    assert after == before and set(after[native_dir]) - {"__pycache__"} == {"__init__.py", "trajlog.cpp",
                                                                              "hwbridge.cpp"}
    assert stamps == {f: os.stat(os.path.join(jax_native, f)).st_mtime_ns for f in after[jax_native]}


def test_transport_codec_builds_into_the_package_build_dir_only(monkeypatch, capsys):
    """hwbridge.cpp is compiled into isaacgyminsertion_tpu_torch/_build/ under
    a name hashed from its source and flags; nothing is written beside the
    source, the JAX package's library is never the one loaded, and the module
    says which codec it took."""
    from isaacgyminsertion_tpu_torch.deploy import transport
    from isaacgyminsertion_tpu_torch.utils import host_build

    native_dir = os.path.join(ROOT, PORT, "native")
    jax_native = os.path.join(ROOT, "isaacgyminsertion_tpu", "native")
    before = {d: sorted(os.listdir(d)) for d in (native_dir, jax_native)}
    stamps = {f: os.stat(os.path.join(jax_native, f)).st_mtime_ns for f in before[jax_native]}
    monkeypatch.setattr(transport, "_native_tried", False)
    monkeypatch.setattr(transport, "_native", None)
    lib = transport._load_native()
    assert capsys.readouterr().out.startswith(f"transport: codec {transport.CODEC} (")
    if lib is None:
        assert transport.CODEC == "python" and "unavailable" in transport.CODEC_NOTE
        pytest.skip(f"g++ unavailable: {transport.CODEC_NOTE}")
    assert transport.CODEC == "native" and transport.SOURCE == os.path.join(
        os.path.realpath(native_dir), "hwbridge.cpp")
    build_dir = os.path.realpath(os.path.join(ROOT, PORT, "_build"))
    assert os.path.dirname(os.path.realpath(transport.CODEC_NOTE)) == build_dir
    assert os.path.basename(transport.CODEC_NOTE).startswith("libhwbridge_")
    assert host_build.build_shared("hwbridge", transport.SOURCE) == transport.CODEC_NOTE
    after = {d: sorted(os.listdir(d)) for d in (native_dir, jax_native)}
    assert after == before
    assert stamps == {f: os.stat(os.path.join(jax_native, f)).st_mtime_ns for f in after[jax_native]}


def test_slice_ten_modules_exist_and_import_neither_jax_nor_the_jax_package():
    """Data parallelism, the utilities, the SLURM launcher and the drivers are
    in the port, and the import walk above covers them."""
    sources = list(_sources())
    for module in ("parallel/mesh.py", "parallel/dryrun.py", "utils/video.py", "utils/scene_export.py",
                   "utils/profiling.py", "utils/rna.py", "pbt/slurm.py", "deploy/drivers.py"):
        path = os.path.join(ROOT, PORT, module)
        assert any(os.path.samefile(p, path) for p in sources if os.path.exists(p)), module
        tree = ast.parse(open(path).read(), filename=path)
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
        assert not [n for n in names if _forbidden(n)], (module, names)


def test_slice_ten_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    """The dry run, the rollout video, the EKI arm and a rank's process group:
    without a GPU and without a CPU request they raise before any work."""
    from isaacgyminsertion_tpu_torch.assets import build_subassembly_set
    from isaacgyminsertion_tpu_torch.deploy.drivers import EkiIiwaArm
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.parallel import dryrun, mesh
    from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
    from isaacgyminsertion_tpu_torch.utils.video import record_eval_video

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    act = lambda s: torch.zeros((1, 6))
    for call in (lambda: dryrun.dryrun(2, "gloo"),
                 lambda: record_eval_video(default_task_config(), build_kuka_openhand(),
                                           build_subassembly_set(), act, 2, str(tmp_path / "v")),
                 lambda: EkiIiwaArm("127.0.0.1", port=9),
                 lambda: mesh.init("gloo", 0, 1, f"file://{tmp_path / 'rdv'}")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="nccl"):
        mesh.init("nccl", 0, 1, f"file://{tmp_path / 'rdv'}", device="cpu")
    assert not os.path.exists(tmp_path / "v")


def test_bench_and_entry_refuse_the_cpu_unless_asked():
    """The bench's worker and `entry` raise without a GPU and without a CPU
    request, before any work; importing the package loads no module of it
    beyond `__init__` (`make` and the bench import lazily)."""
    import subprocess
    import sys

    from isaacgyminsertion_tpu_torch import bench
    from isaacgyminsertion_tpu_torch.entry import entry

    probe = ("import sys, isaacgyminsertion_tpu_torch as p; "
             "print(sorted(m for m in sys.modules if m.startswith('isaacgyminsertion')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=ROOT, check=True)
    assert out.stdout.strip() == "['isaacgyminsertion_tpu_torch']"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    for call in (lambda: bench.worker("state", 2, 2), lambda: entry()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_pbt_slurm_dry_run_writes_the_reference_scripts(tmp_path, capsys):
    """`pbt/slurm.py --dry-run` writes the scripts that scripts/run_pbt_slurm.py
    writes, apart from the run command, the partition and the gres line."""
    import importlib.util

    from isaacgyminsertion_tpu_torch.pbt import slurm

    spec = importlib.util.spec_from_file_location("run_pbt_slurm_reference",
                                                  os.path.join(ROOT, "scripts", "run_pbt_slurm.py"))
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    argv = ["--policies", "6", "--jobs", "3", "--workspace", str(tmp_path / "ws"), "--num-envs", "256",
            "--extra=--mem=64G;--cpus-per-task=8", "--dry-run"]
    ref_paths = reference.main(argv)
    ref_texts = [open(p).read() for p in ref_paths]
    ref_out = capsys.readouterr().out
    paths = slurm.main(argv)
    texts = [open(p).read() for p in paths]
    out = capsys.readouterr().out
    assert paths == ref_paths and len(texts) == 3

    def expected(text):
        return (text.replace("python scripts/run_pbt.py", "python -m isaacgyminsertion_tpu_torch.pbt.run")
                .replace("#SBATCH --partition=tpu", "#SBATCH --partition=gpu")
                .replace("#SBATCH --nodes=1\n", "#SBATCH --nodes=1\n#SBATCH --gres=gpu:1\n"))

    assert texts == [expected(t) for t in ref_texts]
    assert "export POLICY_OFFSET=4" in texts[2] and "#SBATCH --mem=64G" in texts[0]
    assert out == expected(ref_out)
