"""The DAgger epoch's spans and counter (`utils.profiling`): the rollout's
policy span split into the teacher's and the student's forwards, and the
bytes of the reservoir's frame buffers counted once as it allocates them.
One tiny epoch of the visuotactile student (tactile + seg + point cloud,
latent injected into the banked teacher) on the CPU, built as the benchmark
builds it; and the check numbers of the benchmark's tiny r5 cell, which the
spans leave as they were pinned."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
for path in (ROOT, os.path.join(ROOT, "portbench", "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)

import tiny  # noqa: E402  (the benchmark's tiny cells, `portbench/tests/tiny.py`)
from isaacgyminsertion_tpu_torch.algo import ext_adapt  # noqa: E402
from isaacgyminsertion_tpu_torch.utils import profiling  # noqa: E402
from portbench import run, systems  # noqa: E402
from portbench.reference import check  # noqa: E402


@pytest.fixture
def one_thread():
    """The pins were read on one CPU thread: the CPU's matmuls sum in another
    order on several."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_policy_spans_and_reservoir_frame_bytes(one_thread):
    profiling.clear_counters("dagger.")
    _, _, cfg, mix = tiny.cell("student_dagger_r3.tactile_256", envs=2, horizon=2, mini_epochs=2)
    system = systems.build(cfg, mix, tiny.SEED, tiny.CPU, run.ROOT)
    metrics = system.epoch()
    teacher, student = metrics["time/rollout.policy.teacher_s"], metrics["time/rollout.policy.student_s"]
    assert teacher > 0 and student > 0
    assert teacher + student <= metrics["time/rollout.policy_s"]
    rows = system.te.reservoir.rows
    frames = [k for k in ext_adapt.FRAME_KEYS if k in rows]
    assert [k for k in frames if rows[k].numel()] == ["tactile", "seg", "pcl"]
    assert all(rows[k].dtype == torch.float16 for k in ("tactile", "seg", "pcl"))
    assert profiling.counters()["dagger.reservoir_frame_bytes"] == sum(rows[k].nbytes for k in frames)
    system.epoch()   # allocated once: a second write adds nothing
    assert profiling.counters()["dagger.reservoir_frame_bytes"] == sum(rows[k].nbytes for k in frames)


def test_r5_check_numbers_are_the_pinned_ones(one_thread):
    name = "student_dagger_r5.pcl_256"
    with open(os.path.join(ROOT, "portbench", "tests", "pinned.json")) as f:
        pinned = json.load(f)["checks"][name]["sound"]
    _, _, cfg, mix = tiny.cell(name)
    system = systems.build(cfg, mix, tiny.SEED, tiny.CPU, run.ROOT)
    steps = check.followed_steps(mix, system.control_steps, tiny.SEED)
    cap, metrics = system.capture_epoch(steps)
    system.free()
    assert "time/rollout.policy.student_s" in metrics
    ref = check.follow(cap, cfg, mix, tiny.SEED, tiny.CPU, steps)
    got = check.compare(check.outputs_of_capture(cap, cfg, steps), ref)
    assert json.loads(json.dumps(got)) == pinned
