"""Readings pinned from the harness before its algorithm and network kinds
were looked up by name (`pinned.json`): the weight layouts that the seeded
draw follows, the networks' FLOPs at the cells' full sizes, and every number
the check gives on the tiny CPU cells, sound and with the half-batch and
altered-token faults. They hold exactly, so moving code behind a lookup
changed no weight, no `mfu` and no check."""

import json
import os

import pytest
import torch

import tiny
from portbench import run, systems, weights
from portbench.reference import check

PINNED = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "pinned.json")))


@pytest.mark.parametrize("config, block", [("teacher_ppo", "policy"), ("student_dagger_r5", "student")])
def test_weight_layout(config, block):
    got = [[name, list(shape), fan_in] for name, shape, fan_in in weights.layout(tiny.config(config)[block])]
    assert got == PINNED["layouts"][f"{config}.{block}"]


@pytest.mark.parametrize("name", sorted(PINNED["flops"]))
def test_full_size_flops(name):
    _, _, cfg, mix = run.cell_spec(name)
    assert systems.kind(cfg).System.counts(cfg, mix)["flops"] == PINNED["flops"][name]


@pytest.fixture
def one_thread():
    """The pins were read on one CPU thread: the CPU's matmuls sum in another
    order on several."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(PINNED["checks"]))
def test_check_numbers(name, one_thread):
    bench, cell, cfg, mix = tiny.cell(name)
    system = systems.build(cfg, mix, tiny.SEED, tiny.CPU, run.ROOT)
    steps = check.followed_steps(mix, system.control_steps, tiny.SEED)
    cap, _ = system.capture_epoch(steps)
    system.free()
    ref = check.follow(cap, cfg, mix, tiny.SEED, tiny.CPU, steps)
    got = {"sound": check.compare(check.outputs_of_capture(cap, cfg, steps), ref)}
    for fault in ("half_batch", "token"):
        got[fault] = check.compare(check.follow(cap, cfg, mix, tiny.SEED, tiny.CPU, steps, fault=fault,
                                                rollout=ref["rollout"]), ref)
    assert json.loads(json.dumps(got)) == PINNED["checks"][name]
