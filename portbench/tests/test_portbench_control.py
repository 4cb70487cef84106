"""The control on the card: the reference in TF32 in the program's place,
and the faults planted in it, read over a tiny cell; each has to fail one of
the cell's limits. Run on a card with
`python -m pytest -p no:cacheprovider portbench/tests/test_portbench_control.py`."""

import pytest
import torch

import tiny
from portbench.reference import check
from portbench import run, systems


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["teacher_ppo.state_4096", "student_dagger_r5.pcl_256"])
def test_control_and_faults_fail_a_limit(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    bench, cell, cfg, mix = tiny.cell(name, envs=256, horizon=4, mini_epochs=4)
    system = systems.build(cfg, mix, tiny.SEED, dev, run.ROOT)
    steps = check.followed_steps(mix, system.control_steps, tiny.SEED)
    cap, _ = system.capture_epoch(steps)
    system.free()
    ref = check.follow(cap, cfg, mix, tiny.SEED, dev, steps)
    sound = check.compare(check.outputs_of_capture(cap, cfg, steps), ref)
    lim = run.limits(cfg, mix)
    assert all(sound[k] <= limit for k, limit in lim.items()), sound
    for kw in (dict(tf32=True), dict(fault="half_batch", rollout=ref["rollout"]),
               dict(fault="token", rollout=ref["rollout"])):
        got = check.compare(check.follow(cap, cfg, mix, tiny.SEED, dev, steps, **kw), ref)
        assert any(got[k] > limit for k, limit in lim.items()), (kw, got)
