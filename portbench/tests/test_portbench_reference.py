"""The plain reference against the port on a tiny CPU epoch, and the faults
that the check must catch, planted in the program under the harness: a step
that returns its state unchanged, half of each minibatch left out (the mean
over the rest), and a token altered where it is produced."""

import pytest

import tiny
from portbench import run

CELLS = ["teacher_ppo.state_4096", "student_dagger_r5.pcl_256"]


def _run(name):
    bench, cell, cfg, mix = tiny.cell(name)
    return run.run(bench, cell, cfg, mix, tiny.SEED, 0.1, False, tiny.CPU)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    result, checks = _run(name)
    assert result["correct"], checks
    # on the CPU the program's env runs the code the reference's snapshot
    # copies, so the env gaps are nought by construction: this holds the
    # harness's recording and rebuilding of states, not the env itself
    assert checks["env_step_gap"]["value"] == 0.0 and checks["reset_gap"]["value"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_fails(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result, checks = _run(name)
    assert not result["correct"] and checks["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_fails(name, monkeypatch):
    from isaacgyminsertion_tpu_torch.algo import ext_adapt, ppo

    te_cls = ppo.TrainEpoch if name.startswith("teacher") else ext_adapt.TrainEpoch
    loss = te_cls.loss

    def half(self, *a, **kw):
        mb = a[-1]
        return loss(self, *a[:-1], {k: v[: v.shape[0] // 2] for k, v in mb.items()}, **kw)

    monkeypatch.setattr(te_cls, "loss", half)
    result, checks = _run(name)
    assert not result["correct"]
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"] or \
        checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_altered_token_fails(name, monkeypatch):
    from isaacgyminsertion_tpu_torch.envs import insertion

    step = insertion.step
    calls = [0]

    def altered(*a, **kw):
        state, out = step(*a, **kw)
        calls[0] += 1
        if calls[0] == 3:
            obs = state.obs_queue.clone()
            obs[1, 2] += 0.5
            state = state._replace(obs_queue=obs)
        return state, out

    monkeypatch.setattr(insertion, "step", altered)
    result, checks = _run(name)
    assert not result["correct"] and checks["env_step_gap"]["value"] > checks["env_step_gap"]["limit"]


def test_philox_known_answers():
    """The reference's Philox-4x32-10, the tactile kernel's noise generator,
    against the known-answer vectors of its authors (Random123)."""
    import torch

    from portbench.reference.frozen.sensors.render_kernels import philox4x32_10

    vectors = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
               ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
               ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
                (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in vectors:
        got = philox4x32_10(*[torch.tensor([v], dtype=torch.int64) for v in ctr + key])
        assert tuple(int(w) for w in got) == want


def test_altered_student_action_fails(monkeypatch):
    """The student's rollout action is compared too, though the teacher-only
    window leaves it out of the step: altered where it is produced (the
    rollout's forward, not the update's), it fails `policy_gap`."""
    import torch

    from isaacgyminsertion_tpu_torch.algo import ext_adapt

    make = ext_adapt.make_student_act

    def altered_make(*a, **kw):
        act = make(*a, **kw)

        def altered(*b, **kw2):
            s_actions, pred = act(*b, **kw2)
            return (s_actions if torch.is_grad_enabled() else s_actions + 0.5), pred
        return altered

    monkeypatch.setattr(ext_adapt, "make_student_act", altered_make)
    result, checks = _run("student_dagger_r5.pcl_256")
    assert not result["correct"] and checks["policy_gap"]["value"] > checks["policy_gap"]["limit"]
    assert checks["loss_gap"]["value"] <= checks["loss_gap"]["limit"]
