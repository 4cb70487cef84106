"""A new configuration arrives as new files: the harness finds its algorithm
(`kinds/<algo>.py`, `reference/kinds/<algo>.py`) and its networks
(`reference/nets/<kind>.py`) by the names its file gives. Two students that
no cell runs go through a whole tiny CPU run without an edit to any harness
module: one written as data alone, one of a network kind registered by the
test. The reference's student inputs are held to the port's for every
modality the port's flags select."""

import sys
import types

import pytest
import torch

import tiny
from portbench import run


def test_obs_only_student_arrives_as_data(tmp_path):
    bench, cell, cfg, mix = tiny.written(tmp_path, tiny.obs_only_config(), "state_4096")
    result, checks = run.run(bench, cell, cfg, mix, tiny.SEED, 0.1, False, tiny.CPU)
    assert result["correct"], checks


def test_new_network_kind_arrives_as_a_module(tmp_path, monkeypatch):
    module = tiny.latent_kind()
    monkeypatch.setitem(sys.modules, module.__name__, module)
    bench, cell, cfg, mix = tiny.written(tmp_path, tiny.latent_config(), "pcl_256")
    result, checks = run.run(bench, cell, cfg, mix, tiny.SEED, 0.1, False, tiny.CPU)
    assert result["correct"], checks


FLAGS = [{}, {"use_obs": True, "use_pcl": True, "only_bc": True}, {"use_img": True},
         {"use_obs": False, "use_seg": True}, {"use_tactile": True, "use_img": True, "use_seg": True, "use_pcl": True}]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(k for k, v in f.items() if v) or "defaults")
def test_student_inputs_are_the_ports(flags):
    from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.models.running_mean_std import RMSState

    from portbench.reference import algo
    from portbench.reference.kinds import dagger

    g = torch.Generator().manual_seed(7)
    n = 3
    queues = {"tactile": torch.rand((n, 1, 3, 8, 6, 3), generator=g).half(),
              "img": torch.rand((n, 2, 6, 8), generator=g).half(),
              "seg": torch.randint(0, 4, (n, 2, 6, 8), generator=g).half(),
              "pcl": torch.randn((n, 2, 10, 3), generator=g)}
    obs = torch.randn((n, 15), generator=g)
    rms = lambda d: (torch.randn(d, generator=g), torch.rand(d, generator=g) + 0.5, torch.tensor(7.0))
    obs_rms, pcl_rms = rms(15), rms(3)
    da_cfg = ea.DAggerConfig(**flags)
    out = insertion.StepOutput(obs=obs, student_obs=obs, priv_info=None, rew=None, reset=None, timeout=None,
                               extras={}, contacts=None, pcl=queues["pcl"],
                               **{k: queues[k].float() for k in ("tactile", "img", "seg")})
    want = ea._student_inputs(da_cfg, ea.StudentBundle(None, RMSState(*obs_rms), RMSState(*pcl_rms)), obs, out)
    frames = dagger.stored_frames(flags)
    got = dagger.student_inputs(flags, algo.RMS(*obs_rms), algo.RMS(*pcl_rms), obs,
                                {k: queues[k].float() for k in frames})
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    state = types.SimpleNamespace(obs_queue=obs, **{f"{k}_queue": q for k, q in queues.items()})
    assert [k for k, v in ea._sample_modalities(da_cfg, state).items() if v.numel()] == frames
