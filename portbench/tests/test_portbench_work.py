"""The frozen work counts: the networks' analytic FLOPs against
`FlopCounterMode`'s matmul count on a tiny CPU epoch, and the kernels'
operations and bytes against the port's own functions."""

import functools

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

import tiny
from portbench import run, systems
from portbench.work import kernels


def _uncounted(fn):
    """`fn` with the FLOP counter off: the env's own matmuls are physics, not the networks'."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with _disable_current_modes():
            return fn(*a, **kw)
    return wrapped


@pytest.mark.parametrize("name", ["teacher_ppo.state_4096", "student_dagger_r5.pcl_256"])
def test_network_flops_equal_the_counted_matmuls(name, monkeypatch):
    from isaacgyminsertion_tpu_torch.envs import insertion

    _, _, cfg, mix = tiny.cell(name, envs=2, horizon=2, mini_epochs=2)
    system = systems.build(cfg, mix, tiny.SEED, tiny.CPU, run.ROOT)
    system.epoch()
    monkeypatch.setattr(insertion, "step", _uncounted(insertion.step))
    monkeypatch.setattr(insertion, "priv_info_of", _uncounted(insertion.priv_info_of))
    counter = FlopCounterMode(display=False)
    with counter:
        system.epoch()
    assert counter.get_total_flops() == system.flops


def test_solver_counts_equal_the_ports():
    from isaacgyminsertion_tpu_torch.physics import solver_kernel as sk

    for n, c, active, iters, pos in [(1024, 37, 12_000, 16, 8), (8192, 200, 90_000, 16, 8), (3, 5, 0, 4, 2)]:
        assert kernels.solver_flops(n, c, active, iters, pos) == sk.flops(n, c, active, iters, pos)
        assert kernels.solver_bytes(n, c) == sk.bytes_moved(n, c)


def _rows(n: int, width: int, seed: int):
    """Packed rows with random values, about half of the half-plane slots and
    quadratic flags neutral (zero), as the counts read them."""
    g = torch.Generator().manual_seed(seed)
    scal = torch.randn((n, width), generator=g)
    return torch.where(torch.rand((n, width), generator=g) < 0.5, torch.zeros(()), scal)


@pytest.mark.parametrize("exact", [True, False])
def test_renderer_counts_equal_the_ports(exact):
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk

    scal = _rows(96, rk.TACTILE_ROW, 3)
    for kind in (None, "gauss", "ih4"):
        assert kernels.tactile_flops(scal, 4096, exact, 12, kind) == rk.tactile_flops(scal, 4096, exact, 12, kind)
    assert kernels.tactile_bytes(96, 4096) == rk.tactile_bytes_moved(96, 4096)
    scal = _rows(64, rk.CAMERA_ROW, 4)
    assert kernels.camera_flops(scal, 5184, exact, 24) == rk.camera_flops(scal, 5184, exact, 24)
    assert kernels.camera_bytes(64, 5184) == rk.camera_bytes_moved(64, 5184)
