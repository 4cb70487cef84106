"""Contact generation: the hand-written CUDA kernel (`csrc/contact_gen.cu`)
against its plain PyTorch version (`physics/contact_kernel.py`). The card-only
tests carry the `cuda` marker and skip without a GPU; the CPU test holds the
CPU path to the plain chain bit for bit. This file imports neither jax nor the
JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_contact_kernel.py
"""

import os

import pytest
import torch

from isaacgyminsertion_tpu_torch.assets import SOCKET_PT_COUNT, TABLE_PT_IDX, build_subassembly_set
from isaacgyminsertion_tpu_torch.envs import insertion
from isaacgyminsertion_tpu_torch.envs.config import default_task_config
from isaacgyminsertion_tpu_torch.ops import rotations as rot
from isaacgyminsertion_tpu_torch.physics import contact, engine
from isaacgyminsertion_tpu_torch.physics import contact_kernel as ck
from isaacgyminsertion_tpu_torch.physics.robot import build_kuka_openhand
from isaacgyminsertion_tpu_torch.utils import capture, profiling

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "teacher_r2b", "best_success")
TOL = 1e-5   # every field, every component


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ for sm_90a")
    return torch.device("cuda")


def _inputs(params, plug_q, plug_pos, tip_pos, tip_vel):
    """generate_contacts' arguments, in the engine's order."""
    com = plug_pos + rot.quat_apply(plug_q, engine._com_offset(params))
    p = params
    return (tip_pos, tip_vel, plug_q, plug_pos, com, p.socket_quat, p.socket_pos, p.kind_onehot, p.plug_hx,
            p.plug_hy, p.plug_length, p.hole_hx, p.hole_hy, p.socket_height, p.table_height, p.surface_points,
            p.surface_weights, p.contact)


def _random_inputs(n, seed, device, tilt=0.3, per_env_mu=False):
    """Every subassembly (all six section kinds) in turn over `n` envs; the
    plug tilted at random about the socket's axis, from above the plate down
    into the hole, so that its points lie inside, on and outside the socket's
    surfaces; each gel pad off a random point of the plug's surface, from 4 mm
    into the plug to 6 mm clear of it (the first pad's gel just touching)."""
    g = torch.Generator().manual_seed(seed)
    subs = build_subassembly_set()
    params = engine.make_params(subs, torch.arange(n) % subs.kind_onehot.shape[0], n)
    v = torch.randn(n, 3, generator=g) * tilt
    plug_q = torch.cat([0.5 * v, torch.ones(n, 1)], -1)
    plug_q = plug_q / plug_q.norm(dim=-1, keepdim=True)
    plug_pos = params.socket_pos + torch.randn(n, 3, generator=g) * torch.tensor([0.003, 0.003, 0.01])
    pick = torch.randint(0, params.surface_points.shape[1], (n, 3), generator=g)
    local = torch.gather(params.surface_points, 1, pick[..., None].expand(n, 3, 3))
    centre = torch.stack([torch.zeros(n), torch.zeros(n), 0.5 * params.plug_length], -1)[:, None]
    away = (local - centre) / (local - centre).norm(dim=-1, keepdim=True)
    standoff = contact.FINGERTIP_RADIUS + torch.rand(n, 3, 1, generator=g) * 0.01 - 0.004
    standoff[:, 0] = contact.FINGERTIP_RADIUS
    tip_pos = rot.quat_apply(plug_q[:, None].expand(n, 3, 4), local + away * standoff) + plug_pos[:, None]
    tip_vel = torch.randn(n, 3, 3, generator=g) * 0.05
    if per_env_mu:
        params = params._replace(contact=contact.MaterialParams(*(torch.rand(n, generator=g) for _ in range(3))))
    args = _inputs(params, plug_q, plug_pos, tip_pos, tip_vel)
    return tuple(type(a)(*(t.to(device) for t in a)) if isinstance(a, tuple) else a.contiguous().to(device)
                 for a in args)


def _assert_contacts(out, ref, label=""):
    for f in out._fields:
        a, b = getattr(out, f), getattr(ref, f).expand_as(getattr(out, f))
        assert a.shape == b.shape and a.dtype == torch.float32, (label, f)
        err = (a - b).abs()
        worst = float(err.max())
        if not worst <= TOL:
            i = tuple(int(x) for x in torch.nonzero(err == err.max())[0])
            raise AssertionError(f"{label} {f}: max abs error {worst:.3e} at {i}: kernel {a[i[:2]].tolist()}, "
                                 f"plain {b[i[:2]].tolist()}")


def test_generate_contacts_on_the_cpu_is_the_plain_chain_bit_for_bit():
    """On the CPU `generate_contacts` is the plain chain the engine ran before
    the kernel: the fingertip patches, the socket and table point subsets,
    concatenated; no kernel launch is counted."""
    args = _random_inputs(14, 0, "cpu", per_env_mu=True)
    (tip_pos, tip_vel, plug_q, plug_pos, com, socket_q, socket_pos, kind, plug_hx, plug_hy, plug_len, hole_hx,
     hole_hy, socket_h, table_h, points, weights, mat) = args
    before = profiling.launches()["contact_gen"]
    cs = ck.generate_contacts(*args)
    assert profiling.launches()["contact_gen"] == before
    cs_fing, _ = contact.fingertip_plug_contacts(tip_pos, tip_vel, plug_q, plug_pos, com, kind, plug_hx, plug_hy,
                                                 plug_len, mat)
    idx = torch.as_tensor(TABLE_PT_IDX, dtype=torch.long)
    cs_env = contact.plug_env_contacts(points[:, :SOCKET_PT_COUNT], weights[:, :SOCKET_PT_COUNT], points[:, idx],
                                       weights[:, idx], plug_q, plug_pos, com, socket_q, socket_pos, kind,
                                       hole_hx, hole_hy, socket_h, table_h, mat)
    ref = contact.concat_contacts(cs_fing, cs_env)
    assert cs.depth.shape == (14, ck.FINGER_SLOTS + SOCKET_PT_COUNT + len(TABLE_PT_IDX))
    for f in cs._fields:
        assert torch.equal(getattr(cs, f), getattr(ref, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 256, 8192])
def test_contact_gen_matches_plain_on_every_kind(cuda_device, n):
    """All six section families, plug and socket, at random tilted poses with
    the pads and the plug's points inside, on and outside the surfaces; one
    friction coefficient for all envs (the default materials) and one per env
    (domain randomization)."""
    for seed, tilt in ((0, 0.3), (1, 1.5), (2, 0.02)):
        args = _random_inputs(n, seed, cuda_device, tilt=tilt, per_env_mu=seed == 1)
        before = profiling.launches()["contact_gen"]
        out = ck.generate_contacts(*args)
        torch.cuda.synchronize()
        assert profiling.launches()["contact_gen"] == before + 1
        _assert_contacts(out, ck.generate_contacts_plain(*args), f"n={n} seed={seed}")


@pytest.mark.cuda
def test_contact_gen_matches_plain_at_axis_aligned_poses(cuda_device):
    """Axis-aligned plugs over the hole's axis, where the symmetric sample
    points meet the ties of max, min, abs and sign; the pads on the plug's
    axes and corners."""
    subs = build_subassembly_set()
    n = 7 * 6
    params = engine.make_params(subs, torch.arange(n) % 7, n)
    quats = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.7071067811865476, 0.7071067811865476],
                          [0.7071067811865476, 0.0, 0.0, 0.7071067811865476], [0.0, 0.0, 1.0, 0.0],
                          [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0]])
    dz = torch.tensor([0.0, 0.02, 0.03, 0.005, -0.002, 0.001])
    plug_q = quats.repeat_interleave(7, 0)
    plug_pos = params.socket_pos + torch.stack([torch.zeros(n), torch.zeros(n), dz.repeat_interleave(7)], -1)
    hx, hy, ln = params.plug_hx, params.plug_hy, params.plug_length
    zero = torch.zeros(n)
    local = torch.stack([torch.stack([hx + 0.002, zero, 0.5 * ln], -1), torch.stack([-hx, zero, 0.5 * ln], -1),
                         torch.stack([hx, hy, ln], -1)], 1)
    tip_pos = rot.quat_apply(plug_q[:, None].expand(n, 3, 4), local) + plug_pos[:, None]
    args = _inputs(params, plug_q, plug_pos, tip_pos, torch.zeros(n, 3, 3))
    args = tuple(type(a)(*(t.to(cuda_device) for t in a)) if isinstance(a, tuple) else a.contiguous().to(cuda_device)
                 for a in args)
    out = ck.generate_contacts(*args)
    torch.cuda.synchronize()
    _assert_contacts(out, ck.generate_contacts_plain(*args), "axis-aligned")


@pytest.mark.cuda
def test_contact_gen_matches_plain_on_r2b_rollout_substeps(cuda_device):
    """Substeps of a 1024-env rollout of the banked r2b teacher from reset:
    the contact sets the teacher's eval and PPO training generate."""
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    rec = capture.rollout_contact_inputs(cfg, model, subs, 1024, steps=120, every=40, dev=cuda_device,
                                         checkpoint=CHECKPOINT)
    assert len(rec) == 9
    for i, args in enumerate(rec):
        out = ck.generate_contacts(*args)
        torch.cuda.synchronize()
        _assert_contacts(out, ck.generate_contacts_plain(*args), f"substep {40 * i + 39}")


@pytest.mark.cuda
def test_engine_step_with_the_kernel_matches_the_plain_contacts(cuda_device, monkeypatch):
    """One engine step (3 substeps) on the card from a reset of 256 envs:
    with the contact generation kernel against the plain contact generation,
    within the engine's 1e-4; one kernel launch per substep, as many as the
    solver's."""
    cfg, model, subs = default_task_config(), build_kuka_openhand(), build_subassembly_set()
    n = 256
    with torch.no_grad():
        s = insertion.reset_all(cfg, model, subs, insertion.make_generator(0, cuda_device), n)
        ctrl = engine.ControlInput(q_target=s.phys.q + 0.01, tau_cmd=torch.zeros_like(s.phys.q),
                                   torque_mode_mask=torch.zeros(15, device=cuda_device),
                                   plug_wrench=torch.zeros((n, 6), device=cuda_device))
        before = profiling.launches()
        out = engine.step(model, s.params, s.phys, ctrl)
        torch.cuda.synchronize()
        after = profiling.launches()
        assert after["contact_gen"] - before["contact_gen"] == cfg.sim.substeps
        assert after["contact_solver"] - before["contact_solver"] == cfg.sim.substeps
        monkeypatch.setattr(engine, "generate_contacts", ck.generate_contacts_plain)
        ref = engine.step(model, s.params, s.phys, ctrl)
    for f in engine.PhysicsState._fields:
        a, b = getattr(out, f), getattr(ref, f)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=f)


@pytest.mark.cuda
def test_contact_gen_refuses_what_it_does_not_take(cuda_device):
    args = _random_inputs(4, 0, cuda_device)
    with pytest.raises(ValueError):   # CPU tensors
        ck.generate_contacts_cuda(*_random_inputs(4, 0, "cpu"))
    with pytest.raises(TypeError):    # float64
        ck.generate_contacts_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError):   # wrong shape: 2 fingers
        ck.generate_contacts_cuda(args[0][:, :2].contiguous(), *args[1:])
    with pytest.raises(ValueError):   # non-contiguous
        ck.generate_contacts_cuda(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):   # one tensor left on the CPU
        ck.generate_contacts_cuda(*args[:2], args[2].cpu(), *args[3:])
