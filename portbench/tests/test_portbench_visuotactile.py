"""The visuotactile student (`student_dagger_r3`, network kind `visuotactile`)
against the port's `MultiModalModel` on the CPU, at the published widths and
batch 4, with seeded weights from `weights.make` and the banked teacher:
the latent, the action through the injected actor, every leaf's gradient of
the action loss, the odd SAME paddings, the segmentation token; the matmul
count behind `mfu` against `FlopCounterMode`; and the tiny cell through
`run.run`, sound and with one tactile frame altered in the reference's
input.

Tolerances. Both sides compute in float32 from the same weights and inputs
and differ only in the order of summation (the port's convolutions are the
library's, the reference's im2col matmuls), so the largest gap over the
largest magnitude of a tensor is ~1e-7 to 1e-6: `TOL` is 1e-5. TF32 keeps 10
bits of mantissa (a relative rounding of ~5e-4 on each operand), so the
reference run on operands rounded to TF32 misses by 1e-4 or more:
`test_tf32_operands_fail_the_tolerance` holds that."""

import math
import os

import pytest
import torch

import tiny
from portbench import control_frames, run, weights
from portbench.reference import algo, nets
from portbench.reference.kinds import dagger
from portbench.reference.nets import visuotactile as vt

TOL = 1e-5
B = 4
CELL = "student_dagger_r3.tactile_256"


@pytest.fixture(scope="module")
def setup():
    """The port's student and teacher bundle, the benchmark's weights for
    both, and one batch of inputs in the env's layouts."""
    from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea
    from isaacgyminsertion_tpu_torch.envs.config import default_task_config
    from isaacgyminsertion_tpu_torch.models.actor_critic import ActorCriticSplit
    from isaacgyminsertion_tpu_torch.models.running_mean_std import RMSState

    from portbench import systems

    cfg = tiny.config("student_dagger_r3")
    s, tc = cfg["student"], cfg["teacher"]
    _, _, _, mix = run.cell_spec(CELL)
    task = systems.task_config(default_task_config(), mix)
    da_cfg = systems.settings(ea.DAggerConfig, cfg["dagger"], s)
    w = weights.make(weights.layout(s), tiny.SEED, tiny.CPU)
    net = ea._make_student(task, da_cfg)
    net.load_state_dict(w, strict=True)
    sd, obs_rms, priv_rms = weights.load_teacher(os.path.join(run.ROOT, tc["checkpoint"]), tiny.CPU)
    tnet = ActorCriticSplit(num_actions=tc["num_actions"], obs_dim=tc["obs_dim"], priv_dim=tc["priv_dim"],
                            priv_units=tuple(tc["priv_units"]), units=tuple(tc["units"]))
    tnet.load_state_dict(sd, strict=True)
    teacher = ea.TeacherBundle(net=tnet.requires_grad_(False), obs_rms=RMSState(*obs_rms),
                               priv_rms=RMSState(*priv_rms))
    e = task.env
    g = torch.Generator().manual_seed(11)
    queues = {"tactile": torch.rand((B, 1, 3, 64, 64, 3), generator=g).half(),
              "seg": torch.randint(0, 5, (B, 1, 54, 96), generator=g).half(),
              "pcl": torch.randn((B, 1, e.num_points + e.num_points_socket, 3), generator=g) * 0.05}
    obs = torch.randn((B, s["obs_dim"]), generator=g)
    rms = lambda d: (torch.randn(d, generator=g) * 0.1, torch.rand(d, generator=g) + 0.5, torch.tensor(9.0))
    stud_rms, pcl_rms = rms(s["obs_dim"]), rms(3)
    return dict(cfg=cfg, s=s, task=task, da_cfg=da_cfg, w=w, net=net, teacher=teacher, queues=queues, obs=obs,
                stud_rms=stud_rms, pcl_rms=pcl_rms, sd=sd, obs_rms=obs_rms,
                t_actions=torch.rand((B, 6), generator=g) * 2 - 1)


def _port(st, grad=False):
    """(action, latent) of the port's `student_act` on the batch."""
    from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea
    from isaacgyminsertion_tpu_torch.envs import insertion
    from isaacgyminsertion_tpu_torch.models.running_mean_std import RMSState

    q = st["queues"]
    out = insertion.StepOutput(obs=st["obs"], student_obs=st["obs"], priv_info=None, rew=None, reset=None,
                               timeout=None, extras={}, contacts=None, pcl=q["pcl"], tactile=q["tactile"].float(),
                               img=torch.zeros((B, 0)), seg=q["seg"].float())
    student = ea.StudentBundle(st["net"], RMSState(*st["stud_rms"]), RMSState(*st["pcl_rms"]))
    act = ea.make_student_act(st["task"], st["da_cfg"], st["teacher"])
    with torch.set_grad_enabled(grad):
        return act(student, st["obs"], out)


def _reference(st, w, round_to=None):
    """(action, latent) of the reference kind on the batch; `round_to` maps
    every weight and input before the forward."""
    s, q = st["s"], st["queues"]
    r = round_to or (lambda x: x)
    w = {k: r(v) for k, v in w.items()}
    frames = {k: q[k].float() for k in dagger.stored_frames(s)}
    inputs = dagger.student_inputs(s, algo.RMS(*st["stud_rms"]), algo.RMS(*st["pcl_rms"]), st["obs"], frames)
    inputs = {k: r(v) for k, v in inputs.items()}
    teacher = {"block": st["cfg"]["teacher"], "weights": {k: r(v) for k, v in st["sd"].items()},
               "obs_rms": algo.RMS(*st["obs_rms"])}
    latent = vt.forward(w, s, inputs)
    return vt.act(latent, s, dagger._injector(teacher, st["obs"])), latent


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_latent_and_action_match_the_port(setup):
    p_act, p_lat = _port(setup)
    r_act, r_lat = _reference(setup, setup["w"])
    assert p_lat.shape == (B, 8) and p_act.shape == (B, 6)
    assert _gap(p_lat, r_lat) < TOL and _gap(p_act, r_act) < TOL


def _tf32(x):
    """x with its mantissa cut to TF32's 10 bits (the low 13 bits cleared),
    its gradient passed straight through."""
    if not x.dtype.is_floating_point:
        return x
    cut = (x.detach().float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return x + (cut - x).detach()


def _loss(actions, t_actions):
    wz = torch.ones(6)
    wz[2] = 0.1
    return torch.mean(wz * (actions - t_actions) ** 2)


def _reference_grads(st, round_to=None) -> dict:
    w = {k: v.clone().requires_grad_(True) for k, v in st["w"].items()}
    with torch.enable_grad():
        grads = torch.autograd.grad(_loss(_reference(st, w, round_to)[0], st["t_actions"]), list(w.values()))
    return dict(zip(w, grads))


def _worst_leaf(got: dict, ref: dict) -> tuple:
    """The worst leaf's largest gap over the larger of its magnitude and the
    median leaf's, as the check's `grad_gap` scales it: the attention key
    biases' gradient is nought but for round-off (softmax does not see a
    shift shared by every key)."""
    med = float(torch.tensor([float(g.abs().max()) for g in ref.values()]).median())
    gaps = {n: float((got[n] - ref[n]).abs().max()) / max(float(ref[n].abs().max()), med) for n in ref}
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst]


def test_tf32_operands_fail_the_tolerance(setup):
    p_act, p_lat = _port(setup)
    r_act, r_lat = _reference(setup, setup["w"], round_to=_tf32)
    assert max(_gap(p_lat, r_lat), _gap(p_act, r_act)) > 10 * TOL
    assert _worst_leaf(_reference_grads(setup, _tf32), _reference_grads(setup))[1] > 10 * TOL


def test_every_leafs_gradient_matches_the_port(setup):
    st = setup
    st["net"].zero_grad()
    _loss(_port(st, grad=True)[0], st["t_actions"]).backward()
    port = {n: p.grad for n, p in st["net"].named_parameters()}
    ref = _reference_grads(st)
    assert set(port) == set(ref)
    worst, gap = _worst_leaf(port, ref)
    assert gap < TOL, (worst, gap)
    assert all(float(ref[n].abs().max()) > 0 for n in ref if "key.bias" not in n)


@pytest.mark.parametrize("size, pads", [(64, (0, 1)), (27, (1, 1)), (54, (0, 1)), (14, (0, 1)), (7, (1, 1)),
                                        (96, (0, 1)), (48, (0, 1)), (12, (0, 1))])
def test_same_padding_puts_the_odd_pixel_after(size, pads):
    assert vt.same_pads(size, 3, 2) == pads
    assert vt.conv_out((size, size), 1)[0] == math.ceil(size / 2)


@pytest.mark.parametrize("h, w", [(27, 48), (7, 12), (64, 64)])
def test_unfold_convolution_matches_the_ports(h, w):
    """The reference's convolution (pad, `F.unfold`, matmul) against the
    port's `SameConv` at the odd sizes of the seg stack (27→14, 7→4)."""
    from isaacgyminsertion_tpu_torch.models.student import SameConv

    g = torch.Generator().manual_seed(h * w)
    conv = SameConv(5, 8, 3, 2)
    x = torch.randn((2, 5, h, w), generator=g)
    got = vt.conv_same(x, conv.weight.detach(), conv.bias.detach(), 2)
    want = conv(x).detach()
    assert got.shape == want.shape == (2, 8, math.ceil(h / 2), math.ceil(w / 2))
    assert _gap(got, want) < TOL


def test_seg_token_matches_the_ports_on_masks(setup):
    """The seg ids → {plug, socket} masks (the reference's inputs), then the
    seg CNN and its (H, W, C) flatten, against the port's `DepthCNN`."""
    from isaacgyminsertion_tpu_torch.algo import ext_adapt as ea
    from isaacgyminsertion_tpu_torch.sensors.camera import SEG_PLUG, SEG_SOCKET

    st, s = setup, setup["s"]
    seg = st["queues"]["seg"].float()
    masks = dagger.student_inputs(s, algo.RMS(*st["stud_rms"]), algo.RMS(*st["pcl_rms"]), st["obs"],
                                  {"tactile": st["queues"]["tactile"].float(), "seg": seg,
                                   "pcl": st["queues"]["pcl"]})["seg"]
    assert torch.equal(masks, ea._seg_masks(seg[:, -1])[:, None])
    assert float(masks.sum()) == float(((seg == SEG_PLUG) | (seg == SEG_SOCKET)).sum()) > 0
    with torch.no_grad():
        want = st["net"].seg_enc(masks[:, 0])
    assert _gap(vt.seg_token(st["w"], s, masks[:, 0]), want) < TOL


def test_macs_per_sample_equal_the_counted_matmuls(setup):
    """The kind's per-sample multiply-adds against `FlopCounterMode` on the
    port's student (forward through the injected actor, then forward and
    backward of the action loss). The one difference is the soft-argmax's
    two weighted sums, which the port computes as products and sums that the
    counter does not count; `ops` counts them as the [C, H·W] × [H·W, 2]
    product they are."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.work import models

    st, cfg = setup, setup["cfg"]
    ops = nets.kind(st["s"]).ops(st["s"], cfg)
    sa = vt.softargmax_ops(st["s"])
    assert sa[0][0] == 64 * 8 * 8 * 2
    convs = vt.conv_stack_ops(9, (64, 64), [32, 64, 64]) + vt.conv_stack_ops(2, (54, 96), [32, 64, 64, 128])
    assert sum(m for m, _, _ in convs) == 21_537_792          # 21.5 M of the student's multiply-adds
    counter = FlopCounterMode(display=False)
    with counter:
        _port(st)
    assert counter.get_total_flops() == B * (models.forward_flops(ops) - models.forward_flops(sa))
    st["net"].zero_grad()
    counter = FlopCounterMode(display=False)
    with counter:
        _loss(_port(st, grad=True)[0], st["t_actions"]).backward()
    assert counter.get_total_flops() == B * (models.train_flops(ops) - models.train_flops(sa))


@pytest.fixture
def kernel_noise(monkeypatch):
    """The card's tactile noise on the CPU. The port's plain tactile renderer
    draws its noise with `torch.randn` from the env's generator, its CUDA
    kernel one 64-bit seed and then Philox-4x32-10 (the two differ by design,
    `render_kernels`' docstring); the reference follows the kernel. So the
    program's plain renderer gets the reference's, the kernel's noise
    stream, and the CPU runs the draws the card runs."""
    from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk

    from portbench.reference.frozen.sensors import render_kernels as frozen_rk

    monkeypatch.setattr(rk, "tactile_rows_plain", frozen_rk.tactile_rows_plain)


def _tiny_run(traced=False):
    bench, cell, cfg, mix = tiny.cell(CELL)
    return run.run(bench, cell, cfg, mix, tiny.SEED, 0.1, traced, tiny.CPU)


def test_tiny_cell_is_correct(kernel_noise):
    from isaacgyminsertion_tpu_torch.utils import profiling

    profiling.clear_counters("dagger.")
    result, checks = _tiny_run(traced=True)
    assert result["correct"], checks
    assert checks["env_step_gap"]["value"] == 0.0 and checks["reset_gap"]["value"] == 0.0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < m["student_policy_ms_per_step.mem"] < m["policy_ms_per_step.mem"]
    # the tiny cut's 64 rows of float16 frames: tactile 3·64·64·3, seg 54·96, cloud 800·3
    assert m["reservoir_frame_gb.mem"] == 64 * 2 * (36_864 + 5_184 + 2_400) / 1e9


def test_new_readers_read_nothing_without_the_programs_span_or_counter():
    from types import SimpleNamespace

    from isaacgyminsertion_tpu_torch.utils import profiling

    key = "time/rollout.policy.student_s"
    ctx = lambda epochs: SimpleNamespace(system=SimpleNamespace(control_steps=4), epochs=epochs)
    read = run.metric_module("student_policy_ms_per_step.mem").read
    assert read(ctx([{key: 0.010}, {key: 0.030}])) == pytest.approx(0.040 / 8 * 1e3)
    assert read(ctx([{"time/rollout.policy_s": 0.1}])) is None
    profiling.clear_counters("dagger.")
    assert run.metric_module("reservoir_frame_gb.mem").read(ctx([])) is None
    profiling.count("dagger.reservoir_frame_bytes", 35_558_400_000)
    assert run.metric_module("reservoir_frame_gb.mem").read(ctx([])) == 35.5584
    profiling.clear_counters("dagger.")


def test_altered_tactile_frame_fails_policy_gap(kernel_noise):
    """One env's tactile frame (one finger) raised by 1.0 in the reference's
    input at its first rollout step moves that env's student action (the
    fault `control_frames` plants on the card)."""
    with control_frames.altered_tactile_frame():
        result, checks = _tiny_run()
    assert not result["correct"] and checks["policy_gap"]["value"] > checks["policy_gap"]["limit"]
    assert checks["loss_gap"]["value"] <= checks["loss_gap"]["limit"]
