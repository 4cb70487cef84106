"""The renderers' plain versions, port vs JAX reference on the same numpy
inputs. The JAX side runs its Pallas kernels in interpret mode (`fused=True`
off the TPU), as the reference's own render tests do.

Noise is off. Both sides compute the same closed forms in fp32 in a different
operation order, so images agree to ~1e-6 except where a silhouette pixel
flips: mean abs diff < 1e-4 and fewer than 0.5 % of the pixels off by more
than 1e-3; segmentation ids equal off those pixels. The march variants run
with few iterations (interpret mode compiles slowly); their tolerance is the
same, since both sides take the same steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgyminsertion_tpu.sensors import camera as j_cam
from isaacgyminsertion_tpu.sensors import render_pallas as j_rp
from isaacgyminsertion_tpu.sensors import tactile as j_tact
from isaacgyminsertion_tpu_torch.sensors import camera as t_cam
from isaacgyminsertion_tpu_torch.sensors import render_kernels as rk
from isaacgyminsertion_tpu_torch.sensors import tactile as t_tact

torch.set_num_threads(1)

N = 6   # one env per section family


def _assert_images(j, t, what):
    d = np.abs(np.asarray(j) - t.numpy())
    assert np.isfinite(t.numpy()).all(), what
    assert d.mean() < 1e-4, (what, d.mean())
    assert (d > 1e-3).mean() < 5e-3, (what, (d > 1e-3).mean())
    return d > 1e-3


@pytest.mark.parametrize("method,iters", [("exact", 12), ("march", 4)])
def test_tactile_matches_the_fused_reference(method, iters):
    args = rk.random_tactile_inputs(N, seed=3)
    j_img = j_tact.render_tactile(j_tact.TactileConfig(march_iters=iters),
                                  *[jnp.asarray(a) for a in args], fused=True, method=method)
    t_img = t_tact.render_tactile(t_tact.TactileConfig(march_iters=iters),
                                  *[torch.as_tensor(a) for a in args], method=method)
    assert tuple(t_img.shape) == (N, 3, 64, 64, 3)
    assert (np.asarray(j_img) > 0.01).mean() > 0.03      # the pads do see the plug
    _assert_images(j_img, t_img, f"tactile {method}")


def test_tactile_one_channel_and_glow():
    args = [torch.as_tensor(a) for a in rk.random_tactile_inputs(2, seed=5)]
    rgb = t_tact.render_tactile(t_tact.TactileConfig(), *args)
    gray = t_tact.render_tactile(t_tact.TactileConfig(num_channels=1), *args)
    assert tuple(gray.shape) == (2, 3, 64, 64, 1)
    np.testing.assert_allclose(gray.numpy(), rgb.mean(-1, keepdim=True).numpy(), atol=1e-6)
    glow = t_tact.render_tactile(t_tact.TactileConfig(diff=False), *args)
    mask = t_tact.gel_mask(t_tact.TactileConfig()).reshape(64, 64)
    dark = (rgb.sum(-1) == 0) & (mask > 0)
    np.testing.assert_allclose(glow[dark].numpy(), 0.15, atol=1e-6)
    assert float(glow[:, :, mask == 0].abs().max()) == 0.0


def test_tactile_rows_match_the_pallas_kernel_with_interior_origins():
    """`tactile_march_fused` on rows whose ray origin lies INSIDE the prism
    (deep indentation: shading takes the nearest-face gradient), all six
    families, against the port's plain version on the same rows."""
    rng = np.random.default_rng(7)
    r, p = 12, 256
    eye = np.eye(3, dtype=np.float32)
    M = np.stack([eye] * r)
    oh = np.eye(6, dtype=np.float32)[np.arange(r) % 6]
    hx = rng.uniform(0.008, 0.02, r).astype(np.float32)
    hy = (hx * rng.uniform(0.8, 1.2, r)).astype(np.float32)
    length = rng.uniform(0.03, 0.06, r).astype(np.float32)
    # the first six origins inside the prism, the rest 2 cm below its base
    o = np.zeros((r, 3), np.float32)
    o[:6] = np.stack([0.2 * hx[:6], -0.2 * hy[:6], 0.3 * length[:6]], -1)
    o[6:] = np.stack([0.2 * hx[6:], 0.1 * hy[6:], np.full(6, -0.02)], -1)
    force = rng.uniform(0, 8, r).astype(np.float32)
    rays = rng.normal(size=(p, 3)) * 0.5 + np.array([0.0, 0.0, 1.0])
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(np.float32)
    kw = dict(iters=4, max_range=0.06, max_deformation=0.01, force_range=10.0)
    for exact in (True, False):
        j = j_rp.tactile_march_fused(*[jnp.asarray(a) for a in (M, o, oh, hx, hy, length, force, rays)],
                                     exact=exact, interpret=True, **kw)
        t = rk.tactile_render_plain(*[torch.as_tensor(a) for a in (M, o, oh, hx, hy, length, force, rays)],
                                    exact=exact, **kw)
        assert tuple(t.shape) == (r, p, 3)
        assert (np.asarray(j)[:6] > 0.01).mean() > 0.2   # interior origins are lit
        _assert_images(j, t, f"tactile rows exact={exact}")


def test_reference_paths_differ_for_an_origin_inside_a_trapezoid_and_the_port_follows_the_fused_one():
    """A fault of the reference, not of the port: with the gel camera's origin
    inside a trapezoid plug (deep indentation), the reference's XLA path
    (`fused=False`, what its env takes off the TPU) and its fused Pallas path
    (what it takes on the TPU) shade the same rays differently. The port
    reproduces the fused path."""
    tip_q = np.array([[[0.42876196, 0.45951527, 0.04115306, -0.77673376]]], np.float32)
    tip_q = tip_q / np.linalg.norm(tip_q)
    o_p = np.array([[[-0.00022663, 0.01557951, 0.05736174]]], np.float32)   # inside the prism
    y_site = t_tact.rot.quat_to_matrix(torch.as_tensor(tip_q))[0, 0, :, 1].numpy()
    tip_t = (o_p - y_site * 0.02).astype(np.float32)       # the camera sits 2 cm behind the pad site
    args = (tip_q, tip_t, np.array([[0, 0, 0, 1.0]], np.float32), np.zeros((1, 3), np.float32),
            np.eye(6, dtype=np.float32)[[4]], np.array([0.0165], np.float32),
            np.array([0.033], np.float32), np.array([0.0838], np.float32), np.array([[2.0]], np.float32))
    j_args = [jnp.asarray(a) for a in args]
    xla = np.asarray(j_tact.render_tactile(j_tact.TactileConfig(), *j_args, fused=False))
    fused = np.asarray(j_tact.render_tactile(j_tact.TactileConfig(), *j_args, fused=True))
    port = t_tact.render_tactile(t_tact.TactileConfig(), *[torch.as_tensor(a) for a in args]).numpy()
    assert fused.mean() > 0.1                               # the finger is lit
    assert np.abs(xla - fused).mean() > 0.02                # the reference's two paths disagree
    assert np.abs(port - fused).mean() < 1e-4               # the port is the fused path


def _camera_args(n, seed):
    args, kw = rk.random_camera_inputs(n, seed)
    jk = {k: (jnp.asarray(v) if hasattr(v, "shape") else v) for k, v in kw.items()}
    tk = {k: (torch.as_tensor(v) if hasattr(v, "shape") else v) for k, v in kw.items()}
    return [jnp.asarray(a) for a in args], jk, [torch.as_tensor(a) for a in args], tk


@pytest.mark.parametrize("method,iters", [("exact", 24), ("march", 3)])
def test_camera_matches_the_fused_reference(method, iters):
    ja, jk, ta, tk = _camera_args(N, seed=1)
    j_dn, j_seg, j_raw = j_cam.render_depth_seg(j_cam.CameraConfig(march_iters=iters), *ja, fused=True,
                                                method=method, **jk)
    t_dn, t_seg, t_raw = t_cam.render_depth_seg(t_cam.CameraConfig(march_iters=iters), *ta,
                                                method=method, **tk)
    assert tuple(t_dn.shape) == (N, 54, 96) and t_seg.dtype == torch.long
    if method == "exact":
        counts = np.bincount(np.asarray(j_seg).ravel(), minlength=4)
        assert (counts > 50).all(), counts               # table, robot, plug and socket all visible
    _assert_images(j_dn, t_dn, f"camera {method} depth_norm")
    flipped = _assert_images(j_raw, t_raw, f"camera {method} depth_raw")
    seg_diff = (np.asarray(j_seg) != t_seg.numpy()) & ~flipped
    assert seg_diff.mean() < 1e-4, seg_diff.mean()


def test_camera_per_env_pose_and_no_proxy_match():
    """A per-env camera pose (wrist cams) and the scene without the robot
    proxy, through `camera_march_fused`'s wrapper."""
    rng = np.random.default_rng(4)
    ja, _, ta, _ = _camera_args(2, seed=2)
    look = np.array([0.60720, 0.6214361, -0.3433028, -0.3567319]) + rng.normal(size=(2, 4)) * 0.03
    cq = (look / np.linalg.norm(look, axis=-1, keepdims=True)).astype(np.float32)
    ct = (np.array([0.73, -0.02, 0.16]) + rng.uniform(-0.03, 0.03, (2, 3))).astype(np.float32)
    j_out = j_cam.render_depth_seg(j_cam.CameraConfig(), *ja, fused=True, cam_quat=jnp.asarray(cq),
                                   cam_pos=jnp.asarray(ct))
    t_out = t_cam.render_depth_seg(t_cam.CameraConfig(), *ta, cam_quat=torch.as_tensor(cq),
                                   cam_pos=torch.as_tensor(ct))
    assert SEG_COUNTS(t_out[1])[1] == 0                  # no robot proxy given: no kuka pixel
    flipped = _assert_images(j_out[2], t_out[2], "camera per-env pose")
    assert ((np.asarray(j_out[1]) != t_out[1].numpy()) & ~flipped).mean() < 1e-4


def SEG_COUNTS(seg):
    return np.bincount(seg.numpy().ravel(), minlength=4)


def test_depth_epilogue_and_seg_noise():
    cfg = t_cam.CameraConfig()
    gen = torch.Generator().manual_seed(0)
    t_hit = torch.full((2, 54, 96), 0.3)
    hit = torch.ones_like(t_hit, dtype=torch.bool)
    hit[:, :10] = False
    dn, raw = t_cam._depth_epilogue(cfg, t_hit, hit, gen)
    assert float((raw[:, :10] - cfg.far).abs().max()) <= cfg.dis_noise + 1e-7
    assert float((raw[:, 10:] - 0.3).abs().max()) <= cfg.dis_noise + 1e-7
    assert float(raw[:, 10:].std()) > 0.3 * cfg.dis_noise          # noise was drawn
    assert float(dn.min()) >= -1.0 and float(dn.max()) <= -cfg.near / cfg.far
    seg = torch.full((4, 54, 96), 2)
    noisy = t_cam.seg_noise(seg, gen, flip_prob=0.1)
    changed = float((noisy != seg).float().mean())
    assert 0.05 < changed < 0.1                                     # 0.1 × 3/4 of the flips change the id
    assert set(noisy.unique().tolist()) <= {0, 1, 2, 3}


def test_plain_noise_statistics():
    """The plain version's noise (the kernel's is checked on the card): both
    kinds leave a residual of mean 0 and std 0.01 on lit pixels away from the clip."""
    args = [torch.as_tensor(a) for a in rk.random_tactile_inputs(6, seed=9)]
    a, kw = t_tact.render_inputs(t_tact.TactileConfig(), *args)
    clean = rk.tactile_render(*a, **kw)
    for kind in ("gauss", "ih4"):
        gen = torch.Generator().manual_seed(1)
        noisy = rk.tactile_render(*a, **kw, generator=gen, noise_std=0.01, noise_kind=kind)
        assert float(noisy.min()) >= 0.0 and float(noisy.max()) <= 1.0
        interior = (clean > 0.06) & (clean < 0.94)
        assert int(interior.sum()) > 5000
        resid = (noisy - clean)[interior]
        assert abs(float(resid.mean())) < 1e-3 and abs(float(resid.std()) - 0.01) < 5e-4, kind
    with pytest.raises(ValueError):
        rk.tactile_render(*a, **kw, generator=gen, noise_std=0.01, noise_kind="uniform")


# ------------------------------------------------ what a pixel's result uses
# The CUDA tactile kernel skips the normal, the lighting and the interior
# gradient where no lane of a warp needs them. These cases hold the fact that
# rests on, with the plain version: a pixel that missed the plug is
# glow * mask whatever its normal would have been, and a pixel off the gel
# (mask == 0) is 0 even where the ray hit.


def _tactile_rows_case(seed, inside):
    """12 rows (two per section family) with random camera rotations; the ray
    origin 2 cm below the prism's base, or inside the prism."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    r, p = 12, 384
    oh = np.eye(6, dtype=np.float32)[np.arange(r) % 6]
    hx = rng.uniform(0.008, 0.02, r).astype(np.float32)
    hy = (hx * rng.uniform(0.8, 1.2, r)).astype(np.float32)
    length = rng.uniform(0.03, 0.06, r).astype(np.float32)
    if inside:
        o = np.stack([0.2 * hx, -0.2 * hy, 0.3 * length], -1).astype(np.float32)
    else:
        o = np.stack([0.2 * hx, 0.1 * hy, np.full(r, -0.02)], -1).astype(np.float32)
    # small random tilts, so that the cone of rays around +z hits and misses
    M = Rotation.from_rotvec(rng.normal(size=(r, 3)) * 0.3).as_matrix().astype(np.float32)
    force = rng.uniform(0, 8, r).astype(np.float32)
    rays = rng.normal(size=(p, 3)) * 0.6 + np.array([0.0, 0.0, 1.0])
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(np.float32)
    mask = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), size=p)
    return [torch.as_tensor(a) for a in (M, o, oh, hx, hy, length, force, rays)], torch.as_tensor(mask)


@pytest.mark.parametrize("inside", [False, True], ids=["origin_outside", "origin_inside"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "march"])
def test_plain_tactile_missed_and_masked_pixels(inside, exact):
    from isaacgyminsertion_tpu_torch.sensors import raycast as rc

    args, mask = _tactile_rows_case(11, inside)
    M, o, oh, hx, hy, length, force, rays = args
    max_range, glow = 0.06, 0.15
    img = rk.tactile_render_plain(*args, mask_flat=mask, glow=glow, exact=exact, iters=24,
                                  max_range=max_range, max_deformation=0.01, force_range=10.0)
    assert tuple(img.shape) == (12, 384, 3)
    # the first hit, by the closed form, independent of the renderer
    d = torch.einsum("rij,pj->rpi", M, rays)
    hp, quad = rc.section_halfplanes(oh, hx, hy)
    col = lambda x: x[:, None]
    t_hit = rc.plug_hit(col(o[:, 0]), col(o[:, 1]), col(o[:, 2]), d[..., 0], d[..., 1], d[..., 2],
                        hp[:, None], quad[:, None], col(length))
    missed = t_hit > max_range + 1e-3          # clear misses only
    clear_hit = t_hit < max_range - 5e-3
    expect = (glow * mask)[None, :, None].expand_as(img)
    if inside:
        assert bool(clear_hit.all())            # from inside the prism every ray is lit
    else:
        assert int(missed.sum()) > 200 and int(clear_hit.sum()) > 200
        assert torch.equal(img[missed], expect[missed])
    lit = clear_hit & (mask[None, :] > 0)
    assert float((img[lit].max(-1).values - expect[lit][:, 0]).mean()) > 0.05     # hits are brighter
    assert not bool(img[:, mask == 0].any())                                       # off the gel: 0
