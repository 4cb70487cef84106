"""Point clouds and the contact ground truth, port vs JAX reference.

Deterministic parts (back-projection, workspace crop, the contact vector
before its random dropout) are held to 1e-5 on the same numpy inputs. The
random parts (masked sampling, augmentation) draw from different generators
in the two packages, so they are held by their properties and statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isaacgyminsertion_tpu.sensors import camera as j_cam
from isaacgyminsertion_tpu.sensors import contact_gt as j_cgt
from isaacgyminsertion_tpu.sensors import pcl as j_pcl
from isaacgyminsertion_tpu_torch import assets as t_assets
from isaacgyminsertion_tpu_torch.sensors import camera as t_cam
from isaacgyminsertion_tpu_torch.sensors import contact_gt as t_cgt
from isaacgyminsertion_tpu_torch.sensors import pcl as t_pcl

torch.set_num_threads(1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_backprojection_and_crop_match():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.1, 0.5, (3, 54, 96)).astype(np.float32)
    j_pts = j_pcl.backproject(j_cam.CameraConfig(), jnp.asarray(depth))
    t_pts = t_pcl.backproject(t_cam.CameraConfig(), torch.as_tensor(depth))
    assert tuple(t_pts.shape) == (3, 54, 96, 3)
    np.testing.assert_allclose(t_pts.numpy(), np.asarray(j_pts), rtol=1e-5, atol=1e-5)
    j_in, t_in = j_pcl.workspace_crop(j_pts), t_pcl.workspace_crop(t_pts)
    assert 0.05 < np.asarray(j_in).mean() < 0.95
    # a point within 1e-5 of a face of the box may fall on either side
    assert (np.asarray(j_in) != t_in.numpy()).mean() < 1e-4


def test_masked_downsample_samples_valid_points_uniformly():
    rng = np.random.default_rng(1)
    n, p, k = 4, 600, 100
    pts = torch.as_tensor(rng.normal(size=(n, p, 3)).astype(np.float32))
    valid = torch.zeros((n, p), dtype=torch.bool)
    valid[0, :300] = True            # more valid points than k
    valid[1, 50:90] = True           # 40 < k: resampled with replacement
    valid[2, 7] = True               # a single valid point
    out = t_pcl.masked_downsample(pts, valid, k, _gen(0))           # row 3: none valid
    assert tuple(out.shape) == (n, k, 3)

    def rows_of(row, env):
        """Index in `pts[env]` of each sampled point (every point must be one)."""
        d = (pts[env][None, :, :] - row[:, None, :]).abs().sum(-1)
        assert float(d.min(dim=1).values.max()) == 0.0
        return d.argmin(dim=1)

    i0 = rows_of(out[0], 0)
    assert bool(valid[0][i0].all()) and len(set(i0.tolist())) == k  # valid, without replacement
    i1 = rows_of(out[1], 1)
    assert bool(valid[1][i1].all())
    assert set(i1.tolist()) == set(range(50, 90))                   # every valid point is kept …
    assert len(set(i1.tolist())) == 40 < k                          # … and the rest are repeats
    assert bool((rows_of(out[2], 2) == 7).all())
    assert float(out[3].abs().max()) == 0.0                         # nothing valid: the fill value
    # uniform over the valid set: the mean index of many draws sits mid-range
    draws = torch.cat([rows_of(t_pcl.masked_downsample(pts, valid, k, _gen(s))[0], 0) for s in range(20)])
    assert abs(float(draws.float().mean()) - 149.5) < 10.0


def test_augment_off_is_identity_and_on_has_the_reference_statistics():
    rng = np.random.default_rng(2)
    n, p = 64, 800
    pts = rng.uniform(-0.1, 0.1, (n, p, 3)).astype(np.float32)
    cfg_t, cfg_j = t_pcl.PclAugmentConfig(), j_pcl.PclAugmentConfig()
    off = t_pcl.augment_pcl(torch.as_tensor(pts), _gen(0), cfg_t, torch.zeros(n, dtype=torch.bool))
    np.testing.assert_array_equal(off.numpy(), pts)
    enable = np.arange(n) % 2 == 0
    t_out = t_pcl.augment_pcl(torch.as_tensor(pts), _gen(1), cfg_t, torch.as_tensor(enable)).numpy()
    j_out = np.asarray(j_pcl.augment_pcl(jnp.asarray(pts), jax.random.PRNGKey(1), cfg_j,
                                         jnp.asarray(enable)))
    np.testing.assert_array_equal(t_out[~enable], pts[~enable])
    for out in (t_out, j_out):
        d = (out - pts)[enable]
        assert np.abs(d).max() <= 2 * cfg_t.jitter_clip + 1e-6       # jitter + per-env offset, both clipped
        # remove the per-env constant offset (the median over points, since 70 % carry no jitter)
        const = np.median(d, axis=1, keepdims=True)
        jit = d - const
        moved = np.abs(jit) > 1e-7
        assert abs(moved.mean() - cfg_t.jitter_frac) < 0.02, moved.mean()
    stat = lambda out: np.std((out - pts)[enable])
    assert abs(stat(t_out) - stat(j_out)) < 0.1 * stat(j_out)
    # the other knobs run and keep the shape
    knobs = t_pcl.PclAugmentConfig(rotate_deg=30.0, scale_range=(0.9, 1.1), outlier_frac=0.05,
                                   dropout_frac=0.1)
    out = t_pcl.augment_pcl(torch.as_tensor(pts), _gen(2), knobs, torch.ones(n, dtype=torch.bool))
    assert tuple(out.shape) == (n, p, 3) and bool(torch.isfinite(out).all())


def test_assemble_scene_pcl_orders_plug_then_socket():
    rng = np.random.default_rng(3)
    n = 3
    cfg = t_cam.CameraConfig()
    depth = torch.full((n, 54, 96), 0.2)        # every pixel lands inside the workspace box
    seg = torch.zeros((n, 54, 96), dtype=torch.long)
    seg[:, 10:20, 30:50] = t_cam.SEG_PLUG
    seg[:, 30:45, 20:70] = t_cam.SEG_SOCKET
    seg[2] = 0                                            # env 2 sees neither
    goal = torch.as_tensor(rng.normal(size=(n, 50, 3)).astype(np.float32))
    cloud = t_pcl.assemble_scene_pcl(cfg, depth, seg, goal, _gen(0), num_plug=40, num_socket=60,
                                     num_goal=20, merge_goal=True)
    assert tuple(cloud.shape) == (n, 120, 3)
    pts = t_pcl.backproject(cfg, depth)
    in_ws = t_pcl.workspace_crop(pts)
    for env in (0, 1):
        for sl, seg_id in ((slice(0, 40), t_cam.SEG_PLUG), (slice(40, 100), t_cam.SEG_SOCKET)):
            cand = pts[env][(seg[env] == seg_id) & in_ws[env]]
            assert cand.shape[0] > 0
            d = (cand[None] - cloud[env, sl][:, None]).abs().sum(-1).min(dim=1).values
            assert float(d.max()) == 0.0                  # every point is a back-projected pixel of its part
    assert float(cloud[2, :100].abs().max()) == 0.0       # nothing segmented: the fill value
    d = (goal[0][None] - cloud[0, 100:][:, None]).abs().sum(-1).min(dim=1).values
    assert float(d.max()) == 0.0                          # the goal slice draws from the goal points


def test_extrinsic_contact_matches_before_the_dropout():
    rng = np.random.default_rng(4)
    n = 6
    subs = t_assets.build_subassembly_set()
    sub_idx = rng.integers(0, len(subs.names), n)
    dense = subs.dense_points[sub_idx]
    oh = subs.kind_onehot[sub_idx].astype(np.float32)
    hole_hx, hole_hy = subs.hole_hx[sub_idx], subs.hole_hy[sub_idx]
    height = subs.socket_height[sub_idx]
    unit = lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True)
    plug_q = unit(rng.normal(size=(n, 4)) * np.array([0.02, 0.02, 0.05, 1.0])).astype(np.float32)
    sock_pos = np.array([0.5, 0.0, 0.01], np.float32) + np.zeros((n, 3), np.float32)
    sock_q = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    # plugs part-way into their holes, pushed sideways against a wall
    plug_pos = sock_pos + np.stack([rng.uniform(-1, 1, n) * 0.0008, rng.uniform(-1, 1, n) * 0.0008,
                                    height * rng.uniform(0.2, 0.8, n)], -1).astype(np.float32)
    args = (dense, plug_q, plug_pos, sock_q, sock_pos, oh, hole_hx, hole_hy, height)
    t_d = t_cgt.extrinsic_contact(*[torch.as_tensor(np.asarray(a, np.float32)) for a in args], None)
    assert tuple(t_d.shape) == dense.shape[:2]
    assert 0.01 < float((t_d > 0).float().mean()) < 0.99       # some points in contact, not all
    j_d = np.asarray(j_cgt.extrinsic_contact(*[jnp.asarray(np.asarray(a, np.float32)) for a in args],
                                             jax.random.PRNGKey(0)))
    t_np = t_d.numpy()
    dropped = (j_d == 0.0) & (t_np == 1.0)                      # the reference's random dropout
    assert dropped.sum() <= 0.1 * max((t_np == 1.0).sum(), 1) + 1
    diff = np.abs(j_d - t_np)[~dropped]
    # d jumps from ≤ 0.1 to 1 at dist = 0.9·threshold: a point within rounding of it may flip
    assert (diff > 1e-3).mean() < 2e-3 and np.median(diff) < 1e-5
    with_drop = t_cgt.extrinsic_contact(*[torch.as_tensor(np.asarray(a, np.float32)) for a in args],
                                        _gen(0))
    assert bool(((with_drop == t_d) | ((t_d == 1.0) & (with_drop == 0.0))).all())
