"""Point-cloud generation + augmentation (PyTorch, fixed shapes).

Port of `isaacgyminsertion_tpu/sensors/pcl.py`: pinhole back-projection of the
external camera's depth, fixed-size masked sampling, the workspace crop, the
jitter augmentation and the assembly of the merged cloud.

Fixed-size masked sampling: every pixel is scored with (mask + uniform noise)
and the top-k are taken, a uniform random selection among valid pixels with a
fixed [N, K] output. When fewer than k pixels are valid, the valid set is
resampled with replacement.

Assembly contract: the merged cloud is ordered [plug pts | socket pts | goal
pts | scene pts]; the student slices it positionally.

Internals run on [N, P] x/y/z coordinate planes as in the reference, so the
two packages compare plane by plane; [N, K, 3] clouds are assembled only at
the outputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import rotations as rot
from .camera import SEG_PLUG, SEG_SOCKET, CameraConfig, _pixel_rays


def _backproject_planes(cfg: CameraConfig, depth_raw: torch.Tensor):
    """World-frame (x, y, z) planes [N, H*W] from ray depth."""
    n = depth_raw.shape[0]
    dev, dt = depth_raw.device, depth_raw.dtype
    d = depth_raw.reshape(n, -1)
    rays_c = _pixel_rays(cfg, dev).reshape(-1, 3)
    cam_q = torch.as_tensor(cfg.cam_quat, dtype=dt, device=dev)
    cam_t = torch.as_tensor(cfg.cam_pos, dtype=dt, device=dev)
    rays_w = rot.quat_apply(cam_q.expand(rays_c.shape[0], 4), rays_c)   # [HW, 3]
    x = cam_t[0] + rays_w[:, 0] * d
    y = cam_t[1] + rays_w[:, 1] * d
    z = cam_t[2] + rays_w[:, 2] * d
    return x, y, z


def backproject(cfg: CameraConfig, depth_raw: torch.Tensor) -> torch.Tensor:
    """World-frame points [N, H, W, 3] from ray depth."""
    x, y, z = _backproject_planes(cfg, depth_raw)
    return torch.stack([x, y, z], dim=-1).reshape(depth_raw.shape + (3,))


def _downsample_planes(x, y, z, valid, k: int, generator, fill_value: float = 0.0):
    """Uniformly sample k of the valid columns → [N, k, 3] (fixed shape)."""
    dev = x.device
    score = valid.to(x.dtype) + torch.rand(valid.shape, generator=generator, device=dev)
    _, idx = torch.topk(score, k, dim=1)                       # [N, k]
    ok = torch.gather(valid, 1, idx)
    # fewer than k valid pixels: resample the valid set WITH replacement
    # instead of zero-filling (zero-fill plants a fake cluster at the origin
    # whenever the plug is small or occluded). top-k puts the c valid columns
    # first, so a with-replacement draw over [0, c) re-indexes into them.
    c = torch.sum(valid, dim=1, keepdim=True)                   # [N, 1]
    u = torch.rand(idx.shape, generator=generator, device=dev)
    # (where c ≥ k every slot is already valid and j is not used: keep it in range)
    j = torch.minimum((u * torch.clamp_min(c, 1)).long(), torch.clamp(c, 1, k) - 1)
    idx = torch.where(ok, idx, torch.gather(idx, 1, j))
    ok = torch.gather(valid, 1, idx)                           # False only when c == 0
    take = lambda p: torch.gather(p, 1, idx)
    pts = torch.stack([take(x), take(y), take(z)], dim=-1)
    return torch.where(ok[..., None], pts, torch.full_like(pts, fill_value))


def masked_downsample(points: torch.Tensor, valid: torch.Tensor, k: int,
                      generator: torch.Generator, fill_value: float = 0.0) -> torch.Tensor:
    """Uniformly sample k points [N, k, 3] from the valid set of points
    [N, P, 3] (valid [N, P] bool)."""
    return _downsample_planes(points[..., 0], points[..., 1], points[..., 2], valid, k, generator,
                              fill_value)


WS_LO = (0.3, -0.25, -0.01)
WS_HI = (0.8, 0.25, 0.4)


def _crop_planes(x, y, z, lo=WS_LO, hi=WS_HI):
    return ((x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
            & (z >= lo[2]) & (z <= hi[2]))


def workspace_crop(points: torch.Tensor, lo=WS_LO, hi=WS_HI) -> torch.Tensor:
    """Validity mask for the workspace box."""
    return _crop_planes(points[..., 0], points[..., 1], points[..., 2], lo, hi)


class PclAugmentConfig(NamedTuple):
    """Point-cloud augmentations. The defaults are what the upstream student
    actually sees: a ±1 mm clipped Gaussian jitter on ~30% of the points plus
    a per-env constant offset; rotate / scale / outliers / dropout are kept as
    knobs for robustness studies and are off."""

    jitter_std: float = 0.001
    jitter_clip: float = 0.001
    jitter_frac: float = 0.3
    rotate_deg: float = 0.0
    scale_range: tuple = (1.0, 1.0)
    outlier_frac: float = 0.0
    dropout_frac: float = 0.0


def augment_pcl(points: torch.Tensor, generator: torch.Generator, cfg: PclAugmentConfig,
                enable: torch.Tensor) -> torch.Tensor:
    """Random jitter/rotate/scale/outliers/dropout; `enable` [N] gates per env."""
    n = points.shape[0]
    dev = points.device
    rand = lambda shape: torch.rand(shape, generator=generator, device=dev)
    randn = lambda shape: torch.randn(shape, generator=generator, device=dev)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    # jitter: clipped Gaussian on a random ~30% subset of points + a clipped
    # per-env constant offset
    jit = lambda p: torch.clamp(cfg.jitter_std * randn(p.shape), -cfg.jitter_clip, cfg.jitter_clip)
    jx, jy, jz = jit(x), jit(y), jit(z)
    jmask = (rand(x.shape) < cfg.jitter_frac).to(x.dtype)
    const = torch.clamp(cfg.jitter_std * randn((n, 1, 3)), -cfg.jitter_clip, cfg.jitter_clip)
    x = x + jx * jmask + const[..., 0]
    y = y + jy * jmask + const[..., 1]
    z = z + jz * jmask + const[..., 2]
    if cfg.rotate_deg > 0.0:
        # rotate about z by ±rotate_deg around the centroid
        ang = math.radians(cfg.rotate_deg) * 2.0 * (rand((n, 1)) - 0.5)
        c, s = torch.cos(ang), torch.sin(ang)
        cx = torch.mean(x, dim=1, keepdim=True)
        cy = torch.mean(y, dim=1, keepdim=True)
        rx, ry = x - cx, y - cy
        rx, ry = c * rx - s * ry, s * rx + c * ry
        x, y = cx + rx, cy + ry
    if tuple(cfg.scale_range) != (1.0, 1.0):
        sc = cfg.scale_range[0] + rand((n, 1)) * (cfg.scale_range[1] - cfg.scale_range[0])
        cx = torch.mean(x, dim=1, keepdim=True)
        cy = torch.mean(y, dim=1, keepdim=True)
        cz = torch.mean(z, dim=1, keepdim=True)
        x = cx + (x - cx) * sc
        y = cy + (y - cy) * sc
        z = cz + (z - cz) * sc
    if cfg.outlier_frac > 0.0:
        # outliers: replace a fraction with uniform noise in the local bbox
        out_mask = rand(x.shape) < cfg.outlier_frac
        lo = lambda p: torch.min(p, dim=1, keepdim=True).values
        hi = lambda p: torch.max(p, dim=1, keepdim=True).values
        bb = lambda p: lo(p) + rand(p.shape) * (hi(p) - lo(p))
        x = torch.where(out_mask, bb(x), x)
        y = torch.where(out_mask, bb(y), y)
        z = torch.where(out_mask, bb(z), z)
    if cfg.dropout_frac > 0.0:
        # dropout: duplicate the first point over a random fraction
        rd = rand(x.shape) < cfg.dropout_frac
        x = torch.where(rd, x[:, :1], x)
        y = torch.where(rd, y[:, :1], y)
        z = torch.where(rd, z[:, :1], z)
    out = torch.stack([x, y, z], dim=-1)
    return torch.where(enable[:, None, None], out, points)


def assemble_scene_pcl(
    cfg: CameraConfig,
    depth_raw: torch.Tensor,     # [N, H, W]
    seg: torch.Tensor,           # [N, H, W] int
    goal_pts: torch.Tensor,      # [N, G, 3] plug dense points at the socket pose
    generator: torch.Generator,
    num_plug: int = 400,
    num_socket: int = 400,
    num_goal: int = 400,
    num_scene: int = 0,
    include_plug: bool = True,
    merge_socket: bool = True,
    merge_goal: bool = False,
    include_all: bool = False,
) -> torch.Tensor:
    """Merged cloud in the hard order [plug | socket | goal | scene]."""
    n = depth_raw.shape[0]
    x, y, z = _backproject_planes(cfg, depth_raw)
    segf = seg.reshape(n, -1)
    in_ws = _crop_planes(x, y, z)
    parts = []
    if include_plug:
        parts.append(_downsample_planes(x, y, z, in_ws & (segf == SEG_PLUG), num_plug, generator))
    if merge_socket:
        parts.append(_downsample_planes(x, y, z, in_ws & (segf == SEG_SOCKET), num_socket, generator))
    if merge_goal:
        gidx = torch.randint(0, goal_pts.shape[1], (n, num_goal), generator=generator,
                             device=depth_raw.device)
        parts.append(torch.gather(goal_pts, 1, gidx[..., None].expand(n, num_goal, 3)))
    if include_all or num_scene > 0:
        parts.append(_downsample_planes(x, y, z, in_ws, max(num_scene, 1), generator))
    return torch.cat(parts, dim=1)
