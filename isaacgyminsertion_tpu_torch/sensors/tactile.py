"""AllSight tactile gel renderer: all envs × 3 fingers in one fused ray cast.

Port of the fused path of `isaacgyminsertion_tpu/sensors/tactile.py`. A
perspective gel camera (yfov 118°) sits behind each fingertip pad and looks at
the plug; the image is a force-proportional indentation height map shaded by
three RGB lights at 120° around the optical axis, masked to the circular gel,
with optional Gaussian pixel noise. The per-pixel work runs in
`render_kernels.tactile_render` (a CUDA kernel on the card, its plain version
on the CPU); this module builds the per-(env, finger) camera frames.

The tactile image feeds the student's encoder (64×64, 1 or 3 channels).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import rotations as rot
from . import render_kernels as rk


class TactileConfig(NamedTuple):
    height: int = 64
    width: int = 64
    num_channels: int = 3          # 1 (grayscale) | 3 (RGB), encoder cfg
    yfov: float = 118.0 * math.pi / 180.0
    march_iters: int = 12
    max_range: float = 0.06        # ray length through the gel volume [m]
    max_deformation: float = 0.01
    force_range: float = 10.0      # N; force→indentation scaling
    diff: bool = True              # subtract background (task cfg tactile.diff)
    # the camera sits behind the pad surface looking along −y of the site frame
    cam_offset: float = 0.02


def _pixel_rays(cfg: TactileConfig, device=None) -> torch.Tensor:
    """Unit ray directions [H, W, 3] in the camera frame (camera looks +z)."""
    tan_half = math.tan(cfg.yfov / 2.0)
    ys = torch.linspace(-tan_half, tan_half, cfg.height, device=device)
    xs = torch.linspace(-tan_half, tan_half, cfg.width, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    d = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def gel_mask(cfg: TactileConfig, device=None) -> torch.Tensor:
    """Circular gel mask [H*W] (1 inside, 0 outside)."""
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, cfg.height, device=device),
                            torch.linspace(-1, 1, cfg.width, device=device), indexing="ij")
    return ((xx ** 2 + yy ** 2) <= 1.0).to(torch.float32).reshape(-1)


def tactile_frames(cfg: TactileConfig, tip_q, tip_t, plug_q, plug_pos):
    """Per-(env, finger) camera→plug rotations M [N·F, 3, 3] and ray origins in
    the plug frame o [N·F, 3].

    The camera sits at the pad site pushed back along the pad normal (site +y
    is the outward pad direction; the camera looks along −y toward the
    object), with axes (right, up, view) built from the site frame."""
    n, f = tip_t.shape[:2]
    site_R = rot.quat_to_matrix(tip_q)                         # [N, F, 3, 3]
    view = -site_R[..., :, 1]                                  # −y_site: toward the object
    up = site_R[..., :, 2]                                     # z_site
    right = torch.linalg.cross(view, up, dim=-1)
    cam_R = torch.stack([right, up, view], dim=-1)             # [N, F, 3, 3] columns
    cam_t = tip_t - view * cfg.cam_offset
    inv_q, inv_t = rot.tf_inverse(plug_q, plug_pos)
    o_p = inv_t[:, None, :] + rot.quat_apply(inv_q[:, None, :], cam_t)  # [N, F, 3]
    Rp = rot.quat_to_matrix(inv_q)                             # [N, 3, 3]
    M = torch.einsum("nij,nfjk->nfik", Rp, cam_R).reshape(n * f, 3, 3)
    return M.contiguous(), o_p.reshape(n * f, 3).contiguous()


def render_inputs(cfg: TactileConfig, tip_q, tip_t, plug_q, plug_pos, kind_onehot, plug_hx, plug_hy,
                  plug_length, force):
    """(args, kwargs) of `render_kernels.tactile_render` for these poses."""
    n, f = tip_t.shape[:2]
    dev = tip_t.device
    rays_flat = _pixel_rays(cfg, dev).reshape(cfg.height * cfg.width, 3)
    M, o_p = tactile_frames(cfg, tip_q, tip_t, plug_q, plug_pos)
    rep = lambda x: torch.repeat_interleave(x, f, dim=0)
    args = (M, o_p, rep(kind_onehot), rep(plug_hx), rep(plug_hy), rep(plug_length),
            force.reshape(n * f).contiguous(), rays_flat)
    kw = dict(iters=cfg.march_iters, max_range=cfg.max_range, max_deformation=cfg.max_deformation,
              force_range=cfg.force_range, mask_flat=gel_mask(cfg, dev),
              glow=0.0 if cfg.diff else 0.15)
    return args, kw


def render_tactile(
    cfg: TactileConfig,
    tip_q: torch.Tensor,        # [N, F, 4] fingertip site orientations (world)
    tip_t: torch.Tensor,        # [N, F, 3] fingertip site positions (world)
    plug_q: torch.Tensor,       # [N, 4]
    plug_pos: torch.Tensor,     # [N, 3]
    kind_onehot: torch.Tensor,  # [N, K]
    plug_hx: torch.Tensor,      # [N]
    plug_hy: torch.Tensor,
    plug_length: torch.Tensor,
    force: torch.Tensor,        # [N, F] smoothed contact force magnitude
    generator: torch.Generator | None = None,
    noise_std: float = 0.0,
    method: str = "exact",
    noise_kind: str = "gauss",
) -> torch.Tensor:
    """Render [N, F, H, W, C] tactile images.

    `method="exact"` takes the closed-form ray-prism hit, `method="march"` the
    12-trip SDF sphere march; both run in the fused renderer. Noise is drawn
    when `generator` is given and `noise_std > 0`."""
    n, f = tip_t.shape[:2]
    args, kw = render_inputs(cfg, tip_q, tip_t, plug_q, plug_pos, kind_onehot, plug_hx, plug_hy,
                             plug_length, force)
    img = rk.tactile_render(*args, **kw, exact=(method == "exact"), generator=generator,
                            noise_std=noise_std, noise_kind=noise_kind)
    img = img.reshape(n, f, cfg.height, cfg.width, 3)
    if cfg.num_channels == 1:
        img = torch.mean(img, dim=-1, keepdim=True)
    return img
