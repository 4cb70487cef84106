"""External depth + segmentation camera: one fused ray cast over [N, H, W] pixels.

A snapshot of the port's module, itself the port of the fused path of `isaacgyminsertion_tpu/sensors/camera.py`. The
per-pixel work (first hit among plug, socket, table and the robot proxy) runs
in `render_kernels.camera_render` (a CUDA kernel on the card, its plain
version on the CPU); this module builds the camera→plug and camera→socket
frames and turns the kernel's planes into:

  depth [N, H, W]  noise, clip to [near, far], normalize by −far
  seg   [N, H, W]  segmentation ids (table 0, kuka 1, plug 2, socket 3)

Default intrinsics and pose are the real-calibrated external camera (96×54,
near 0.1, far 0.5, dis_noise 0.001).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..assets import SOCKET_PLATE_HX, SOCKET_PLATE_HY
from ..ops import rotations as rot
from . import render_kernels as rk

SEG_TABLE, SEG_KUKA, SEG_PLUG, SEG_SOCKET = 0, 1, 2, 3


class CameraConfig(NamedTuple):
    height: int = 54
    width: int = 96
    yfov: float = 0.75            # ~43° vertical
    near: float = 0.1             # near_clip
    far: float = 0.5              # far_clip
    dis_noise: float = 0.001
    march_iters: int = 24
    # real-calibrated pose
    cam_pos: tuple = (0.73114316, -0.01966786, 0.1629284)
    cam_quat: tuple = (0.60720, 0.6214361, -0.3433028, -0.3567319)


def _pixel_rays(cfg: CameraConfig, device=None) -> torch.Tensor:
    """Unit ray directions [H, W, 3]; the optical axis is +z of the camera frame."""
    tan_half = math.tan(cfg.yfov / 2.0)
    aspect = cfg.width / cfg.height
    ys = torch.linspace(tan_half, -tan_half, cfg.height, device=device)
    xs = torch.linspace(-tan_half * aspect, tan_half * aspect, cfg.width, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    d = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def render_inputs(cfg: CameraConfig, plug_q, plug_pos, socket_q, socket_pos, kind_onehot, plug_hx,
                  plug_hy, plug_length, hole_hx, hole_hy, socket_height, table_height, cam_quat=None,
                  cam_pos=None, tip_pos=None, wrist_pos=None, hand_pos=None, tip_radius: float = 0.018,
                  hand_radius: float = 0.045):
    """(args, kwargs) of `render_kernels.camera_render` for these poses: the
    camera→plug and camera→socket frames, and the robot proxy in the camera frame."""
    n = plug_pos.shape[0]
    dev, dt = plug_pos.device, plug_pos.dtype
    rays_flat = _pixel_rays(cfg, dev).reshape(cfg.height * cfg.width, 3)
    if cam_quat is None:
        cam_q = torch.as_tensor(cfg.cam_quat, dtype=dt, device=dev)
        cam_t = torch.as_tensor(cfg.cam_pos, dtype=dt, device=dev)
    else:
        cam_q, cam_t = cam_quat, cam_pos
    cam_tv = cam_t.expand(n, 3)
    inv_pq, inv_pt = rot.tf_inverse(plug_q, plug_pos)
    inv_sq, inv_st = rot.tf_inverse(socket_q, socket_pos)
    o_plug = inv_pt + rot.quat_apply(inv_pq, cam_tv)            # [N, 3]
    o_sock = inv_st + rot.quat_apply(inv_sq, cam_tv)
    cam_R = rot.quat_to_matrix(cam_q).expand(n, 3, 3)
    M_plug = torch.einsum("nij,njk->nik", rot.quat_to_matrix(inv_pq), cam_R)
    M_sock = torch.einsum("nij,njk->nik", rot.quat_to_matrix(inv_sq), cam_R)
    tips_cam = wrist_cam = hand_cam = None
    if tip_pos is not None:
        # world → camera frame: c = Rᵀ(x − t); the ray origin is 0 there
        tips_cam = torch.einsum("nji,nfj->nfi", cam_R, tip_pos - cam_tv[:, None]).contiguous()
        wrist_cam = torch.einsum("nji,nj->ni", cam_R, wrist_pos - cam_tv).contiguous()
        hand_cam = torch.einsum("nji,nj->ni", cam_R, hand_pos - cam_tv).contiguous()
    args = (M_plug.contiguous(), o_plug.contiguous(), M_sock.contiguous(), o_sock.contiguous(),
            cam_R[:, 2, :].contiguous(), cam_tv[:, 2].contiguous(), kind_onehot, plug_hx, plug_hy,
            plug_length, hole_hx, hole_hy, socket_height, table_height, rays_flat)
    kw = dict(iters=cfg.march_iters, near=cfg.near, far=cfg.far, plate_hx=float(SOCKET_PLATE_HX),
              plate_hy=float(SOCKET_PLATE_HY), tips_cam=tips_cam, wrist_cam=wrist_cam,
              hand_cam=hand_cam, tip_radius=tip_radius, hand_radius=hand_radius)
    return args, kw


def render_depth_seg(
    cfg: CameraConfig,
    plug_q: torch.Tensor,       # [N, 4]
    plug_pos: torch.Tensor,     # [N, 3]
    socket_q: torch.Tensor,
    socket_pos: torch.Tensor,
    kind_onehot: torch.Tensor,
    plug_hx: torch.Tensor,
    plug_hy: torch.Tensor,
    plug_length: torch.Tensor,
    hole_hx: torch.Tensor,
    hole_hy: torch.Tensor,
    socket_height: torch.Tensor,
    table_height: torch.Tensor,
    generator: torch.Generator | None = None,
    method: str = "exact",                  # "exact" | "march" (SDF sphere march)
    **pose_kw,
):
    """Returns (depth_normalized [N,H,W], seg [N,H,W] int64, depth_raw).

    Keywords of `render_inputs`: with `cam_quat` [N, 4] / `cam_pos` [N, 3] the
    camera rides a per-env pose (by default the static calibrated pose); with
    `tip_pos` [N, 3, 3] / `wrist_pos` / `hand_pos` [N, 3] (world) the robot hand
    is rendered as a proxy (3 fingertip spheres of `tip_radius` + a wrist→hand
    capsule of `hand_radius`) with seg id 1. Depth noise is drawn when
    `generator` is given."""
    n = plug_pos.shape[0]
    args, kw = render_inputs(cfg, plug_q, plug_pos, socket_q, socket_pos, kind_onehot, plug_hx,
                             plug_hy, plug_length, hole_hx, hole_hy, socket_height, table_height,
                             **pose_kw)
    t_hit, dmin, comp = rk.camera_render(*args, **kw, exact=(method == "exact"))
    shape = (n, cfg.height, cfg.width)
    t_hit, dmin, comp = t_hit.reshape(shape), dmin.reshape(shape), comp.reshape(shape)
    # hit test and component → seg id as the reference's fused path has them
    hit = (dmin < 2e-3) & (t_hit < cfg.far - 1e-4)
    seg = torch.zeros(shape, dtype=torch.long, device=plug_pos.device)          # SEG_TABLE
    seg = torch.where(hit & (comp == 1.0), SEG_PLUG, seg)
    seg = torch.where(hit & (comp == 2.0), SEG_SOCKET, seg)
    seg = torch.where(hit & (comp == 3.0), SEG_KUKA, seg)
    depth_norm, depth_raw = _depth_epilogue(cfg, t_hit, hit, generator)
    return depth_norm, seg, depth_raw


def _depth_epilogue(cfg: CameraConfig, t_hit, hit, generator):
    """Depth noise, clip and normalization."""
    depth_raw = torch.where(hit, t_hit, torch.full_like(t_hit, cfg.far))
    if generator is not None and cfg.dis_noise > 0.0:
        depth_raw = depth_raw + cfg.dis_noise * 2.0 * (
            torch.rand(depth_raw.shape, generator=generator, device=depth_raw.device) - 0.5)
    depth_clipped = torch.clamp(depth_raw, cfg.near, cfg.far)
    return depth_clipped / -cfg.far, depth_raw


def seg_noise(seg: torch.Tensor, generator: torch.Generator, flip_prob: float = 0.1) -> torch.Tensor:
    """Random pixel-flip segmentation noise."""
    flip = torch.rand(seg.shape, generator=generator, device=seg.device) < flip_prob
    rand_ids = torch.randint(0, 4, seg.shape, generator=generator, device=seg.device)
    return torch.where(flip, rand_ids, seg)
