"""Contact generation of one substep: the hand-written CUDA kernel and its plain version.

`generate_contacts` builds the substep's ContactSet [N, C = 255]: the three
fingertip gel pads' 5-point patches against the plug SDF (slots 0-14,
finger-major), the plug's socket points against the socket SDF, and its
table points against the table halfspace. CUDA tensors go to the kernel in
`csrc/contact_gen.cu`, one launch with one thread per (env, slot) and the SDF
normals in closed form; CPU tensors go to `generate_contacts_plain`
(`contact.fingertip_plug_contacts` + `contact.plug_env_contacts` +
`contact.concat_contacts`, with the normals by autograd). There is no
fallback: a CUDA input the kernel does not take raises.

The kernel replaces no TPU kernel: the JAX package leaves this chain to XLA,
which fuses it. It is built with nvcc for sm_90a at first use and bound with
ctypes through a plain C entry point (`utils/cuda_build.py`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..assets import SOCKET_PLATE_HX, SOCKET_PLATE_HY, SOCKET_PT_COUNT, TABLE_PT_IDX
from ..ops import const
from ..ops.sdf import NUM_KINDS
from ..utils import profiling
from ..utils.cuda_build import CudaKernel
from .contact import (
    FINGERTIP_RADIUS,
    GEL_STIFFNESS,
    PATCH_POINTS,
    PATCH_RING_FRAC,
    MaterialParams,
    concat_contacts,
    fingertip_plug_contacts,
    plug_env_contacts,
)
from .solver import ContactSet

KERNEL_NAME = "contact_gen"
FINGERS = 3
FINGER_SLOTS = FINGERS * PATCH_POINTS

# f32 operations per contact slot, counted from csrc/contact_gen.cu (an add,
# a multiply, a division, a sqrt, an abs, a min/max and a select count as one
# each; a tie-rule factor (gmax/gmin) as 2 and a sign as 3), by section kind
# (circle, box, hexagon, ellipse, trapezoid, triangle): a fingertip patch slot
# (the mean over a pad's centre, one plug SDF evaluation with its gradient,
# and its four ring points, two evaluations and the tangent basis each) and a
# socket slot (the plate, the hole and the frame changes); a table slot does
# the same for every kind. The rows of `kind_onehot` are one-hot.
FLOPS_FINGER_SLOT = (277, 349, 391, 346, 434, 605)
FLOPS_SOCKET_SLOT = (264, 304, 327, 302, 351, 446)
FLOPS_TABLE_SLOT = 68


def flops(kind_onehot: torch.Tensor, ps: int = SOCKET_PT_COUNT, pt: int = len(TABLE_PT_IDX)) -> int:
    """f32 operations of one launch over the envs whose one-hot kinds are
    `kind_onehot` [N, 6] (a family of weight 0 is not evaluated)."""
    per_kind = (kind_onehot != 0).sum(dim=0).tolist()
    return sum(k * (FINGER_SLOTS * f + ps * s) for k, f, s in zip(per_kind, FLOPS_FINGER_SLOT, FLOPS_SOCKET_SLOT)) \
        + kind_onehot.shape[0] * pt * FLOPS_TABLE_SLOT


def bytes_moved(n: int, per_env: int, ps: int = SOCKET_PT_COUNT, pt: int = len(TABLE_PT_IDX)) -> int:
    """Bytes one launch must move: the socket and table points (3 floats) and
    weights read once, `per_env` floats of per-env inputs, and the 13 floats of
    each of the FINGER_SLOTS + ps + pt contact slots written once."""
    c = FINGER_SLOTS + ps + pt
    return 4 * n * ((ps + pt) * 4 + per_env + 13 * c)


def per_env_floats(args) -> int:
    """Floats a launch reads per env from `generate_contacts`' arguments
    `args`, besides the surface points and weights: the per-env tensors, and
    each friction coefficient given per env."""
    *per_env, _points, _weights, mat = args
    n = per_env[2].shape[0]
    return sum(t.numel() // n for t in (*per_env, *mat))


# --------------------------------------------------------------------------- build

KERNEL = CudaKernel(
    KERNEL_NAME, "contact_gen.cu", "contact_gen_launch",
    [ctypes.c_void_p] * 28 + [ctypes.c_int] * 7 + [ctypes.c_float] * 6 + [ctypes.c_void_p],
    extra_flags=["--fmad=false"])
BUILD_INFO = KERNEL.info
build = KERNEL.build

_RING_RADIUS = FINGERTIP_RADIUS * float(np.sqrt(1.0 - PATCH_RING_FRAC ** 2))


# ------------------------------------------------------------------------ versions


def generate_contacts_plain(tip_pos, tip_vel, plug_q, plug_pos, plug_com_w, socket_q, socket_pos, kind_onehot,
                            plug_hx, plug_hy, plug_length, hole_hx, hole_hy, socket_height, table_height,
                            surface_points, surface_weights, mat: MaterialParams) -> ContactSet:
    """Plain PyTorch version (runs on any device): the fingertip patches, then
    the socket and table points, concatenated in the kernel's slot order."""
    cs_fing, _aux = fingertip_plug_contacts(tip_pos, tip_vel, plug_q, plug_pos, plug_com_w, kind_onehot,
                                            plug_hx, plug_hy, plug_length, mat)
    tbl_idx = const(TABLE_PT_IDX, surface_points.device, torch.long)
    cs_env = plug_env_contacts(
        surface_points[:, :SOCKET_PT_COUNT], surface_weights[:, :SOCKET_PT_COUNT],
        surface_points[:, tbl_idx], surface_weights[:, tbl_idx], plug_q, plug_pos, plug_com_w, socket_q,
        socket_pos, kind_onehot, hole_hx, hole_hy, socket_height, table_height, mat)
    return concat_contacts(cs_fing, cs_env)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _mu_stride(name, t, n, device) -> int:
    """0 for one coefficient shared by every env ([] or [1]), 1 for one per env ([N])."""
    _check(name, t, tuple(t.shape) if t.dim() <= 1 and t.numel() == 1 else (n,), device)
    return 0 if t.numel() == 1 else 1


def generate_contacts_cuda(tip_pos, tip_vel, plug_q, plug_pos, plug_com_w, socket_q, socket_pos, kind_onehot,
                           plug_hx, plug_hy, plug_length, hole_hx, hole_hy, socket_height, table_height,
                           surface_points, surface_weights, mat: MaterialParams) -> ContactSet:
    """Launch the CUDA kernel on PyTorch's current stream (counted in
    `profiling`'s `kernels.contact_gen`)."""
    dev = plug_q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA contact generation needs CUDA tensors, got {dev}")
    n = plug_q.shape[0]
    if surface_points.dim() != 3:
        raise ValueError(f"surface_points has shape {tuple(surface_points.shape)}, expected (N, P, 3)")
    p = surface_points.shape[1]
    ps, pt = SOCKET_PT_COUNT, len(TABLE_PT_IDX)
    if p < max(ps, int(TABLE_PT_IDX.max()) + 1):
        raise ValueError(f"surface_points has {p} points a plug, fewer than the contact sets index")
    for name, t, shape in [("tip_pos", tip_pos, (n, FINGERS, 3)), ("tip_vel", tip_vel, (n, FINGERS, 3)),
                           ("plug_q", plug_q, (n, 4)), ("plug_pos", plug_pos, (n, 3)),
                           ("plug_com_w", plug_com_w, (n, 3)), ("socket_q", socket_q, (n, 4)),
                           ("socket_pos", socket_pos, (n, 3)), ("kind_onehot", kind_onehot, (n, NUM_KINDS)),
                           ("plug_hx", plug_hx, (n,)), ("plug_hy", plug_hy, (n,)),
                           ("plug_length", plug_length, (n,)), ("hole_hx", hole_hx, (n,)),
                           ("hole_hy", hole_hy, (n,)), ("socket_height", socket_height, (n,)),
                           ("table_height", table_height, (n,)), ("surface_points", surface_points, (n, p, 3)),
                           ("surface_weights", surface_weights, (n, p))]:
        _check(name, t, shape, dev)
    strides = [_mu_stride(f"mat.{k}", getattr(mat, k), n, dev) for k in ("mu_socket", "mu_table", "mu_finger")]
    c = FINGER_SLOTS + ps + pt
    r, nrm, v_other = (torch.empty((n, c, 3), dtype=torch.float32, device=dev) for _ in range(3))
    depth, mu, weight, stiffness = (torch.empty((n, c), dtype=torch.float32, device=dev) for _ in range(4))
    tbl_idx = const(TABLE_PT_IDX, dev, torch.int32)
    ptrs = [t.data_ptr() for t in (tip_pos, tip_vel, plug_q, plug_pos, plug_com_w, socket_q, socket_pos,
                                   kind_onehot, plug_hx, plug_hy, plug_length, hole_hx, hole_hy, socket_height,
                                   table_height, mat.mu_socket, mat.mu_table, mat.mu_finger, surface_points,
                                   surface_weights, tbl_idx, r, nrm, depth, v_other, mu, weight, stiffness)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = KERNEL.fn()(*ptrs, n, p, ps, pt, *strides, SOCKET_PLATE_HX, SOCKET_PLATE_HY, FINGERTIP_RADIUS,
                          _RING_RADIUS, PATCH_RING_FRAC * FINGERTIP_RADIUS, GEL_STIFFNESS / PATCH_POINTS, stream)
    if err != 0:
        raise RuntimeError(f"contact_gen_launch failed: CUDA error {err}")
    profiling.count("kernels.contact_gen", 1)
    return ContactSet(r=r, n=nrm, depth=depth, v_other=v_other, mu=mu, weight=weight, stiffness=stiffness)


def generate_contacts(tip_pos, tip_vel, plug_q, plug_pos, plug_com_w, socket_q, socket_pos, kind_onehot,
                      plug_hx, plug_hy, plug_length, hole_hx, hole_hy, socket_height, table_height,
                      surface_points, surface_weights, mat: MaterialParams) -> ContactSet:
    """The substep's ContactSet: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    args = (tip_pos, tip_vel, plug_q, plug_pos, plug_com_w, socket_q, socket_pos, kind_onehot, plug_hx, plug_hy,
            plug_length, hole_hx, hole_hy, socket_height, table_height, surface_points, surface_weights, mat)
    if plug_q.device.type == "cuda":
        return generate_contacts_cuda(*args)
    if plug_q.device.type == "cpu":
        return generate_contacts_plain(*args)
    raise ValueError(f"no contact generation for device {plug_q.device}")
