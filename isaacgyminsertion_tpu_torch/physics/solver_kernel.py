"""Fused contact solve: the hand-written CUDA kernel and its plain version.

`solve_contacts_fused` replaces `isaacgyminsertion_tpu/physics/
solver_pallas.py::solve_contacts_fused` (the Pallas `_solver_kernel`): the
split-impulse velocity solve (`solver.solve_contacts(beta=0)`) plus the
rigid-only positional correction (`solver.position_correction`) in one
launch. CUDA tensors go to the kernel in `csrc/contact_solver.cu`; CPU
tensors go to `solve_contacts_fused_plain`. There is no fallback: a CUDA
input the kernel does not take raises.

The kernel is built with nvcc for sm_90a at first use and bound with ctypes
through a plain C entry point (`utils/cuda_build.py`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import profiling
from ..utils.cuda_build import CudaKernel
from .solver import ContactSet, position_correction, solve_contacts

KERNEL_NAME = "contact_solver"
MAX_CONTACTS = 256

# f32 operations per contact, counted from csrc/contact_solver.cu (a
# division, a sqrt, a min/max and a select count as one each): a velocity
# iteration is the normal pass (48) plus the friction pass (105); a position
# iteration is 44; the masks and effective masses of both phases are 21. The
# per-env scalar updates and the cross-lane reductions are not counted. Only
# the active contacts (depth > 0 and weight != 0) are iterated: an inert one
# adds exact zeros to every sum, so the function needs only its mask.
FLOPS_PER_VEL_ITER = 153
FLOPS_PER_POS_ITER = 44
FLOPS_SETUP = 21


def flops(n: int, c: int, active: int | None = None, iters: int = 16, pos_iters: int = 8) -> int:
    """f32 operations one launch does on N envs × C contacts, `active` of them
    active (all when None)."""
    active = n * c if active is None else active
    return n * c * FLOPS_SETUP + active * (iters * FLOPS_PER_VEL_ITER + pos_iters * FLOPS_PER_POS_ITER)


def bytes_moved(n: int, c: int) -> int:
    """Bytes one launch must move: each input read once, each output written once."""
    per_contact = 4 * (3 * 3 + 4) + 4 * (1 + 3)      # r, n, v_other, 4 scalars; lam_n, lam_t
    per_env = 4 * (1 + 9 + 3 + 3) + 4 * (4 * 3)      # mass, I_inv, v, w; v, w, dx, dth
    return n * c * per_contact + n * per_env


class FusedSolveResult(NamedTuple):
    v: torch.Tensor       # [N, 3]
    w: torch.Tensor       # [N, 3]
    lam_n: torch.Tensor   # [N, C]
    lam_t: torch.Tensor   # [N, C, 3]
    dx: torch.Tensor      # [N, 3] positional correction of the com
    dth: torch.Tensor     # [N, 3] rotational correction


# --------------------------------------------------------------------------- build

KERNEL = CudaKernel(
    KERNEL_NAME, "contact_solver.cu", "contact_solver_launch",
    [ctypes.c_void_p] * 17 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                              ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                              ctypes.c_void_p])
BUILD_INFO = KERNEL.info
build = KERNEL.build


# ------------------------------------------------------------------------ versions


def solve_contacts_fused_plain(mass, I_inv_w, v, w, cs: ContactSet, h: float, iters: int = 16,
                               pos_iters: int = 8, beta_pos: float = 0.3, slop: float = 2.0e-4,
                               max_corr: float = 0.01) -> FusedSolveResult:
    """Plain PyTorch version: the reference's zero-bias velocity solve followed
    by its positional correction (runs on any device)."""
    res = solve_contacts(mass, I_inv_w, v, w, cs, h, iters=iters, beta=0.0, slop=slop)
    dx, dth = position_correction(mass, I_inv_w, cs, iters=pos_iters, beta=beta_pos,
                                  slop=slop, max_corr=max_corr)
    return FusedSolveResult(v=res.v, w=res.w, lam_n=res.lam_n, lam_t=res.lam_t, dx=dx, dth=dth)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def solve_contacts_fused_cuda(mass, I_inv_w, v, w, cs: ContactSet, h: float, iters: int = 16,
                              pos_iters: int = 8, beta_pos: float = 0.3, slop: float = 2.0e-4,
                              max_corr: float = 0.01) -> FusedSolveResult:
    """Launch the CUDA kernel on PyTorch's current stream (counted in
    `profiling`'s `kernels.contact_solver`)."""
    n, c = cs.depth.shape
    dev = cs.depth.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA contact solver needs CUDA tensors, got {dev}")
    if not 0 < c <= MAX_CONTACTS:
        raise ValueError(f"the CUDA contact solver takes 1..{MAX_CONTACTS} contacts, got {c}")
    for name, t, shape in [("r", cs.r, (n, c, 3)), ("n", cs.n, (n, c, 3)),
                           ("v_other", cs.v_other, (n, c, 3)), ("depth", cs.depth, (n, c)),
                           ("mu", cs.mu, (n, c)), ("weight", cs.weight, (n, c)),
                           ("stiffness", cs.stiffness, (n, c)), ("mass", mass, (n,)),
                           ("I_inv_w", I_inv_w, (n, 3, 3)), ("v", v, (n, 3)), ("w", w, (n, 3))]:
        _check(name, t, shape, dev)
    out = [torch.empty((n, 3), dtype=torch.float32, device=dev) for _ in range(4)]
    lam_n = torch.empty((n, c), dtype=torch.float32, device=dev)
    lam_t = torch.empty((n, c, 3), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (cs.r, cs.n, cs.v_other, cs.depth, cs.mu, cs.weight,
                                   cs.stiffness, mass, I_inv_w, v, w, *out, lam_n, lam_t)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = KERNEL.fn()(*ptrs, n, c, float(h), int(iters), int(pos_iters),
                                           float(beta_pos), float(slop), float(max_corr), stream)
    if err != 0:
        raise RuntimeError(f"contact_solver_launch failed: CUDA error {err}")
    profiling.count("kernels.contact_solver", 1)
    return FusedSolveResult(v=out[0], w=out[1], lam_n=lam_n, lam_t=lam_t, dx=out[2], dth=out[3])


def random_problem(n: int, c: int, seed: int = 0, lever: float = 0.05):
    """A random contact problem as numpy arrays (mass, I_inv, v, w, ContactSet
    fields): the construction of the reference's solver parity test — ~1/3 of
    the contacts penetrating, the first 3 slots soft gel pads moving. `lever`
    is the spread of the contact points around the com in metres; with the
    default some envs' impulses grow without bound over the iterations (the
    random inertias are small), with 0.01 every env stays bounded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    r = rng.normal(size=(n, c, 3)) * lever
    nrm = rng.normal(size=(n, c, 3))
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    depth = rng.uniform(-0.01, 0.005, (n, c))
    v_other = np.zeros((n, c, 3))
    v_other[:, :3] = rng.normal(size=(n, min(3, c), 3))[:, :3] * 0.05
    mu = rng.uniform(0.2, 1.0, (n, c))
    weight = rng.uniform(0.5, 1.5, (n, c))
    stiffness = np.zeros((n, c))
    stiffness[:, :3] = 3500.0
    mass = rng.uniform(0.05, 1.0, (n,))
    I_diag = rng.uniform(1e-5, 1e-3, (n, 3))
    I_inv = np.stack([np.diag(1.0 / d) for d in I_diag])
    v = rng.normal(size=(n, 3)) * 0.3
    w = rng.normal(size=(n, 3)) * 1.0
    cs = dict(r=f32(r), n=f32(nrm), depth=f32(depth), v_other=f32(v_other), mu=f32(mu),
              weight=f32(weight), stiffness=f32(stiffness))
    return f32(mass), f32(I_inv), f32(v), f32(w), cs


def solve_contacts_fused(mass, I_inv_w, v, w, cs: ContactSet, h: float, iters: int = 16,
                         pos_iters: int = 8, beta_pos: float = 0.3, slop: float = 2.0e-4,
                         max_corr: float = 0.01) -> FusedSolveResult:
    """Velocity solve + positional correction: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    kw = dict(iters=iters, pos_iters=pos_iters, beta_pos=beta_pos, slop=slop, max_corr=max_corr)
    if cs.depth.device.type == "cuda":
        return solve_contacts_fused_cuda(mass, I_inv_w, v, w, cs, h, **kw)
    if cs.depth.device.type == "cpu":
        return solve_contacts_fused_plain(mass, I_inv_w, v, w, cs, h, **kw)
    raise ValueError(f"no contact solver for device {cs.depth.device}")
