"""Operations and bytes of one launch of each hand-written kernel, counted
from the launch's own inputs.

A frozen copy of `physics/solver_kernel.py::flops/bytes_moved` and
`sensors/render_kernels.py::{tactile,camera}_{flops,bytes_moved}` of the
port, with the constants they were counted with from the CUDA sources (a
division, a sqrt, a min/max and a select count as one operation each).
"""

from __future__ import annotations

from . import PEAK_BYTES_PER_S, PEAK_F32_FLOPS

# contact solver (csrc/contact_solver.cu): a velocity iteration is the normal
# pass (48) plus the friction pass (105); a position iteration 44; the masks
# and effective masses of both phases 21. Only the active contacts (depth > 0
# and weight != 0) are iterated.
SOLVER_FLOPS_PER_VEL_ITER = 153
SOLVER_FLOPS_PER_POS_ITER = 44
SOLVER_FLOPS_SETUP = 21

# renderers (csrc/tactile_render.cu, csrc/camera_render.cu)
TACTILE_ROW = 43          # floats per packed (env, finger) row
CAMERA_ROW = 98           # floats per packed env row
HP_SLOTS = 6              # half-plane slots of a packed section
TACTILE_FLOPS_FIXED = 181
TACTILE_FLOPS_HALFPLANE = 35
TACTILE_FLOPS_QUAD = 98
TACTILE_FLOPS_NOISE = {None: 0, "gauss": 31, "ih4": 45}
TACTILE_FLOPS_SDF = 60    # one plug SDF evaluation and its march update
CAMERA_FLOPS_FIXED = 401
CAMERA_FLOPS_HALFPLANE = 24
CAMERA_FLOPS_QUAD = 37
CAMERA_FLOPS_SCENE = 220  # one scene evaluation of the march variant


def solver_flops(n: int, c: int, active: int, iters: int = 16, pos_iters: int = 8) -> int:
    """f32 operations of one solve of N envs × C contact slots, `active` of them active."""
    return n * c * SOLVER_FLOPS_SETUP + active * (iters * SOLVER_FLOPS_PER_VEL_ITER
                                                  + pos_iters * SOLVER_FLOPS_PER_POS_ITER)


def solver_bytes(n: int, c: int) -> int:
    """Bytes one solve must move: each input read once, each output written once."""
    per_contact = 4 * (3 * 3 + 4) + 4 * (1 + 3)      # r, n, v_other, 4 scalars; lam_n, lam_t
    per_env = 4 * (1 + 9 + 3 + 3) + 4 * (4 * 3)      # mass, I_inv, v, w; v, w, dx, dth
    return n * c * per_contact + n * per_env


def _section_flops(scal, at: int, per_halfplane: int, per_quad: int):
    """[rows] operations of the packed section at column `at` of each row: its
    used (non-neutral) half-plane slots and its quadratic if active."""
    hp = scal[:, at:at + 3 * HP_SLOTS].reshape(-1, HP_SLOTS, 3)
    used = ((hp[..., 0] != 0) | (hp[..., 1] != 0)).sum(dim=1)
    active = scal[:, at + 3 * HP_SLOTS + 2] > 0.5
    return used * per_halfplane + active * per_quad


def tactile_flops(scal, pixels: int, exact: bool = True, iters: int = 12, noise_kind=None) -> int:
    """f32 operations of one tactile launch on the packed rows `scal` [R, TACTILE_ROW]."""
    rows = scal.shape[0]
    noise = TACTILE_FLOPS_NOISE[noise_kind]
    if not exact:
        return rows * pixels * (137 + (iters + 5) * TACTILE_FLOPS_SDF + noise)
    sections = _section_flops(scal, 22, TACTILE_FLOPS_HALFPLANE, TACTILE_FLOPS_QUAD)
    return pixels * (rows * (TACTILE_FLOPS_FIXED + noise) + int(sections.sum()))


def tactile_bytes(rows: int, pixels: int) -> int:
    """Bytes one tactile launch must move: inputs read once, outputs written once."""
    return 4 * (rows * TACTILE_ROW + 3 * pixels + pixels + 3 * rows * pixels)


def camera_flops(scal, pixels: int, exact: bool = True, iters: int = 24) -> int:
    """f32 operations of one camera launch on the packed rows `scal` [N, CAMERA_ROW]."""
    envs = scal.shape[0]
    if not exact:
        return envs * pixels * (35 + (iters + 1) * CAMERA_FLOPS_SCENE)
    sections = (_section_flops(scal, 56, CAMERA_FLOPS_HALFPLANE, CAMERA_FLOPS_QUAD)
                + _section_flops(scal, 77, CAMERA_FLOPS_HALFPLANE, CAMERA_FLOPS_QUAD))
    return pixels * (envs * CAMERA_FLOPS_FIXED + int(sections.sum()))


def camera_bytes(envs: int, pixels: int) -> int:
    """Bytes one camera launch must move: inputs read once, outputs written once."""
    return 4 * (envs * CAMERA_ROW + 3 * pixels + 3 * envs * pixels)


def bound_s(flops: int, nbytes: int) -> float:
    """The least time the H100 could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
