"""The fused ray-cast renderers: hand-written CUDA kernels and their plain versions.

Counterpart of `isaacgyminsertion_tpu/sensors/render_pallas.py`:

- `tactile_render` replaces `tactile_march_fused` (the Pallas
  `_tactile_kernel`): final RGB gel images [R, P, 3] for R = envs × fingers
  rows, with the gel mask, glow, pixel noise and clip fused in.
- `camera_render` replaces `camera_march_fused` (the Pallas `_camera_kernel`):
  (t, d_min, component id) planes [N, P] of the external camera.

CUDA tensors go to the kernels in `csrc/tactile_render.cu` and
`csrc/camera_render.cu`; CPU tensors go to `tactile_render_plain` and
`camera_render_plain`, the same arithmetic in plain PyTorch on [rows, pixels]
planes. There is no fallback: a CUDA input a kernel does not take raises.

Packing stays outside the kernels, as in the reference: the wrappers build
one row of scalars per (env, finger) or env, with the section's half-planes
from `raycast.section_halfplanes`, and both versions read that row.

Noise (tactile only): the kernel draws from a counter-based Philox generator
keyed by a 64-bit seed taken from the caller's `torch.Generator` and the
(row, pixel) index; the plain version draws `torch.randn` from the same
generator. The two give different numbers from one seed: they are compared by
their statistics.
"""

from __future__ import annotations

import ctypes

import torch

from ..assets import SOCKET_PLATE_HX, SOCKET_PLATE_HY
from ..ops import sdf as sdfm
from ..utils import profiling
from ..utils.cuda_build import CudaKernel
from . import raycast as rc

TACTILE_ROW = 43   # floats per (env, finger) row, layout in csrc/tactile_render.cu
CAMERA_ROW = 98    # floats per env row, layout in csrc/camera_render.cu
NOISE_KINDS = {"gauss": 1, "ih4": 2}

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
TACTILE_KERNEL = CudaKernel(
    "tactile_render", "tactile_render.cu", "tactile_render_launch",
    [_P] * 5 + [_I] * 5 + [_F] * 6 + [_P], headers=["render_common.cuh"])
CAMERA_KERNEL = CudaKernel(
    "camera_render", "camera_render.cu", "camera_render_launch",
    [_P] * 3 + [_I] * 4 + [_F] * 6 + [_P], headers=["render_common.cuh"])

# tetrahedron finite-difference directions of the march variant's normal
_TET = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
_FD_EPS = 2.0e-5
# 3 RGB lights at 120° around the optical axis: direction (camera frame), colour
_LIGHTS = (
    (0.7, 0.0, 0.714, 1.0, 0.25, 0.25),
    (-0.35, 0.6062177826491071, 0.714, 0.25, 1.0, 0.25),
    (-0.35, -0.6062177826491071, 0.714, 0.25, 0.25, 1.0),
)

# f32 operations per pixel, counted from the kernels' sources (an add, a mul,
# a division, a sqrt, an abs, a min/max, a compare and a select count as one
# each; log, sin and cos as one each; the Philox integer rounds are not counted).
# A packed section counts only the half-plane slots and the quadratic its
# env's family uses (a circle or an ellipse the quadratic, a box or a
# trapezoid 4 half-planes, a triangle 3, a hexagon 6): a neutral slot or an
# inactive quadratic is no part of the function. A half-plane interval is 16.
# tactile exact = direction 15 + z-slab 36 + hit and entry normal 17
#   + hit point and cap of the interior gradient 15 + normalize 11
#   + hit/indent/height 14 + shading 57 + mask, glow and clip 16 = 181,
#   + per half-plane 35 (the sweep's two dot products, interval, normal's
#   compare and selects, max, min: 27; its interior-gradient term: 8)
#   + the quadratic 98 (sweep 48, interior gradient 50);
# camera exact = directions 35 + z-slab 36 + plug 5 + socket 124 + table 9
#   + 5 spheres 115 + cylinder 64 + select 13 = 401, + per half-plane of the
#   plug and of the hole 24 (two dot products, interval, max, min)
#   + each of their quadratics 37.
# With every slot and the quadratic counted (the dense count): tactile 489,
# camera 763. The march figures are rough (an SDF evaluation costs 30 to 70
# by family).
TACTILE_FLOPS_FIXED = 181
TACTILE_FLOPS_HALFPLANE = 35
TACTILE_FLOPS_QUAD = 98
TACTILE_FLOPS_GAUSS = 31
TACTILE_FLOPS_IH4 = 45
TACTILE_FLOPS_SDF = 60      # one plug_sdf evaluation and its march update
CAMERA_FLOPS_FIXED = 401
CAMERA_FLOPS_HALFPLANE = 24
CAMERA_FLOPS_QUAD = 37
CAMERA_FLOPS_SCENE = 220    # one scene evaluation of the march variant


def _section_flops(scal, at, per_halfplane, per_quad):
    """[rows] operations of the packed section at column `at` of each row:
    its used (non-neutral) half-plane slots and its quadratic if active."""
    hp = scal[:, at:at + 3 * rc.HP_SLOTS].reshape(-1, rc.HP_SLOTS, 3)
    used = ((hp[..., 0] != 0) | (hp[..., 1] != 0)).sum(dim=1)
    active = scal[:, at + 3 * rc.HP_SLOTS + 2] > 0.5
    return used * per_halfplane + active * per_quad


def tactile_flops(scal, pixels: int, exact: bool = True, iters: int = 12,
                  noise_kind: str | None = "gauss") -> int:
    """f32 operations one tactile launch does on the packed rows `scal` [R, TACTILE_ROW]."""
    rows = scal.shape[0]
    noise = {None: 0, "gauss": TACTILE_FLOPS_GAUSS, "ih4": TACTILE_FLOPS_IH4}[noise_kind]
    if not exact:
        return rows * pixels * (137 + (iters + 5) * TACTILE_FLOPS_SDF + noise)
    sections = _section_flops(scal, 22, TACTILE_FLOPS_HALFPLANE, TACTILE_FLOPS_QUAD)
    return pixels * (rows * (TACTILE_FLOPS_FIXED + noise) + int(sections.sum()))


def tactile_bytes_moved(rows: int, pixels: int) -> int:
    """Bytes one tactile launch must move: inputs read once, outputs written once."""
    return 4 * (rows * TACTILE_ROW + 3 * pixels + pixels + 3 * rows * pixels)


def camera_flops(scal, pixels: int, exact: bool = True, iters: int = 24) -> int:
    """f32 operations one camera launch does on the packed rows `scal` [N, CAMERA_ROW]."""
    envs = scal.shape[0]
    if not exact:
        return envs * pixels * (35 + (iters + 1) * CAMERA_FLOPS_SCENE)
    sections = (_section_flops(scal, 56, CAMERA_FLOPS_HALFPLANE, CAMERA_FLOPS_QUAD)
                + _section_flops(scal, 77, CAMERA_FLOPS_HALFPLANE, CAMERA_FLOPS_QUAD))
    return pixels * (envs * CAMERA_FLOPS_FIXED + int(sections.sum()))


def camera_bytes_moved(envs: int, pixels: int) -> int:
    """Bytes one camera launch must move: inputs read once, outputs written once."""
    return 4 * (envs * CAMERA_ROW + 3 * pixels + 3 * envs * pixels)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ------------------------------------------------------------------- tactile


def pack_tactile_rows(M, o, kind_onehot, hx, hy, length, force) -> torch.Tensor:
    """[R, TACTILE_ROW] scalar rows: rotation, origin, family, shape, force and
    the packed section of each (env, finger) row."""
    r = M.shape[0]
    hp, quad = rc.section_halfplanes(kind_onehot, hx, hy)
    return torch.cat([M.reshape(r, 9), o, kind_onehot, hx[:, None], hy[:, None], length[:, None],
                      force[:, None], hp.reshape(r, 3 * rc.HP_SLOTS), quad], dim=1).contiguous()


def _tactile_planes(scal, rays, mask, *, exact, iters, max_range, max_deformation, force_range,
                    t0, glow):
    """Noise-free r, g, b planes [R, P] before the clip: the arithmetic of the
    CUDA kernel, term by term, on planes."""
    c = lambda i: scal[:, i:i + 1]
    m = [c(i) for i in range(9)]
    ox, oy, oz = c(9), c(10), c(11)
    oh = tuple(c(12 + k) for k in range(6))
    hx, hy, length, force = c(18), c(19), c(20), c(21)
    hp = scal[:, 22:40].reshape(-1, 1, rc.HP_SLOTS, 3)
    quad = scal[:, 40:43].reshape(-1, 1, 3)
    rx, ry, rz = rays[0:1], rays[1:2], rays[2:3]
    dx = m[0] * rx + m[1] * ry + m[2] * rz
    dy = m[3] * rx + m[4] * ry + m[5] * rz
    dz = m[6] * rx + m[7] * ry + m[8] * rz
    zz = torch.zeros_like(dx)

    if exact:
        s_lo, s_hi, snx, sny = rc.packed_interval_normal(ox, oy, dx, dy, hp, quad)
        z_lo, z_hi = rc._slab_interval(oz, dz, torch.zeros_like(length), length)
        entry = torch.maximum(s_lo, z_lo)
        t_in = torch.clamp_min(entry, t0)
        t_out = torch.minimum(s_hi, z_hi)
        far = torch.full_like(dx, max_range)
        t = torch.where(t_in <= t_out, torch.clamp_max(t_in, max_range), far)
        d_final = torch.where(t < max_range - 1e-6, zz, torch.ones_like(zz))
        cap = z_lo > s_lo
        nx = torch.where(cap, zz, snx)
        ny = torch.where(cap, zz, sny)
        nz = torch.where(cap, -torch.sign(dz), zz)
        # origin inside the prism: the nearest-face gradient at the hit point
        inside = (entry < t0 - 1e-9) & (t_in <= t_out)
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        d2g, gxg, gyg = rc.packed_inner_grad(px, py, hp, quad)
        wz = torch.abs(pz - 0.5 * length) - 0.5 * length
        cap_in = wz > d2g
        nx = torch.where(inside, torch.where(cap_in, zz, gxg), nx)
        ny = torch.where(inside, torch.where(cap_in, zz, gyg), ny)
        nz = torch.where(inside, torch.where(cap_in, torch.sign(pz - 0.5 * length), zz), nz)
    else:
        sdf = lambda x, y, z: sdfm.plug_sdf_planes(x, y, z, oh, hx, hy, length)
        t = torch.full_like(dx, t0)
        for _ in range(iters):
            d = sdf(ox + dx * t, oy + dy * t, oz + dz * t)
            t = torch.clamp_max(t + torch.clamp_min(d, 1e-4), max_range)
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        d_final = sdf(px, py, pz)
        nx, ny, nz = zz, zz, zz
        for ex, ey, ez in _TET:
            dd = sdf(px + _FD_EPS * ex, py + _FD_EPS * ey, pz + _FD_EPS * ez)
            nx = nx + ex * dd
            ny = ny + ey * dd
            nz = nz + ez * dd
    inv = 1.0 / torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-9)
    nx, ny, nz = nx * inv, ny * inv, nz * inv

    hit = ((d_final < 2e-3) & (t < max_range - 1e-4)).to(t.dtype)
    indent = max_deformation * torch.clamp(force / force_range, 0.0, 1.0)
    height = torch.clamp(1.0 - (t - indent) / max_range, 0.0, 1.0) * hit

    # normal back to the camera frame: n_c = Mᵀ n_p
    ncx = m[0] * nx + m[3] * ny + m[6] * nz
    ncy = m[1] * nx + m[4] * ny + m[7] * nz
    ncz = m[2] * nx + m[5] * ny + m[8] * nz
    r, g, b = zz, zz, zz
    for lx, ly, lz, cr, cg, cb in _LIGHTS:
        lam = torch.clamp(-(ncx * lx + ncy * ly + ncz * lz), 0.0, 1.0)
        r = r + lam * cr
        g = g + lam * cg
        b = b + lam * cb
    msk = mask[None, :]
    hm = height * msk
    return r * hm + glow * msk, g * hm + glow * msk, b * hm + glow * msk


def tactile_rows(M, o, kind_onehot, hx, hy, length, force, rays_c, mask_flat=None):
    """Check the arguments of `tactile_render` and pack them → (scal
    [R, TACTILE_ROW], rays [3, P], mask [P]), the packed rows both versions read."""
    r, p = M.shape[0], rays_c.shape[0]
    dev = M.device
    for name, t, shape in [("M", M, (r, 3, 3)), ("o", o, (r, 3)), ("kind_onehot", kind_onehot, (r, 6)),
                           ("hx", hx, (r,)), ("hy", hy, (r,)), ("length", length, (r,)),
                           ("force", force, (r,)), ("rays_c", rays_c, (p, 3))]:
        _check(name, t, shape, dev)
    if mask_flat is None:
        mask_flat = torch.ones((p,), dtype=torch.float32, device=dev)
    _check("mask_flat", mask_flat, (p,), dev)
    scal = pack_tactile_rows(M, o, kind_onehot, hx, hy, length, force)
    return scal, rays_c.T.contiguous(), mask_flat


def _noise_kind(noise_kind, noise_std, generator):
    """None when the call draws no noise, else "gauss" or "ih4"."""
    if noise_std <= 0.0 or generator is None:
        return None
    if noise_kind not in NOISE_KINDS:
        raise ValueError(f"noise_kind must be one of {sorted(NOISE_KINDS)}, got {noise_kind!r}")
    return noise_kind


def tactile_rows_plain(scal, rays, mask, *, iters: int, max_range: float, max_deformation: float,
                       force_range: float, t0: float = 1e-3, exact: bool = True, generator=None,
                       noise_std: float = 0.0, glow: float = 0.0, noise_kind: str = "gauss"):
    """Plain PyTorch version on packed rows (runs on any device): scal
    [R, TACTILE_ROW], rays [3, P], mask [P] → RGB [R, P, 3]. Its noise is
    `torch.randn` (or a sum of four `torch.rand` for "ih4") from `generator`."""
    planes = _tactile_planes(scal, rays, mask, exact=exact, iters=iters, max_range=max_range,
                             max_deformation=max_deformation, force_range=force_range, t0=t0,
                             glow=glow)
    img = torch.stack(planes, dim=-1)
    kind = _noise_kind(noise_kind, noise_std, generator)
    if kind == "gauss":
        img = img + noise_std * torch.randn(img.shape, generator=generator, device=img.device)
    elif kind == "ih4":
        u = torch.rand((4,) + img.shape, generator=generator, device=img.device)
        img = img + noise_std * ((u.sum(0) - 2.0) * 1.7320508075688772)
    return torch.clamp(img, 0.0, 1.0)


def tactile_rows_cuda(scal, rays, mask, *, iters: int, max_range: float, max_deformation: float,
                      force_range: float, t0: float = 1e-3, exact: bool = True, generator=None,
                      noise_std: float = 0.0, glow: float = 0.0, noise_kind: str = "gauss"):
    """Launch the CUDA kernel on packed rows, on PyTorch's current stream →
    RGB [R, P, 3] (a view of the kernel's [3, R, P] planes); counted in
    `profiling`'s `kernels.tactile_render`."""
    dev = scal.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA tactile renderer needs CUDA tensors, got {dev}")
    r, p = scal.shape[0], rays.shape[1]
    for name, t, shape in [("scal", scal, (r, TACTILE_ROW)), ("rays", rays, (3, p)), ("mask", mask, (p,))]:
        _check(name, t, shape, dev)
    kind = _noise_kind(noise_kind, noise_std, generator)
    seed_ptr = None
    if kind is not None:
        # the seed stays on the device: the kernel reads it, the host never waits for it
        seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64, generator=generator, device=dev)
        seed_ptr = seed.data_ptr()
    out = torch.empty((3, r, p), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = TACTILE_KERNEL.fn()(
            scal.data_ptr(), rays.data_ptr(), mask.data_ptr(), seed_ptr, out.data_ptr(), r, p,
            int(bool(exact)), NOISE_KINDS.get(kind, 0), int(iters), float(max_range),
            float(max_deformation), float(force_range), float(t0), float(noise_std), float(glow),
            stream)
    if err != 0:
        raise RuntimeError(f"tactile_render_launch failed: CUDA error {err}")
    profiling.count("kernels.tactile_render", 1)
    return out.permute(1, 2, 0)


def tactile_render_plain(M, o, kind_onehot, hx, hy, length, force, rays_c, *, mask_flat=None, **kw):
    """Plain PyTorch version of `tactile_render` (runs on any device)."""
    return tactile_rows_plain(*tactile_rows(M, o, kind_onehot, hx, hy, length, force, rays_c,
                                             mask_flat), **kw)


def tactile_render_cuda(M, o, kind_onehot, hx, hy, length, force, rays_c, *, mask_flat=None, **kw):
    """`tactile_render` through the CUDA kernel (CUDA tensors only)."""
    return tactile_rows_cuda(*tactile_rows(M, o, kind_onehot, hx, hy, length, force, rays_c,
                                            mask_flat), **kw)


def tactile_render(M, o, kind_onehot, hx, hy, length, force, rays_c, **kw):
    """Final RGB gel images [R, P, 3]: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    M [R, 3, 3] camera→plug rotations, o [R, 3] ray origins in the plug frame,
    kind_onehot [R, 6], hx/hy/length/force [R], rays_c [P, 3] constant pixel
    ray directions (camera frame); `mask_flat` [P] is the gel mask. Keywords
    as `tactile_rows_plain`."""
    if M.device.type == "cuda":
        return tactile_render_cuda(M, o, kind_onehot, hx, hy, length, force, rays_c, **kw)
    if M.device.type == "cpu":
        return tactile_render_plain(M, o, kind_onehot, hx, hy, length, force, rays_c, **kw)
    raise ValueError(f"no tactile renderer for device {M.device}")


# -------------------------------------------------------------------- camera


def pack_camera_rows(M_plug, o_plug, M_sock, o_sock, cam_R_zrow, cam_z, kind_onehot, plug_hx,
                     plug_hy, plug_length, hole_hx, hole_hy, socket_height, table_h, tips_cam,
                     wrist_cam, hand_cam) -> torch.Tensor:
    """[N, CAMERA_ROW] scalar rows of the camera kernel."""
    n = M_plug.shape[0]
    hp_p, quad_p = rc.section_halfplanes(kind_onehot, plug_hx, plug_hy)
    hp_h, quad_h = rc.section_halfplanes(kind_onehot, hole_hx, hole_hy)
    col = lambda x: x[:, None]
    return torch.cat([
        M_plug.reshape(n, 9), o_plug, M_sock.reshape(n, 9), o_sock, cam_R_zrow, col(cam_z),
        kind_onehot, col(plug_hx), col(plug_hy), col(plug_length), col(hole_hx), col(hole_hy),
        col(socket_height), col(table_h), tips_cam.reshape(n, 9), wrist_cam, hand_cam,
        hp_p.reshape(n, 3 * rc.HP_SLOTS), quad_p, hp_h.reshape(n, 3 * rc.HP_SLOTS), quad_h,
    ], dim=1).contiguous()


def _camera_planes(scal, rays, *, exact, iters, near, far, plate_hx, plate_hy, tip_radius,
                   hand_radius):
    """(t, d_min, comp) planes [N, P]: the arithmetic of the CUDA kernel on planes."""
    c = lambda i: scal[:, i:i + 1]
    mp = [c(i) for i in range(9)]
    opx, opy, opz = c(9), c(10), c(11)
    ms = [c(12 + i) for i in range(9)]
    osx, osy, osz = c(21), c(22), c(23)
    wz0, wz1, wz2, cam_z = c(24), c(25), c(26), c(27)
    oh = tuple(c(28 + k) for k in range(6))
    phx, phy, plen = c(34), c(35), c(36)
    hhx, hhy, sheight = c(37), c(38), c(39)
    table_h = c(40)
    tips = [(c(41 + 3 * i), c(42 + 3 * i), c(43 + 3 * i)) for i in range(3)]
    ax, ay, az = c(50), c(51), c(52)
    bx, by, bz = c(53), c(54), c(55)
    pack = lambda a: (scal[:, a:a + 18].reshape(-1, 1, rc.HP_SLOTS, 3),
                      scal[:, a + 18:a + 21].reshape(-1, 1, 3))
    abx, aby, abz = bx - ax, by - ay, bz - az
    ab2 = abx * abx + aby * aby + abz * abz + 1e-9

    rx, ry, rz = rays[0:1], rays[1:2], rays[2:3]
    dpx = mp[0] * rx + mp[1] * ry + mp[2] * rz
    dpy = mp[3] * rx + mp[4] * ry + mp[5] * rz
    dpz = mp[6] * rx + mp[7] * ry + mp[8] * rz
    dsx = ms[0] * rx + ms[1] * ry + ms[2] * rz
    dsy = ms[3] * rx + ms[4] * ry + ms[5] * rz
    dsz = ms[6] * rx + ms[7] * ry + ms[8] * rz
    dwz = wz0 * rx + wz1 * ry + wz2 * rz     # world-frame ray z component
    big = torch.full_like(dpx, rc.BIG)

    if exact:
        t_p = rc.plug_hit(opx, opy, opz, dpx, dpy, dpz, *pack(56), plen)
        t_s = rc.socket_hit(osx, osy, osz, dsx, dsy, dsz, *pack(77), sheight, plate_hx, plate_hy)
        # table half-space seen from above
        t_t = (table_h - cam_z) / torch.where(torch.abs(dwz) < 1e-9, torch.full_like(dwz, -1e-9), dwz)
        t_t = torch.where((dwz < -1e-9) & (t_t > 0.0), t_t, big)

        # robot proxy (camera frame, ray origin 0, |d| = 1)
        def sphere0(cx, cy, cz, radius):
            b = -(cx * rx + cy * ry + cz * rz)
            cc = cx * cx + cy * cy + cz * cz - radius * radius
            disc = b * b - cc
            th = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
            return torch.where((disc > 0.0) & (th > 0.0), th, big)

        t_k = torch.minimum(sphere0(ax, ay, az, hand_radius), sphere0(bx, by, bz, hand_radius))
        for tx, ty, tz in tips:
            t_k = torch.minimum(t_k, sphere0(tx, ty, tz, tip_radius))
        inv_lab = 1.0 / torch.sqrt(ab2)
        d_par = (rx * abx + ry * aby + rz * abz) * inv_lab
        o_par = -(ax * abx + ay * aby + az * abz) * inv_lab
        qa = torch.clamp_min(1.0 - d_par * d_par, 1e-9)
        qb = -(ax * rx + ay * ry + az * rz) - o_par * d_par
        qc = ax * ax + ay * ay + az * az - o_par * o_par - hand_radius * hand_radius
        disc = qb * qb - qa * qc
        t_cyl = (-qb - torch.sqrt(torch.clamp_min(disc, 0.0))) / qa
        hseg = o_par + d_par * t_cyl
        on_seg = (hseg >= 0.0) & (hseg * hseg <= ab2)
        t_k = torch.minimum(t_k, torch.where((disc > 0.0) & (t_cyl > 0.0) & on_seg, t_cyl, big))

        t = torch.minimum(torch.minimum(torch.minimum(t_t, t_p), t_s), t_k)
        # first-wins tie order: table (0), plug (1), socket (2), robot (3)
        one = torch.ones_like(t)
        comp = torch.where(t_t <= t, 0.0 * one,
                           torch.where(t_p <= t, one, torch.where(t_s <= t, 2.0 * one, 3.0 * one)))
        dmin = torch.where(t < far - 1e-6, 0.0 * one, one)
        return torch.clamp_max(t, far), dmin, comp

    def scene(t):
        d_plug = sdfm.plug_sdf_planes(opx + dpx * t, opy + dpy * t, opz + dpz * t, oh, phx, phy, plen)
        d_sock = sdfm.socket_sdf_planes(osx + dsx * t, osy + dsy * t, osz + dsz * t, oh, hhx, hhy,
                                        sheight, plate_hx, plate_hy)
        d_table = (cam_z + dwz * t) - table_h
        px, py, pz = rx * t, ry * t, rz * t
        d_k = big
        for tx, ty, tz in tips:
            ex, ey, ez = px - tx, py - ty, pz - tz
            d_k = torch.minimum(d_k, torch.sqrt(ex * ex + ey * ey + ez * ez + 1e-12) - tip_radius)
        qx, qy, qz = px - ax, py - ay, pz - az
        h = torch.clamp((qx * abx + qy * aby + qz * abz) / ab2, 0.0, 1.0)
        cx, cy, cz = qx - h * abx, qy - h * aby, qz - h * abz
        d_k = torch.minimum(d_k, torch.sqrt(cx * cx + cy * cy + cz * cz + 1e-12) - hand_radius)
        return d_table, d_plug, d_sock, d_k

    t = torch.full_like(dpx, near)
    for _ in range(iters):
        dt, dp, ds, dk = scene(t)
        d = torch.minimum(torch.minimum(torch.minimum(dt, dp), ds), dk)
        t = torch.clamp_max(t + torch.clamp_min(d, 1e-4), far)
    dt, dp, ds, dk = scene(t)
    dmin = torch.minimum(torch.minimum(torch.minimum(dt, dp), ds), dk)
    one = torch.ones_like(t)
    comp = torch.where(dt <= dmin, 0.0 * one,
                       torch.where(dp <= dmin, one, torch.where(ds <= dmin, 2.0 * one, 3.0 * one)))
    return t, dmin, comp


def camera_rows(M_plug, o_plug, M_sock, o_sock, cam_R_zrow, cam_z, kind_onehot, plug_hx, plug_hy,
                plug_length, hole_hx, hole_hy, socket_height, table_h, rays_c, tips_cam=None,
                wrist_cam=None, hand_cam=None):
    """Check the arguments of `camera_render` and pack them → (scal
    [N, CAMERA_ROW], rays [3, P]), the packed rows both versions read."""
    n, p = M_plug.shape[0], rays_c.shape[0]
    dev = M_plug.device
    if tips_cam is None:
        # park the proxy robot far behind the camera: never hit
        tips_cam = torch.full((n, 3, 3), -100.0, device=dev)
        wrist_cam = torch.full((n, 3), -100.0, device=dev)
        hand_cam = torch.full((n, 3), -101.0, device=dev)
    for name, t, shape in [
            ("M_plug", M_plug, (n, 3, 3)), ("o_plug", o_plug, (n, 3)), ("M_sock", M_sock, (n, 3, 3)),
            ("o_sock", o_sock, (n, 3)), ("cam_R_zrow", cam_R_zrow, (n, 3)), ("cam_z", cam_z, (n,)),
            ("kind_onehot", kind_onehot, (n, 6)), ("plug_hx", plug_hx, (n,)), ("plug_hy", plug_hy, (n,)),
            ("plug_length", plug_length, (n,)), ("hole_hx", hole_hx, (n,)), ("hole_hy", hole_hy, (n,)),
            ("socket_height", socket_height, (n,)), ("table_h", table_h, (n,)),
            ("rays_c", rays_c, (p, 3)), ("tips_cam", tips_cam, (n, 3, 3)),
            ("wrist_cam", wrist_cam, (n, 3)), ("hand_cam", hand_cam, (n, 3))]:
        _check(name, t, shape, dev)
    scal = pack_camera_rows(M_plug, o_plug, M_sock, o_sock, cam_R_zrow, cam_z, kind_onehot, plug_hx,
                            plug_hy, plug_length, hole_hx, hole_hy, socket_height, table_h, tips_cam,
                            wrist_cam, hand_cam)
    return scal, rays_c.T.contiguous()


def camera_rows_plain(scal, rays, *, iters: int, near: float, far: float, plate_hx: float,
                      plate_hy: float, tip_radius: float = 0.018, hand_radius: float = 0.045,
                      exact: bool = True):
    """Plain PyTorch version on packed rows (runs on any device): scal
    [N, CAMERA_ROW], rays [3, P] → (t_hit, d_min, comp) [N, P]."""
    return _camera_planes(scal, rays, exact=exact, iters=iters, near=near, far=far,
                          plate_hx=plate_hx, plate_hy=plate_hy, tip_radius=tip_radius,
                          hand_radius=hand_radius)


def camera_rows_cuda(scal, rays, *, iters: int, near: float, far: float, plate_hx: float,
                     plate_hy: float, tip_radius: float = 0.018, hand_radius: float = 0.045,
                     exact: bool = True):
    """Launch the CUDA kernel on packed rows, on PyTorch's current stream →
    (t_hit, d_min, comp) [N, P]; counted in `profiling`'s
    `kernels.camera_render`."""
    dev = scal.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA camera renderer needs CUDA tensors, got {dev}")
    n, p = scal.shape[0], rays.shape[1]
    _check("scal", scal, (n, CAMERA_ROW), dev)
    _check("rays", rays, (3, p), dev)
    out = torch.empty((3, n, p), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = CAMERA_KERNEL.fn()(
            scal.data_ptr(), rays.data_ptr(), out.data_ptr(), n, p, int(bool(exact)), int(iters),
            float(near), float(far), float(plate_hx), float(plate_hy), float(tip_radius),
            float(hand_radius), stream)
    if err != 0:
        raise RuntimeError(f"camera_render_launch failed: CUDA error {err}")
    profiling.count("kernels.camera_render", 1)
    return out[0], out[1], out[2]


def camera_render_plain(*args, tips_cam=None, wrist_cam=None, hand_cam=None, **kw):
    """Plain PyTorch version of `camera_render` (runs on any device)."""
    return camera_rows_plain(*camera_rows(*args, tips_cam, wrist_cam, hand_cam), **kw)


def camera_render_cuda(*args, tips_cam=None, wrist_cam=None, hand_cam=None, **kw):
    """`camera_render` through the CUDA kernel (CUDA tensors only)."""
    return camera_rows_cuda(*camera_rows(*args, tips_cam, wrist_cam, hand_cam), **kw)


def camera_render(M_plug, *args, **kw):
    """(t_hit, d_min, comp) planes [N, P], comp ∈ {0 table, 1 plug, 2 socket,
    3 robot} as float: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. With `exact=True`, d_min is 0 on a hit and 1 on a miss.

    Positional: M_plug [N, 3, 3], o_plug [N, 3], M_sock, o_sock (camera→plug
    and camera→socket frames), cam_R_zrow [N, 3], cam_z [N], kind_onehot
    [N, 6], plug_hx, plug_hy, plug_length, hole_hx, hole_hy, socket_height,
    table_h [N], rays_c [P, 3]. Keywords: tips_cam [N, 3, 3], wrist_cam,
    hand_cam [N, 3] (the robot proxy in the camera frame; parked out of sight
    when omitted) and those of `camera_rows_plain`."""
    if M_plug.device.type == "cuda":
        return camera_render_cuda(M_plug, *args, **kw)
    if M_plug.device.type == "cpu":
        return camera_render_plain(M_plug, *args, **kw)
    raise ValueError(f"no camera renderer for device {M_plug.device}")


def random_tactile_inputs(n: int, seed: int = 0, f: int = 3):
    """Random tactile scenes as numpy arrays, the positional arguments of
    `tactile.render_tactile` after its config: (tip_q [n,f,4], tip_t [n,f,3],
    plug_q, plug_pos, kind_onehot, hx, hy, length, force [n,f]). The
    fingertips lie within a few cm of the plug so that many rays hit it; the
    six section families rotate through the envs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    unit = lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True)
    plug_pos = rng.uniform(0.45, 0.55, (n, 3))
    tip_t = plug_pos[:, None, :] + rng.uniform(-0.03, 0.03, (n, f, 3)) + np.array([0.0, 0.0, 0.02])
    return (f32(unit(rng.normal(size=(n, f, 4)))), f32(tip_t), f32(unit(rng.normal(size=(n, 4)))),
            f32(plug_pos), f32(np.eye(6)[np.arange(n) % 6]), f32(rng.uniform(0.005, 0.02, n)),
            f32(rng.uniform(0.005, 0.02, n)), f32(rng.uniform(0.03, 0.06, n)),
            f32(rng.uniform(0, 8, (n, f))))


def random_camera_inputs(n: int, seed: int = 0):
    """Random camera scenes as numpy arrays → (args, kwargs) of
    `camera.render_depth_seg` after its config: a tilted plug above a socket
    on the table in the calibrated camera's view, with the robot proxy above
    the plug; the six section families rotate through the envs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    unit = lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True)
    plug_pos = rng.uniform([0.45, -0.05, 0.04], [0.55, 0.05, 0.12], (n, 3))
    sock_pos = rng.uniform([0.45, -0.05, 0.001], [0.55, 0.05, 0.03], (n, 3))
    phx = rng.uniform(0.005, 0.02, n)
    phy = phx * rng.uniform(0.8, 1.2, n)
    args = (f32(unit(rng.normal(size=(n, 4)) * np.array([0.2, 0.2, 0.2, 1.0]))), f32(plug_pos),
            f32(unit(rng.normal(size=(n, 4)) * np.array([0.0, 0.0, 0.1, 1.0]))), f32(sock_pos),
            f32(np.eye(6)[np.arange(n) % 6]), f32(phx), f32(phy), f32(rng.uniform(0.03, 0.06, n)),
            f32(phx * 1.05), f32(phy * 1.05), f32(rng.uniform(0.015, 0.03, n)), f32(np.full(n, 0.001)))
    kw = dict(tip_pos=f32(plug_pos[:, None, :] + rng.uniform(-0.03, 0.03, (n, 3, 3))
                          + np.array([0.0, 0.0, 0.06])),
              wrist_pos=f32(plug_pos + np.array([0.0, 0.0, 0.25])),
              hand_pos=f32(plug_pos + np.array([0.0, 0.0, 0.12])), tip_radius=0.012, hand_radius=0.032)
    return args, kw


def camera_edge_inputs(n: int = 6, proxy: bool = True, tilt: float = 0.0, seed: int = 0,
                       height: int = 16, width: int = 24):
    """Camera scenes on the edges the CUDA kernel branches on, as numpy arrays
    → (args, kwargs) of `camera_render` (frames, not poses): env k has section
    family k % 6, so both quadratic cases and every half-plane count occur. The
    camera looks straight down on the plug and on the socket plate beside it;
    with `tilt` = 0 the frames are exact axis flips and the middle ray column
    and row have x = 0 and y = 0 exactly, so a ray parallel to a half-plane
    face or a plate slab takes the |u.d| < eps branch. With `proxy` the robot
    proxy is in view: a capsule across the line of sight occludes the plug, one
    fingertip is in front of the camera and one wholly behind it; without, the
    proxy is parked. `tilt` (radians) turns each env's frames by a random
    small rotation."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    xs = np.linspace(-0.2, 0.2, width)
    ys = np.linspace(-0.16, 0.16, height)
    xs[width // 2], ys[height // 2] = 0.0, 0.0
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    d = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3)
    rays = d / np.linalg.norm(d, axis=-1, keepdims=True)

    flip = np.diag([1.0, -1.0, -1.0])            # camera +z looks down the shapes' -z
    def turned():
        w = rng.normal(size=3) * tilt
        th = np.linalg.norm(w)
        if th == 0.0:
            return flip
        k = w / th
        K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
        return (np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)) @ flip

    phx = rng.uniform(0.008, 0.015, n)
    phy = phx * rng.uniform(0.8, 1.2, n)
    length = rng.uniform(0.03, 0.05, n)
    o_plug = np.stack([rng.uniform(-0.006, 0.006, n), rng.uniform(-0.006, 0.006, n),
                       rng.uniform(0.26, 0.3, n)], -1)
    o_sock = np.stack([rng.uniform(0.02, 0.04, n), rng.uniform(-0.01, 0.01, n),
                       rng.uniform(0.32, 0.34, n)], -1)
    args = (f32([turned() for _ in range(n)]), f32(o_plug), f32([turned() for _ in range(n)]), f32(o_sock),
            f32(np.tile([0.0, 0.0, -1.0], (n, 1))), f32(np.full(n, 0.35)), f32(np.eye(6)[np.arange(n) % 6]),
            f32(phx), f32(phy), f32(length), f32(phx * 1.05), f32(phy * 1.05), f32(np.full(n, 0.02)),
            f32(np.zeros(n)), f32(rays))
    kw = dict(iters=24, near=0.1, far=0.5, plate_hx=float(SOCKET_PLATE_HX),
              plate_hy=float(SOCKET_PLATE_HY), tip_radius=0.012,
              hand_radius=0.004)
    if proxy:
        # the plug's centre in the camera frame (of the untilted frames: the flip is its own inverse)
        centre = o_plug * np.array([-1.0, 1.0, 1.0]) - np.array([0.0, 0.0, 1.0]) * length[:, None] / 2
        # a capsule 6 cm long, 15 cm from the camera, across half of the plug's section
        mid = np.stack([centre[:, 0], centre[:, 1] + phy, np.full(n, 0.15)], -1)
        kw.update(tips_cam=f32(np.stack([centre + np.array([0.02, 0.02, -0.08]),
                                         np.tile([0.0, 0.0, -0.05], (n, 1)),      # wholly behind
                                         centre + np.array([-0.03, 0.02, -0.03])], 1)),
                  wrist_cam=f32(mid - np.array([0.03, 0.0, 0.0])), hand_cam=f32(mid + np.array([0.03, 0.0, 0.0])))
    return args, kw
