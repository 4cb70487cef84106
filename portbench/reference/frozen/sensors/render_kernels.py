"""The ray-cast renderers in plain PyTorch: the tactile gel images and the
external camera's (t, d_min, component) planes, on every device, from the
packed rows that the program's wrappers build. The program runs the same
arithmetic as two hand-written CUDA kernels on the card.
"""

from __future__ import annotations

import torch

from ..assets import SOCKET_PLATE_HX, SOCKET_PLATE_HY
from ..ops import sdf as sdfm
from . import raycast as rc

TACTILE_ROW = 43   # floats per (env, finger) row, layout in csrc/tactile_render.cu
CAMERA_ROW = 98    # floats per env row, layout in csrc/camera_render.cu
NOISE_KINDS = {"gauss": 1, "ih4": 2}

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


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox-4x32 with 10 rounds (Salmon et al. 2011) on int64 tensors that
    hold unsigned 32-bit words: the counter-based generator the tactile
    kernel draws its noise from. A 32 × 32-bit product wraps in int64 with
    the bits of the unsigned one, so its halves come out by shift and mask."""
    for _ in range(10):
        p0, p1 = c0 * _PHILOX_M[0], c2 * _PHILOX_M[1]
        c0, c1, c2, c3 = ((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32, ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def _u24(w):
    """Uniform in [0, 1) from the top 24 bits of a word."""
    return (w >> 8).to(torch.float32) * 5.9604644775390625e-8


def tactile_noise(kind: str, seed, rows: int, pixels: int, device, chunk: int = 1024):
    """The kernel's unit noise [R, P, 3] under a launch's 64-bit `seed`: the
    words of Philox counter (pixel, row, draw, 0) under key (seed's low and
    high halves); "gauss" is Box-Muller on one draw, "ih4" the recentred sum
    of four uniforms of draw c for channel c."""
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    pix = torch.arange(pixels, dtype=torch.int64, device=device)[None, :]
    out = []
    for r0 in range(0, rows, chunk):
        row = torch.arange(r0, min(rows, r0 + chunk), dtype=torch.int64, device=device)[:, None]
        zero = torch.zeros_like(row * pix)
        c0, c1 = pix + zero, row + zero
        if kind == "gauss":
            x, y, z, w = philox4x32_10(c0, c1, zero, zero, k0, k1)
            rad1 = torch.sqrt(torch.clamp(-2.0 * torch.log(_u24(x) + 1e-7), min=0.0))
            rad2 = torch.sqrt(torch.clamp(-2.0 * torch.log(_u24(z) + 1e-7), min=0.0))
            ang = 6.283185307179586 * _u24(y)
            g = [rad1 * torch.cos(ang), rad1 * torch.sin(ang), rad2 * torch.cos(6.283185307179586 * _u24(w))]
        else:
            g = []
            for c in range(3):
                words = philox4x32_10(c0, c1, zero + c, zero, k0, k1)
                g.append((sum(_u24(v) for v in words) - 2.0) * 1.7320508075688772)
        out.append(torch.stack(g, dim=-1))
    return torch.cat(out)


def tactile_rows_plain(scal, rays, mask, *, iters: int, max_range: float, max_deformation: float,
                       force_range: float, t0: float = 1e-3, exact: bool = True, generator=None,
                       noise_std: float = 0.0, glow: float = 0.0, noise_kind: str = "gauss"):
    """Plain PyTorch version on packed rows (runs on any device): scal
    [R, TACTILE_ROW], rays [3, P], mask [P] → RGB [R, P, 3]. Its noise is the
    kernel's: one 64-bit seed drawn from `generator`, then Philox noise
    counted by (pixel, row, draw)."""
    planes = _tactile_planes(scal, rays, mask, exact=exact, iters=iters, max_range=max_range,
                             max_deformation=max_deformation, force_range=force_range, t0=t0,
                             glow=glow)
    img = torch.stack(planes, dim=-1)
    kind = _noise_kind(noise_kind, noise_std, generator)
    if kind is not None:
        seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64, generator=generator, device=img.device)
        img = img + noise_std * tactile_noise(kind, seed, img.shape[0], img.shape[1], img.device)
    return torch.clamp(img, 0.0, 1.0)


def tactile_render_plain(M, o, kind_onehot, hx, hy, length, force, rays_c, *, mask_flat=None, **kw):
    """Plain PyTorch version of `tactile_render` (runs on any device)."""
    return tactile_rows_plain(*tactile_rows(M, o, kind_onehot, hx, hy, length, force, rays_c,
                                             mask_flat), **kw)


def tactile_render(M, o, kind_onehot, hx, hy, length, force, rays_c, **kw):
    """Final RGB gel images [R, P, 3], plain, on every device (keywords as
    `tactile_rows_plain`)."""
    return tactile_render_plain(M, o, kind_onehot, hx, hy, length, force, rays_c, **kw)


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


def camera_render_plain(*args, tips_cam=None, wrist_cam=None, hand_cam=None, **kw):
    """Plain PyTorch version of `camera_render` (runs on any device)."""
    return camera_rows_plain(*camera_rows(*args, tips_cam, wrist_cam, hand_cam), **kw)


def camera_render(M_plug, *args, **kw):
    """(t_hit, d_min, comp) planes [N, P], plain, on every device (arguments
    as `camera_rows`, keywords as `camera_rows_plain`)."""
    return camera_render_plain(M_plug, *args, **kw)
