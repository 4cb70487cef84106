"""Analytic signed-distance functions for every peg/hole family (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/ops/sdf.py`. Vector forms: points are
[..., 2] (sections) or [..., 3] (solids), shape parameters broadcast against
the point batch. Plane forms (`plane_*`, `*_planes`): the same functions on
separate coordinate planes, used by the renderers and the contact ground truth. Contact generation differentiates these functions for its
normals, so every norm is gradient-safe and every max/min/clip is written
with `torch.maximum`/`torch.minimum`, whose gradient splits evenly at ties as
the reference's does (`clamp` would not).

Canonical frames:
  - plug:   base center at origin, +z up, extruded over z in [0, length]
  - socket: plate base center at origin, +z up, plate over z in [0, height],
            hole through the full plate, centered on the z-axis.

Cross-section kinds: 0 circle, 1 box, 2 hexagon (apothem hx), 3 ellipse,
4 trapezoid (centroid-centered), 5 isosceles triangle (centroid-centered).
"""

from __future__ import annotations

import torch

NUM_KINDS = 6
KIND_CIRCLE, KIND_BOX, KIND_HEXAGON, KIND_ELLIPSE, KIND_TRAPEZOID, KIND_TRIANGLE = range(6)
TRAPEZOID_TOP_RATIO = 0.6


def _max(a, b):
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def _min(a, b):
    return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def _clip(x, lo, hi):
    return _min(_max(x, lo), hi)


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Norm with a well-defined (zero) gradient at x=0."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-18)


# ------------------------------------------------------------------ 2D sections


def sd_circle(p, hx, hy):
    del hy
    return _safe_norm(p) - hx


def sd_box2d(p, hx, hy):
    d = torch.abs(p) - torch.stack([hx, hy], dim=-1)
    return _safe_norm(_max(d, 0.0)) + _min(torch.maximum(d[..., 0], d[..., 1]), 0.0)


def sd_hexagon(p, hx, hy):
    """Regular hexagon, apothem hx (across-flats = 2*hx); hy ignored."""
    del hy
    kx, ky, kz = -0.8660254037844386, 0.5, 0.5773502691896258
    q = torch.abs(p)
    dot = kx * q[..., 0] + ky * q[..., 1]
    q = q - 2.0 * _min(dot, 0.0)[..., None] * torch.stack(
        [torch.full_like(dot, kx), torch.full_like(dot, ky)], dim=-1)
    qx = torch.minimum(torch.maximum(q[..., 0], -kz * hx), kz * hx)
    d = torch.stack([q[..., 0] - qx, q[..., 1] - hx], dim=-1)
    return _safe_norm(d) * torch.sign(q[..., 1] - hx)


def sd_ellipse(p, hx, hy):
    """Approximate ellipse SDF: d = k0*(k0-1)/k1 (exact on the axes)."""
    ab = torch.stack([hx, hy], dim=-1)
    k0 = _safe_norm(p / ab)
    k1 = _max(_safe_norm(p / (ab * ab)), 1e-9)
    return torch.where(k0 < 1e-6, -torch.minimum(hx, hy), k0 * (k0 - 1.0) / k1)


def _sd_segment(p, a, b):
    pa = p - a
    ba = b - a
    h = _clip(torch.sum(pa * ba, dim=-1) / _max(torch.sum(ba * ba, dim=-1), 1e-12), 0.0, 1.0)
    return _safe_norm(pa - ba * h[..., None])


def sd_trapezoid(p, hx, hy):
    """Isosceles trapezoid, centroid-centered: bottom half-width hx, top
    TRAPEZOID_TOP_RATIO*hx, height 2*hy."""
    r1, r2, he = hx, TRAPEZOID_TOP_RATIO * hx, hy
    px = torch.abs(p[..., 0])
    y_c = 2.0 * hy * (r1 + 2.0 * r2) / (3.0 * (r1 + r2)) - hy
    py = p[..., 1] + y_c
    k1 = torch.stack([r2, he], dim=-1)
    k2 = torch.stack([r2 - r1, 2.0 * he], dim=-1)
    pq = torch.stack([px, py], dim=-1)
    ca_x = px - torch.minimum(px, torch.where(py < 0.0, r1, r2))
    ca_y = torch.abs(py) - he
    ca = torch.stack([ca_x, ca_y], dim=-1)
    t = _clip(torch.sum((k1 - pq) * k2, dim=-1) / _max(torch.sum(k2 * k2, dim=-1), 1e-12),
              0.0, 1.0)
    cb = pq - k1 + k2 * t[..., None]
    s = torch.where((cb[..., 0] < 0.0) & (ca[..., 1] < 0.0), -1.0, 1.0).to(p.dtype)
    d2 = torch.minimum(torch.sum(ca * ca, dim=-1), torch.sum(cb * cb, dim=-1))
    return s * torch.sqrt(d2 + 1e-18)


def sd_triangle_iso(p, hx, hy):
    """Isosceles triangle, centroid-centered: base 2*hx, height 2*hy."""
    y0 = -2.0 * hy / 3.0
    a = torch.stack([-hx, y0], dim=-1)
    b = torch.stack([hx, y0], dim=-1)
    c = torch.stack([torch.zeros_like(hx), y0 + 2.0 * hy], dim=-1)
    d = torch.minimum(torch.minimum(_sd_segment(p, a, b), _sd_segment(p, b, c)),
                      _sd_segment(p, c, a))

    def edge(e0, e1):
        return (e1[..., 0] - e0[..., 0]) * (p[..., 1] - e0[..., 1]) - (
            e1[..., 1] - e0[..., 1]) * (p[..., 0] - e0[..., 0])

    inside = (edge(a, b) > 0) & (edge(b, c) > 0) & (edge(c, a) > 0)
    return torch.where(inside, -d, d)


SECTION_FNS = (sd_circle, sd_box2d, sd_hexagon, sd_ellipse, sd_trapezoid, sd_triangle_iso)


def section_sdf(p2, kind_onehot, hx, hy):
    """2D cross-section SDF blended by one-hot kind (mixed batches)."""
    ds = torch.stack([fn(p2, hx, hy) for fn in SECTION_FNS], dim=-1)
    return torch.sum(ds * kind_onehot, dim=-1)


# ------------------------------------------------------------------ 3D solids


def extrude(d2, z, half_len, z_center):
    """Extrude a 2D SDF over z in [z_center-half_len, z_center+half_len]."""
    wz = torch.abs(z - z_center) - half_len
    dx = _max(d2, 0.0)
    dz = _max(wz, 0.0)
    return torch.sqrt(dx * dx + dz * dz + 1e-18) + _min(torch.maximum(d2, wz), 0.0)


def plug_sdf(p, kind_onehot, hx, hy, length):
    """Plug solid SDF in the canonical plug frame (base at z=0, +z up)."""
    d2 = section_sdf(p[..., :2], kind_onehot, hx, hy)
    return extrude(d2, p[..., 2], 0.5 * length, 0.5 * length)


def socket_sdf(p, kind_onehot, hole_hx, hole_hy, height, plate_hx, plate_hy):
    """Socket = rectangular plate (z in [0, height]) minus a through-hole."""
    plate2 = sd_box2d(p[..., :2], plate_hx, plate_hy)
    plate = extrude(plate2, p[..., 2], 0.5 * height, 0.5 * height)
    hole2 = section_sdf(p[..., :2], kind_onehot, hole_hx, hole_hy)
    return torch.maximum(plate, -hole2)


def table_sdf(p, table_height):
    """Table top as a halfspace z >= table_height."""
    return p[..., 2] - table_height


# ------------------------------------------------------------------ plane forms
# The same SDF family on coordinate planes: px/py(/pz) are [..., P] planes and
# the shape scalars broadcast against them ([..., 1]). The ray-march variants
# of the renderers (sensors/render_kernels.py) evaluate these; the vector
# forms above are their oracle in the tests.


def _pnorm2(x, y):
    return torch.sqrt(x * x + y * y + 1e-18)


def plane_sd_circle(px, py, hx, hy):
    del hy
    return _pnorm2(px, py) - hx


def plane_sd_box2d(px, py, hx, hy):
    dx = torch.abs(px) - hx
    dy = torch.abs(py) - hy
    return _pnorm2(_max(dx, 0.0), _max(dy, 0.0)) + _min(torch.maximum(dx, dy), 0.0)


def plane_sd_hexagon(px, py, hx, hy):
    del hy
    kx, ky, kz = -0.8660254037844386, 0.5, 0.5773502691896258
    qx, qy = torch.abs(px), torch.abs(py)
    m = 2.0 * _min(kx * qx + ky * qy, 0.0)
    qx = qx - m * kx
    qy = qy - m * ky
    cx = torch.minimum(torch.maximum(qx, -kz * hx), kz * hx)
    return _pnorm2(qx - cx, qy - hx) * torch.sign(qy - hx)


def plane_sd_ellipse(px, py, hx, hy):
    ex, ey = px / hx, py / hy
    k0 = torch.sqrt(ex * ex + ey * ey + 1e-18)
    fx, fy = px / (hx * hx), py / (hy * hy)
    k1 = _max(torch.sqrt(fx * fx + fy * fy + 1e-18), 1e-9)
    return torch.where(k0 < 1e-6, -torch.minimum(hx, hy), k0 * (k0 - 1.0) / k1)


def plane_sd_trapezoid(px_in, py_in, hx, hy):
    r1, r2, he = hx, TRAPEZOID_TOP_RATIO * hx, hy
    px = torch.abs(px_in)
    y_c = 2.0 * hy * (r1 + 2.0 * r2) / (3.0 * (r1 + r2)) - hy
    py = py_in + y_c
    k1x, k1y = r2, he
    k2x, k2y = r2 - r1, 2.0 * he
    ca_x = px - torch.minimum(px, torch.where(py < 0.0, r1, r2))
    ca_y = torch.abs(py) - he
    k2n = _max(k2x * k2x + k2y * k2y, 1e-12)
    t = _clip(((k1x - px) * k2x + (k1y - py) * k2y) / k2n, 0.0, 1.0)
    cbx = px - k1x + k2x * t
    cby = py - k1y + k2y * t
    s = torch.where((cbx < 0.0) & (ca_y < 0.0), -1.0, 1.0).to(px.dtype)
    d2 = torch.minimum(ca_x * ca_x + ca_y * ca_y, cbx * cbx + cby * cby)
    return s * torch.sqrt(d2 + 1e-18)


def plane_sd_segment(px, py, ax, ay, bx, by):
    pax, pay = px - ax, py - ay
    bax, bay = bx - ax, by - ay
    h = _clip((pax * bax + pay * bay) / _max(bax * bax + bay * bay, 1e-12), 0.0, 1.0)
    return _pnorm2(pax - bax * h, pay - bay * h)


def plane_sd_triangle_iso(px, py, hx, hy):
    y0 = -2.0 * hy / 3.0
    ax, ay = -hx, y0
    bx, by = hx, y0
    cx, cy = torch.zeros_like(hx), y0 + 2.0 * hy
    d = torch.minimum(torch.minimum(plane_sd_segment(px, py, ax, ay, bx, by),
                                    plane_sd_segment(px, py, bx, by, cx, cy)),
                      plane_sd_segment(px, py, cx, cy, ax, ay))

    def edge(e0x, e0y, e1x, e1y):
        return (e1x - e0x) * (py - e0y) - (e1y - e0y) * (px - e0x)

    inside = ((edge(ax, ay, bx, by) > 0) & (edge(bx, by, cx, cy) > 0)
              & (edge(cx, cy, ax, ay) > 0))
    return torch.where(inside, -d, d)


PLANE_SECTION_FNS = (plane_sd_circle, plane_sd_box2d, plane_sd_hexagon, plane_sd_ellipse,
                     plane_sd_trapezoid, plane_sd_triangle_iso)


def section_sdf_planes(px, py, oh, hx, hy):
    """One-hot blend of the six section families; `oh` is a sequence of 6
    planes, each broadcastable against px/py."""
    d = None
    for k, fn in enumerate(PLANE_SECTION_FNS):
        dk = fn(px, py, hx, hy) * oh[k]
        d = dk if d is None else d + dk
    return d


def extrude_planes(d2, z, half_len, z_center):
    wz = torch.abs(z - z_center) - half_len
    dx = _max(d2, 0.0)
    dz = _max(wz, 0.0)
    return torch.sqrt(dx * dx + dz * dz + 1e-18) + _min(torch.maximum(d2, wz), 0.0)


def plug_sdf_planes(px, py, pz, oh, hx, hy, length):
    d2 = section_sdf_planes(px, py, oh, hx, hy)
    return extrude_planes(d2, pz, 0.5 * length, 0.5 * length)


def socket_sdf_planes(px, py, pz, oh, hole_hx, hole_hy, height, plate_hx: float, plate_hy: float):
    plate2 = plane_sd_box2d(px, py, torch.full_like(hole_hx, plate_hx),
                            torch.full_like(hole_hx, plate_hy))
    plate = extrude_planes(plate2, pz, 0.5 * height, 0.5 * height)
    hole2 = section_sdf_planes(px, py, oh, hole_hx, hole_hy)
    return torch.maximum(plate, -hole2)


def sdf_and_grad(sdf_fn, p: torch.Tensor, *args):
    """(distance, gradient wrt p) by reverse-mode autograd; works under
    `torch.no_grad` callers and returns tensors outside any graph."""
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        d = sdf_fn(q, *args)
        (g,) = torch.autograd.grad(d, q, torch.ones_like(d))
    return d.detach(), g


def sdf_normal(sdf_fn, p: torch.Tensor, *args) -> torch.Tensor:
    """Unit outward normal via the analytic gradient of the SDF."""
    g = sdf_and_grad(sdf_fn, p, *args)[1]
    return g / _max(torch.linalg.norm(g, dim=-1, keepdim=True), 1e-9)
