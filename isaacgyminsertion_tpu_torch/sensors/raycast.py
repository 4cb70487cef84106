"""Closed-form ray-scene intersection on the packed section (PyTorch).

Port of `isaacgyminsertion_tpu/sensors/raycast.py`, the part the fused
renderers use: every shape of the scene is analytic, so a ray's first hit is
an intersection of half-plane, slab and quadratic intervals. The plug is an
extruded convex cross-section, the socket a box plate minus a convex through
hole, the table a halfspace, the robot proxy spheres and a cylinder segment.

Every section family is {p : u_j·p ≤ c_j ∀j} ∩ {|(x/a, y/b)| ≤ 1}: at most
HP_SLOTS unit-normal halfplanes plus an optional axis-aligned quadratic
(`section_halfplanes`). Neutral slots are (0, 0, BIG): always satisfied.

Conventions: rays are given in each shape's local frame (origin o, unit
direction d); intervals are [t_lo, t_hi], t_lo > t_hi meaning "miss"; BIG
stands in for infinity (0·inf would be NaN).
"""

from __future__ import annotations

import torch

from ..ops.sdf import TRAPEZOID_TOP_RATIO

BIG = 1.0e9
EPS = 1.0e-9
HP_SLOTS = 6
_S3 = 0.8660254037844386


def _full(x, v):
    return torch.full_like(x, v)


def _halfplane_interval(no, nd, c):
    """t-interval of {t : no + nd·t ≤ c}, with no = n·o and nd = n·d.
    Branchless: nd > 0 bounds the exit, nd < 0 the entry, nd ≈ 0 always/never."""
    eps_s = torch.where(nd >= 0, _full(nd, EPS), _full(nd, -EPS))
    tc = (c - no) / torch.where(torch.abs(nd) < EPS, eps_s, nd)
    inside = no <= c
    big, nbig = _full(tc, BIG), _full(tc, -BIG)
    t_lo = torch.where(nd < -EPS, tc, torch.where(nd > EPS, nbig, torch.where(inside, nbig, big)))
    t_hi = torch.where(nd > EPS, tc, torch.where(nd < -EPS, big, torch.where(inside, big, nbig)))
    return t_lo, t_hi


def _slab_interval(o, d, lo, hi):
    """t-interval of {lo ≤ o + d·t ≤ hi} (1D slab)."""
    l1, h1 = _halfplane_interval(o, d, hi)        # o + d t ≤ hi
    l2, h2 = _halfplane_interval(-o, -d, -lo)     # o + d t ≥ lo
    return torch.maximum(l1, l2), torch.minimum(h1, h2)


def _quadratic_interval(a, b, c):
    """t-interval of {a t² + 2b t + c ≤ 0} with a > 0 (ellipse/circle)."""
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / torch.clamp_min(a, EPS)
    t_lo = (-b - sq) * inv_a
    t_hi = (-b + sq) * inv_a
    miss = disc <= 0.0
    return torch.where(miss, _full(t_lo, BIG), t_lo), torch.where(miss, _full(t_hi, -BIG), t_hi)


# ------------------------------------------------------------- packed section


def section_halfplanes(kind_onehot, hx, hy):
    """Pack per-env section constraints: (hp [..., HP_SLOTS, 3], quad [..., 3]).

    hp rows are (ux, uy, c) with |u| = 1 meaning u·p ≤ c; quad is
    (1/a, 1/b, active) meaning (x/a)² + (y/b)² ≤ 1 when active = 1.
    One-hot blended over the six families (exactly one contributes)."""
    z = torch.zeros_like(hx)
    one = torch.ones_like(hx)
    big = _full(hx, BIG)
    neutral = (z, z, big)

    def fam(rows, quad):
        rows = list(rows) + [neutral] * (HP_SLOTS - len(rows))
        hp = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
        return hp, torch.stack(quad, dim=-1)

    inv_x, inv_y = 1.0 / hx, 1.0 / hy
    circle = fam([], (inv_x, inv_x, one))
    ellipse = fam([], (inv_x, inv_y, one))
    box = fam([(one, z, hx), (-one, z, hx), (z, one, hy), (z, -one, hy)], (z, z, z))
    s3 = _full(hx, _S3)
    hexa = fam([(z, one, hx), (z, -one, hx), (s3, 0.5 * one, hx), (-s3, -0.5 * one, hx),
                (-s3, 0.5 * one, hx), (s3, -0.5 * one, hx)], (z, z, z))
    # triangle (sd_triangle_iso frame): base y ≥ y0, two side edges
    y0 = -2.0 * hy / 3.0
    li = 1.0 / torch.sqrt(4.0 * hy * hy + hx * hx)
    tri_rows = [(z, -one, -y0)]
    for sx in (1.0, -1.0):
        mx, my = sx * 2.0 * hy, hx
        cb = mx * (sx * hx) + my * y0
        tri_rows.append((mx * li, my * li, cb * li))
    tri = fam(tri_rows, (z, z, z))
    # trapezoid (sd_trapezoid frame shifted by the centroid y_c)
    r1, r2, he = hx, TRAPEZOID_TOP_RATIO * hx, hy
    y_c = 2.0 * hy * (r1 + 2.0 * r2) / (3.0 * (r1 + r2)) - hy
    ti = 1.0 / torch.sqrt(4.0 * he * he + (r1 - r2) ** 2)
    trap_rows = [(z, one, he - y_c), (z, -one, he + y_c)]
    for sx in (1.0, -1.0):
        mx, my = sx * 2.0 * he, r1 - r2
        cb = mx * (sx * r1) + my * (-he) - my * y_c  # back to the unshifted frame
        trap_rows.append((mx * ti, my * ti, cb * ti))
    trap = fam(trap_rows, (z, z, z))

    fams = (circle, box, hexa, ellipse, trap, tri)  # KIND_* order
    hp = sum(kind_onehot[..., k, None, None] * fams[k][0] for k in range(6))
    quad = sum(kind_onehot[..., k, None] * fams[k][1] for k in range(6))
    return hp, quad


def packed_interval_normal(ox, oy, dx, dy, hp, quad, want_normal=True):
    """Ray interval + entry normal of a packed section (broadcasting form).

    ox/oy/dx/dy: ray xy origin/direction; hp [..., HP_SLOTS, 3] and quad
    [..., 3] broadcastable against them. Returns (t_lo, t_hi[, nx, ny]); the
    normal is the binding entry constraint's outward direction (unit for
    halfplanes, the implicit gradient for the quadratic)."""
    t_lo = _full(dx, -BIG)
    t_hi = _full(dx, BIG)
    nx = torch.zeros_like(dx)
    ny = torch.zeros_like(dx)
    for j in range(HP_SLOTS):
        ux, uy, c = hp[..., j, 0], hp[..., j, 1], hp[..., j, 2]
        lo, hi = _halfplane_interval(ux * ox + uy * oy, ux * dx + uy * dy, c)
        if want_normal:
            dom = lo > t_lo
            nx = torch.where(dom, ux, nx)
            ny = torch.where(dom, uy, ny)
        t_lo = torch.maximum(t_lo, lo)
        t_hi = torch.minimum(t_hi, hi)
    ia, ib, act = quad[..., 0], quad[..., 1], quad[..., 2]
    qox, qoy, qdx, qdy = ox * ia, oy * ib, dx * ia, dy * ib
    a = torch.clamp_min(qdx * qdx + qdy * qdy, EPS)
    b = qox * qdx + qoy * qdy
    cc = qox * qox + qoy * qoy - 1.0
    q_lo, q_hi = _quadratic_interval(a, b, cc)
    q_lo = torch.where(act > 0.5, q_lo, _full(q_lo, -BIG))
    q_hi = torch.where(act > 0.5, q_hi, _full(q_hi, BIG))
    if want_normal:
        dom = q_lo > t_lo
        nx = torch.where(dom, (ox + dx * q_lo) * ia * ia, nx)
        ny = torch.where(dom, (oy + dy * q_lo) * ib * ib, ny)
    t_lo = torch.maximum(t_lo, q_lo)
    t_hi = torch.minimum(t_hi, q_hi)
    if want_normal:
        return t_lo, t_hi, nx, ny
    return t_lo, t_hi


def packed_inner_grad(px, py, hp, quad):
    """Signed distance + outward gradient at a point inside a packed section
    (shading of rays whose origin is already inside the prism). Unit halfplane
    normals make u·p − c a true distance; the quadratic uses the sd_ellipse
    approximation and its analytic gradient."""
    d = _full(px, -BIG)
    gx = torch.zeros_like(px)
    gy = torch.zeros_like(px)
    for j in range(HP_SLOTS):
        ux, uy, c = hp[..., j, 0], hp[..., j, 1], hp[..., j, 2]
        dk = ux * px + uy * py - c
        dom = dk > d
        gx = torch.where(dom, ux, gx)
        gy = torch.where(dom, uy, gy)
        d = torch.maximum(d, dk)
    ia, ib, act = quad[..., 0], quad[..., 1], quad[..., 2]
    rx, ry = px * ia * ia, py * ib * ib
    k0 = torch.sqrt((px * ia) ** 2 + (py * ib) ** 2 + 1e-18)
    k1 = torch.clamp_min(torch.sqrt(rx * rx + ry * ry), 1e-9)
    dq = k0 * (k0 - 1.0) / k1
    c1 = (2.0 * k0 - 1.0) / (torch.clamp_min(k0, 1e-9) * k1)
    c2 = k0 * (k0 - 1.0) / (k1 * k1 * k1)
    qgx = c1 * rx - c2 * rx * ia * ia
    qgy = c1 * ry - c2 * ry * ib * ib
    dq = torch.where(act > 0.5, dq, _full(dq, -BIG))
    dom = dq > d
    gx = torch.where(dom, qgx, gx)
    gy = torch.where(dom, qgy, gy)
    d = torch.maximum(d, dq)
    return d, gx, gy


# --------------------------------------------------------------------- solids


def plug_hit(ox, oy, oz, dx, dy, dz, hp, quad, length):
    """First-hit t of the plug prism (local frame, z ∈ [0, length]); BIG = miss.
    Ray origin and direction as coordinate planes; hp/quad: the packed section,
    broadcastable against them."""
    s_lo, s_hi = packed_interval_normal(ox, oy, dx, dy, hp, quad, want_normal=False)
    z_lo, z_hi = _slab_interval(oz, dz, torch.zeros_like(length), length)
    t_in = torch.clamp_min(torch.maximum(s_lo, z_lo), 0.0)
    t_out = torch.minimum(s_hi, z_hi)
    return torch.where(t_in <= t_out, t_in, _full(t_in, BIG))


def socket_hit(ox, oy, oz, dx, dy, dz, hp, quad, height, plate_hx: float, plate_hy: float):
    """First-hit t of plate-minus-hole (local frame, plate z ∈ [0, height]);
    hp/quad pack the hole's section. A ray that enters the plate outside the
    hole hits at its entry; one that enters inside the hole hits the hole
    wall where it leaves the hole prism, if still inside the plate (a through
    hole has no bottom of its own)."""
    hx_t, hy_t = _full(ox, plate_hx), _full(ox, plate_hy)
    px_lo, px_hi = _slab_interval(ox, dx, -hx_t, hx_t)
    py_lo, py_hi = _slab_interval(oy, dy, -hy_t, hy_t)
    pz_lo, pz_hi = _slab_interval(oz, dz, torch.zeros_like(height), height)
    a0 = torch.clamp_min(torch.maximum(torch.maximum(px_lo, py_lo), pz_lo), 0.0)
    a1 = torch.minimum(torch.minimum(px_hi, py_hi), pz_hi)
    h_lo, h_hi = packed_interval_normal(ox, oy, dx, dy, hp, quad, want_normal=False)
    entered_in_hole = (a0 >= h_lo - 1e-7) & (a0 <= h_hi + 1e-7)
    wall_t = torch.where(h_hi <= a1, h_hi, _full(h_hi, BIG))
    t = torch.where(entered_in_hole, wall_t, a0)
    return torch.where(a0 <= a1, t, _full(t, BIG))


def table_hit(o, d, table_h):
    """Halfspace z ≤ table_h seen from above: hit at z(t) = table_h."""
    dz = d[..., 2]
    t = (table_h - o[..., 2]) / torch.where(torch.abs(dz) < EPS, _full(dz, -EPS), dz)
    return torch.where((dz < -EPS) & (t > 0.0), t, _full(t, BIG))


def sphere_hit(o, d, center, radius):
    """First-hit t of a sphere (same frame as the ray)."""
    oc = o - center
    b = torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    return torch.where((disc > 0.0) & (t > 0.0), t, _full(t, BIG))


def capsule_hit(o, d, a, b, radius):
    """First-hit t of a capsule from a to b (infinite-cylinder clamp + caps)."""
    ab = b - a
    ab2 = torch.sum(ab * ab, dim=-1)
    oa = o - a
    ab_len = torch.sqrt(torch.clamp_min(ab2, EPS))
    d_par = torch.sum(d * ab, dim=-1) / ab_len
    o_par = torch.sum(oa * ab, dim=-1) / ab_len
    qa = torch.sum(d * d, dim=-1) - d_par * d_par
    qb = torch.sum(oa * d, dim=-1) - o_par * d_par
    qc = torch.sum(oa * oa, dim=-1) - o_par * o_par - radius * radius
    disc = qb * qb - qa * qc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_cyl = (-qb - sq) / torch.where(torch.abs(qa) < EPS, _full(qa, EPS), qa)
    # accept the cylinder hit only between the caps
    h = o_par + d_par * t_cyl
    on_seg = (h >= 0.0) & (h * h <= ab2)
    t_cyl = torch.where((disc > 0.0) & (t_cyl > 0.0) & on_seg, t_cyl, _full(t_cyl, BIG))
    return torch.minimum(t_cyl, torch.minimum(sphere_hit(o, d, a, radius),
                                              sphere_hit(o, d, b, radius)))
