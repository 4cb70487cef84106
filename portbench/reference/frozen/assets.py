"""Host-side asset pipeline: subassembly geometry as packed parametric arrays.

A snapshot of the port's module, itself a copy of `isaacgyminsertion_tpu/assets.py` built without jax (the tests hold
the two tables equal): the section boundaries are found by bisection on the
port's own torch SDFs, evaluated in float32 on the CPU as the reference
evaluates its SDFs.

The reference loads 116 .obj meshes + 43 URDFs through IsaacGym/trimesh
(factory_env_insertion.py:541-607, asset yaml
assets/factory/yaml/factory_asset_info_insertion.yaml). Every peg/hole family
is a parametric solid, so mesh assets are replaced with an analytic shape
table: one row per subassembly holding the SDF kind + dimensions. Mixed
subassemblies across the env batch become *data* (gathered rows), not separate
code paths.

Numeric dimensions reproduce factory_asset_info_insertion.yaml (diameter/width/
depth/length/height/density/friction/scale per part) and
factory_asset_info_kuka_table.yaml (finger length 0.028, table dims).

Conventions (match ops/sdf.py canonical frames):
  - plug frame: base center at origin, +z up, length along z.
  - socket frame: plate base center at origin, +z up, plate height along z,
    through-hole on the z axis.
  - "hx, hy" are cross-section half-extents; for circles hx=hy=radius, for a
    hexagon hx = apothem (width = across-flats = 2*hx).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.sdf import (
    KIND_BOX,
    KIND_CIRCLE,
    KIND_ELLIPSE,
    KIND_HEXAGON,
    KIND_TRAPEZOID,
    KIND_TRIANGLE,
    NUM_KINDS,
)

TABLE_HEIGHT = 0.001          # FactoryBaseTactile.yaml:41
TABLE_FRICTION = 0.3          # FactoryBaseTactile.yaml:43
KUKA_FRICTION = 1.0           # FactoryBaseTactile.yaml:42
OPENHAND_FINGER_LENGTH = 0.028  # factory_asset_info_kuka_table.yaml
PLUG_FRICTION = 0.99          # FactoryEnvInsertionTactile.yaml env.plug_friction
SOCKET_BASE_HEIGHT = 0.003    # FactoryTaskInsertionTactile.yaml env.socket_base_height

# Socket plate half-extents: the reference's hole parts are small plates
# (round_hole_2in commented width 0.1016 x 0.09144); use that footprint.
SOCKET_PLATE_HX = 0.0508
SOCKET_PLATE_HY = 0.04572


class Subassembly(NamedTuple):
    name: str
    kind: int
    # plug
    plug_hx: float
    plug_hy: float
    plug_length: float
    plug_density: float
    plug_scale: float
    # socket hole
    hole_hx: float
    hole_hy: float
    socket_height: float
    friction: float


def _round(name, plug_d, length, density, scale, hole_d, height):
    return Subassembly(name, KIND_CIRCLE, plug_d / 2, plug_d / 2, length, density,
                       scale, hole_d / 2, hole_d / 2, height, 0.5)


def _sub(name, kind, w, d, length, density, scale, hw, hd, height):
    return Subassembly(name, kind, w / 2, d / 2, length, density, scale,
                       hw / 2, hd / 2, height, 0.5)


# Rows transcribed from assets/factory/yaml/factory_asset_info_insertion.yaml.
SUBASSEMBLIES: dict[str, Subassembly] = {
    s.name: s
    for s in [
        _round("round_peg_hole_16mm_loose", 0.015983, 0.0762, 8000.0, 1.2, 0.0165, 0.0089916),
        _sub("rectangular_peg_hole_32mm_loose", KIND_BOX, 0.031914, 0.01982, 0.0762, 8000.0, 1.2,
             0.0324364, 0.0203152, 0.0089916),
        _sub("square_peg_hole_32mm_loose", KIND_BOX, 0.031914, 0.02973, 0.0762, 8000.0, 1.085,
             0.0324364, 0.0304728, 0.0089916),
        _sub("rectangular_peg_hole_16mm_loose", KIND_BOX, 0.015957, 0.009910, 0.0762, 8000.0, 1.2,
             0.0162182, 0.0101576, 0.0089916),
        _round("yellow_round_peg_2in", 0.0508, 0.0762, 500.0, 1.04, 0.05105, 0.01),
        _round("red_round_peg_1_5in", 0.0381, 0.0762, 2000.0, 1.1, 0.0391, 0.01),
        _sub("triangle", KIND_TRIANGLE, 0.06391, 0.05535, 0.0762, 500.0, 1.1, 0.06599, 0.05715, 0.01),
        _sub("small_triangle", KIND_TRIANGLE, 0.04793, 0.04151, 0.0762, 2000.0, 1.17, 0.04949, 0.04286, 0.01),
        _sub("ellipse", KIND_ELLIPSE, 0.035, 0.05, 0.0762, 2000.0, 1.1, 0.03511, 0.0511, 0.01),
        _sub("hexagon", KIND_HEXAGON, 0.03464, 0.04, 0.0762, 2000.0, 1.1, 0.03574, 0.0411, 0.01),
        _sub("trapez", KIND_TRAPEZOID, 0.03, 0.06, 0.0762, 2000.0, 1.1, 0.0311, 0.0611, 0.01),
    ]
}

# FactoryEnvInsertionTactile.yaml env.desired_subassemblies (active set)
DESIRED_SUBASSEMBLIES = [
    "hexagon",
    "ellipse",
    "trapez",
    "small_triangle",
    "red_round_peg_1_5in",
    "yellow_round_peg_2in",
    "square_peg_hole_32mm_loose",
]


class SubassemblySet(NamedTuple):
    """Packed per-subassembly shape table [n_sub, ...] (numpy)."""

    names: tuple
    kind_onehot: np.ndarray    # [n_sub, NUM_KINDS]
    plug_hx: np.ndarray        # [n_sub]
    plug_hy: np.ndarray
    plug_length: np.ndarray
    plug_mass: np.ndarray      # [n_sub] nominal (density * analytic volume)
    plug_inertia: np.ndarray   # [n_sub, 3] com-frame diagonal inertia (canonical)
    plug_com_z: np.ndarray     # [n_sub] com height above plug base
    hole_hx: np.ndarray
    hole_hy: np.ndarray
    socket_height: np.ndarray
    friction: np.ndarray
    # yaml `scale` column: the reference applies it to the plug mesh in the
    # tactile gel scene (factory_env_insertion.py:1045-1052 → AllSightRenderer
    # scale=fix_scale); the sim actor itself is loaded unscaled.
    plug_scale: np.ndarray     # [n_sub]
    surface_points: np.ndarray  # [n_sub, P, 3] plug-frame contact sample points
    surface_weights: np.ndarray  # [n_sub, P] contact pressure-prior weights
    # dense surface samples for pcl / extrinsic-contact GT ([n_sub, P2, 3])
    dense_points: np.ndarray


def _section_area_and_gyration(kind, hx, hy):
    """Analytic cross-section area and second moments (about centroid axes)."""
    if kind == KIND_CIRCLE:
        a = np.pi * hx * hx
        ix = iy = np.pi * hx**4 / 4
    elif kind == KIND_BOX:
        a = 4 * hx * hy
        ix = (2 * hx) * (2 * hy) ** 3 / 12
        iy = (2 * hy) * (2 * hx) ** 3 / 12
    elif kind == KIND_HEXAGON:
        # regular hexagon with apothem hx: side s = 2*hx/sqrt(3)
        s = 2 * hx / np.sqrt(3)
        a = 3 * np.sqrt(3) / 2 * s * s
        ix = iy = 5 * np.sqrt(3) / 16 * s**4
    elif kind == KIND_ELLIPSE:
        a = np.pi * hx * hy
        ix = np.pi * hx * hy**3 / 4
        iy = np.pi * hy * hx**3 / 4
    elif kind == KIND_TRAPEZOID:
        from .ops.sdf import TRAPEZOID_TOP_RATIO

        b, t, h = 2 * hx, 2 * TRAPEZOID_TOP_RATIO * hx, 2 * hy
        a = 0.5 * (b + t) * h
        ix = h**3 * (b * b + 4 * b * t + t * t) / (36 * (b + t))
        # exact about the symmetry axis: Iy = ∫(2/3)w(y)^3 dy with w linear
        # b/2→t/2 gives h(b^4-t^4)/(48(b-t)) = h(b+t)(b^2+t^2)/48
        iy = h * (b + t) * (b * b + t * t) / 48
    else:  # triangle
        b, h = 2 * hx, 2 * hy
        a = 0.5 * b * h
        ix = b * h**3 / 36
        iy = h * b**3 / 48
    return a, ix, iy


def _section_boundary(kind, hx, hy, n):
    """n points on the 2D cross-section boundary via radial bisection on the SDF.

    All sections are star-shaped about the origin, so for each direction the
    SDF has a single radial zero crossing.
    """
    from .ops import sdf as sdfm

    fn = sdfm.SECTION_FNS[kind]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1)
    lo = np.zeros(n)
    hi = np.full(n, 4.0 * max(hx, hy))
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        d = fn(f32(dirs * mid[:, None]), f32(hx), f32(hy)).numpy()
        inside = d < 0
        lo = np.where(inside, mid, lo)
        hi = np.where(inside, hi, mid)
    r = 0.5 * (lo + hi)
    return dirs * r[:, None]


def _balanced_weights(p2: np.ndarray) -> np.ndarray:
    """Per-point weights (mean 1) with the weighted 2D centroid at the origin.

    Start from arc-length/area-uniform weights w0=1 and solve the closest
    (least-squares) w s.t. Σw_i p_i = 0, Σw_i = n — removes the spurious
    contact torque that uniform weights exert on sections whose sampled-point
    mean is off the extrusion axis (triangle/trapezoid), which otherwise tips
    a flat-resting plug (solver.py uses these as impulse mass-splitting
    weights, i.e. a pressure-distribution prior).
    """
    n = p2.shape[0]
    A = np.concatenate([p2.T, np.ones((1, n))], 0)  # [3, n]
    b = np.array([0.0, 0.0, float(n)])
    w0 = np.ones(n)
    # w = w0 + Aᵀ λ with A w = b
    lam = np.linalg.lstsq(A @ A.T, b - A @ w0, rcond=None)[0]
    w = w0 + A.T @ lam
    return np.clip(w, 0.05, None)


# Static point-set split for contact generation (engine.py): the socket can
# only touch the plug's lower shaft (hole depth ≤ 10 mm ⇒ engagement zone
# z ≲ 35 mm even when tilted), and the table is hit by the bottom face or —
# when toppled — the upper shaft. Testing each against its relevant subset
# cuts the contact-solver problem size ~40%.
N_RING = 16
SOCKET_PT_COUNT = 3 * N_RING + 5 * N_RING + N_RING  # bottom rings + low shell + first high ring
TABLE_PT_IDX = np.concatenate(
    [np.arange(3 * N_RING), np.arange(8 * N_RING + 2 * N_RING, 13 * N_RING)]
).astype(np.int32)  # bottom rings + top 3 shell rings


def sample_plug_surface(kind, hx, hy, length, n_ring=16, n_levels=5, n_face=8):
    """Contact sample points + weights on the plug surface (canonical frame).

    Layout: bottom rim ring, bottom-face interior rings, lateral shell rings at
    z levels (incl. top rim). Deterministic so the arrays are static constants.
    Returns (points [P, 3], weights [P]).
    """
    boundary = _section_boundary(kind, hx, hy, n_ring)
    pts = []
    wts = []
    # bottom rim + bottom face (rim scaled inwards)
    for s in [1.0, 0.6, 0.25]:
        b = boundary * s
        pts.append(np.concatenate([b, np.zeros((n_ring, 1))], -1))
        wts.append(_balanced_weights(b))
    # lateral shell: dense near the base (socket engagement zone — the hole is
    # only ~9-10 mm deep, so a seated plug must have wall-contact points in
    # z ∈ (0, 10 mm)), sparser up the shaft
    z_low = [0.002, 0.0045, 0.007, 0.0095, 0.013]
    z_high = list(np.linspace(0.02, length, n_levels))
    for z in z_low + z_high:
        pts.append(np.concatenate([boundary, np.full((n_ring, 1), z)], -1))
        wts.append(_balanced_weights(boundary))
    return np.concatenate(pts, 0), np.concatenate(wts, 0)


def sample_plug_dense(kind, hx, hy, length, n_ring=25, n_levels=16):
    """Dense lateral+cap sampling used for pcl goals / extrinsic contact GT.

    Mirrors the reference's trimesh.sample of plug mesh surface points
    (factory_env_insertion.py:95-98) with a deterministic analytic pattern.
    """
    boundary = _section_boundary(kind, hx, hy, n_ring)
    pts = []
    for z in np.linspace(0.0, length, n_levels):
        pts.append(np.concatenate([boundary, np.full((n_ring, 1), z)], -1))
    return np.concatenate(pts, 0)  # [n_ring*n_levels, 3]


def build_subassembly_set(names=None) -> SubassemblySet:
    names = tuple(names if names is not None else DESIRED_SUBASSEMBLIES)
    rows = [SUBASSEMBLIES[n] for n in names]
    n = len(rows)
    kind_onehot = np.zeros((n, NUM_KINDS), np.float32)
    mass = np.zeros(n, np.float32)
    inertia = np.zeros((n, 3), np.float32)
    surf = []
    surf_w = []
    dense = []
    for i, r in enumerate(rows):
        kind_onehot[i, r.kind] = 1.0
        hx, hy, L = r.plug_hx, r.plug_hy, r.plug_length
        area, ix, iy = _section_area_and_gyration(r.kind, hx, hy)
        m = r.plug_density * area * L
        mass[i] = m
        # solid extrusion about its com (z at L/2)
        izz = r.plug_density * L * (ix + iy)
        ixx = r.plug_density * (L * ix + area * L**3 / 12)
        iyy = r.plug_density * (L * iy + area * L**3 / 12)
        inertia[i] = [ixx, iyy, izz]
        sp, sw = sample_plug_surface(r.kind, hx, hy, L)
        surf.append(sp)
        surf_w.append(sw)
        dense.append(sample_plug_dense(r.kind, hx, hy, L))
    return SubassemblySet(
        names=names,
        kind_onehot=kind_onehot,
        plug_hx=np.array([r.plug_hx for r in rows], np.float32),
        plug_hy=np.array([r.plug_hy for r in rows], np.float32),
        plug_length=np.array([r.plug_length for r in rows], np.float32),
        plug_mass=mass,
        plug_inertia=inertia,
        plug_com_z=np.array([r.plug_length / 2 for r in rows], np.float32),
        hole_hx=np.array([r.hole_hx for r in rows], np.float32),
        hole_hy=np.array([r.hole_hy for r in rows], np.float32),
        socket_height=np.array([r.socket_height for r in rows], np.float32),
        friction=np.array([r.friction for r in rows], np.float32),
        plug_scale=np.array([r.plug_scale for r in rows], np.float32),
        surface_points=np.stack(surf).astype(np.float32),
        surface_weights=np.stack(surf_w).astype(np.float32),
        dense_points=np.stack(dense).astype(np.float32),
    )
