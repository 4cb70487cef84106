"""Velocity-level contact impulse solver, Jacobi + mass-splitting (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/physics/solver.py`. All contacts of the one
free plug body per env are solved simultaneously per iteration (Jacobi with
mass-splitting: each contact sees the body mass divided by the active-contact
weight sum) over fixed-shape [N, C] arrays.

Per contact:
  - rigid: inelastic normal impulse with Baumgarte bias (zero on the
    split-impulse path), accumulated-impulse projection λ_n ≥ 0;
  - soft (gel pads, stiffness > 0): an impulse-clamped spring-damper;
  - Coulomb friction with the rotational tangential effective mass, clamped
    to the cone |λ_t| ≤ μ λ_n.

`solve_contacts(beta=0)` followed by `position_correction` is the plain
version of the hand-written CUDA kernel in `solver_kernel.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ContactSet(NamedTuple):
    """All candidate contacts of the plug body, fixed shape [N, C, ...]."""

    r: torch.Tensor          # [N, C, 3] contact point − plug com (world)
    n: torch.Tensor          # [N, C, 3] unit normal pushing the plug OUT
    depth: torch.Tensor      # [N, C] penetration depth, > 0 ⇒ active
    v_other: torch.Tensor    # [N, C, 3] velocity of the other body at the contact
    mu: torch.Tensor         # [N, C] friction coefficient
    weight: torch.Tensor     # [N, C] pressure-prior weight
    stiffness: torch.Tensor  # [N, C] 0 = rigid; k > 0 caps the normal impulse at h·k·depth


class SolveResult(NamedTuple):
    v: torch.Tensor       # [N, 3] post-solve plug com linear velocity
    w: torch.Tensor       # [N, 3] post-solve angular velocity
    lam_n: torch.Tensor   # [N, C] normal impulses (N·s)
    lam_t: torch.Tensor   # [N, C, 3] friction impulses


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def solve_contacts(mass, I_inv_w, v, w, cs: ContactSet, h: float, iters: int = 16,
                   beta: float = 0.2, slop: float = 2.0e-4,
                   max_depenetration_velocity: float = 5.0) -> SolveResult:
    """Velocity solve. mass [N], I_inv_w [N, 3, 3], v/w [N, 3]."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    active = (cs.depth > 0.0).to(v.dtype) * cs.weight
    n_active = torch.clamp_min(torch.sum(active, dim=-1, keepdim=True), 1.0)
    bias = torch.clamp(beta / h * torch.maximum(cs.depth - slop, zero), 0.0,
                       max_depenetration_velocity)
    inv_m = (1.0 / mass)[..., None]
    mass_b = mass[..., None]
    m_eff_n = active * mass[..., None] / n_active

    # soft (gel) contacts: constant parts of the impulse-clamped spring-damper
    #   spring impulse ≤ 0.25·m_eff·depth/h, damping coeff ≤ 0.5·m_eff/h
    d_pos = torch.maximum(cs.depth, zero)
    spring_imp = torch.minimum(h * cs.stiffness * d_pos, 0.25 * m_eff_n * d_pos / h)
    c_imp = torch.minimum(0.5 * torch.sqrt(cs.stiffness * mass_b) * h, 0.5 * m_eff_n)
    soft_on = (cs.depth > 0.0).to(v.dtype)
    is_soft = cs.stiffness > 0.0

    lam_n = torch.zeros_like(cs.depth)
    lam_t = torch.zeros_like(cs.r)
    for _ in range(iters):
        v_c = v[..., None, :] + torch.linalg.cross(w[..., None, :].expand_as(cs.r), cs.r) - cs.v_other
        v_n = _dot(cs.n, v_c)
        lam_rigid = torch.maximum(lam_n + (bias - v_n) * m_eff_n, zero)
        lam_soft = torch.maximum(spring_imp - c_imp * v_n, zero) * soft_on
        lam_n_new = torch.where(is_soft, lam_soft, lam_rigid)
        dlam = lam_n_new - lam_n

        imp = cs.n * dlam[..., None]
        v = v + torch.sum(imp, dim=-2) * inv_m
        w = w + _mv(I_inv_w, torch.sum(torch.linalg.cross(cs.r, imp), dim=-2))

        # friction pass (relative velocity after the normal pass)
        v_c = v[..., None, :] + torch.linalg.cross(w[..., None, :].expand_as(cs.r), cs.r) - cs.v_other
        v_t = v_c - _dot(cs.n, v_c)[..., None] * cs.n
        vt_mag = torch.sqrt(torch.sum(v_t * v_t, dim=-1, keepdim=True) + 1e-16)
        u = torch.linalg.cross(cs.r, v_t / vt_mag)
        ang = _dot(u, u @ I_inv_w.transpose(-1, -2))     # uᵀ I⁻¹ u per contact
        m_eff_t = (active / (n_active * (1.0 / mass_b + ang)))[..., None]
        lam_t_new = lam_t - v_t * m_eff_t
        lt_mag = torch.linalg.norm(lam_t_new, dim=-1, keepdim=True)
        lt_max = (cs.mu * lam_n_new)[..., None]
        scale = torch.clamp_max(lt_max / torch.clamp_min(lt_mag, 1e-12), 1.0)
        lam_t_new = lam_t_new * scale
        dlam_t = lam_t_new - lam_t

        v = v + torch.sum(dlam_t, dim=-2) * inv_m
        w = w + _mv(I_inv_w, torch.sum(torch.linalg.cross(cs.r, dlam_t), dim=-2))
        lam_n, lam_t = lam_n_new, lam_t_new
    return SolveResult(v=v, w=w, lam_n=lam_n, lam_t=lam_t)


def position_correction(mass, I_inv_w, cs: ContactSet, iters: int = 8, beta: float = 0.3,
                        slop: float = 2.0e-4, max_corr: float = 0.01):
    """Split-impulse positional depenetration over rigid contacts → (Δcom, Δθ)."""
    zero = torch.zeros((), dtype=mass.dtype, device=mass.device)
    active = ((cs.depth > 0.0) & (cs.stiffness == 0.0)).to(mass.dtype) * cs.weight
    n_active = torch.clamp_min(torch.sum(active, dim=-1, keepdim=True), 1.0)
    inv_m = (1.0 / mass)[..., None]
    m_eff = active * mass[..., None] / n_active

    dx = torch.zeros(mass.shape + (3,), dtype=mass.dtype, device=mass.device)
    dth = torch.zeros_like(dx)
    lam = torch.zeros_like(cs.depth)
    for _ in range(iters):
        move = dx[..., None, :] + torch.linalg.cross(dth[..., None, :].expand_as(cs.r), cs.r)
        depth_cur = cs.depth - _dot(cs.n, move)
        corr = torch.clamp(beta * torch.maximum(depth_cur - slop, zero), 0.0, max_corr)
        lam_new = torch.maximum(lam + corr * m_eff, zero)
        imp = cs.n * (lam_new - lam)[..., None]
        dx = dx + torch.sum(imp, dim=-2) * inv_m
        dth = dth + _mv(I_inv_w, torch.sum(torch.linalg.cross(cs.r, imp), dim=-2))
        lam = lam_new
    return dx, dth
