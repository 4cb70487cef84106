"""The fused contact solve in plain PyTorch: the split-impulse velocity solve
(`solver.solve_contacts(beta=0)`) followed by the rigid-only positional
correction (`solver.position_correction`), on every device. The program
runs the same arithmetic as one hand-written CUDA kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .solver import ContactSet, position_correction, solve_contacts


class FusedSolveResult(NamedTuple):
    v: torch.Tensor       # [N, 3]
    w: torch.Tensor       # [N, 3]
    lam_n: torch.Tensor   # [N, C]
    lam_t: torch.Tensor   # [N, C, 3]
    dx: torch.Tensor      # [N, 3] positional correction of the com
    dth: torch.Tensor     # [N, 3] rotational correction


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


def solve_contacts_fused(mass, I_inv_w, v, w, cs: ContactSet, h: float, iters: int = 16,
                         pos_iters: int = 8, beta_pos: float = 0.3, slop: float = 2.0e-4,
                         max_corr: float = 0.01) -> FusedSolveResult:
    """Velocity solve + positional correction: the plain version on every device."""
    return solve_contacts_fused_plain(mass, I_inv_w, v, w, cs, h, iters=iters, pos_iters=pos_iters,
                                      beta_pos=beta_pos, slop=slop, max_corr=max_corr)
