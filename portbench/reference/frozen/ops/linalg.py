"""Batched small-matrix linear algebra (PyTorch).

A snapshot of the port's module, itself the port of `isaacgyminsertion_tpu/ops/linalg.py::chol_solve_small`: an unrolled
Cholesky solve for SPD [..., d, d] batches with d ≤ ~20 (the implicit-PD
mass-matrix solve, d = 15, and the IK damped-least-squares normal equations,
d = 6). No pivoting.

Every entry is computed with the reference's terms in the reference's order,
so the two packages agree term for term. The factorisation and the forward
substitution are written column by column (right-looking): each step updates
all remaining rows at once, and every row still subtracts its k-terms in
increasing k, exactly as the reference's row-by-row loops do. The backward
substitution keeps the reference's row form (increasing k within each row),
which is inherently sequential in the row index.
"""

from __future__ import annotations

import torch


def chol_solve_small(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve lhs @ x = rhs for SPD lhs [..., d, d], rhs [..., d]."""
    d = lhs.shape[-1]
    batch_shape = lhs.shape[:-2]
    A = lhs.reshape((-1, d, d))
    b = rhs.reshape((-1, d))

    # Right-looking factorisation: after column i, the trailing block holds
    # A[j, m] - Σ_{k≤i} L[j][k]·L[m][k], accumulated in increasing k.
    cols = []      # cols[i]: L[i:, i] as [N, d - i]
    inv_diag = []
    trail = A
    for i in range(d):
        Lii = torch.sqrt(trail[:, 0, 0])
        inv = 1.0 / Lii
        below = trail[:, 1:, 0] * inv[:, None]           # L[j][i], j > i
        cols.append(torch.cat([Lii[:, None], below], dim=1))
        inv_diag.append(inv)
        if i + 1 < d:
            trail = trail[:, 1:, 1:] - below[:, :, None] * below[:, None, :]

    # forward substitution L y = b (column form, increasing k per row)
    y = []
    rest = b
    for i in range(d):
        yi = rest[:, 0] * inv_diag[i]
        y.append(yi)
        if i + 1 < d:
            rest = rest[:, 1:] - cols[i][:, 1:] * yi[:, None]

    # backward substitution Lᵀ x = y (row form, increasing k per row)
    x = [None] * d
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - cols[i][:, k - i] * x[k]
        x[i] = s * inv_diag[i]

    return torch.stack(x, dim=-1).reshape(batch_shape + (d,))
