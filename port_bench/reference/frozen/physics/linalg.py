"""Small SPD solves, batched (port of `wtw_tpu/physics/linalg.py:17`).

A right-looking Cholesky over the static matrix size with every step a
(batch,)-wide tensor op, the diagonal stored inverted so every divide is a
multiply — the same form kernel B uses per thread."""
from __future__ import annotations

import torch


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A: (B, n, n), b: (B, n) -> (B, n)."""
    n = A.shape[-1]
    A = A.clone()
    L = torch.zeros_like(A)
    dinv = []
    for k in range(n):
        dk = torch.rsqrt(A[:, k, k])
        col = A[:, k + 1:, k] * dk[:, None]
        L[:, k + 1:, k] = col
        A[:, k + 1:, k + 1:] -= col[:, :, None] * col[:, None, :]
        dinv.append(dk)
    # forward substitution L y = b
    y = []
    for k in range(n):
        acc = b[:, k]
        if k:
            acc = acc - (L[:, k, :k] * torch.stack(y, dim=-1)).sum(-1)
        y.append(acc * dinv[k])
    # back substitution L^T x = y
    x = [None] * n
    for k in range(n - 1, -1, -1):
        acc = y[k]
        if k < n - 1:
            acc = acc - (L[:, k + 1:, k]
                         * torch.stack(x[k + 1:], dim=-1)).sum(-1)
        x[k] = acc * dinv[k]
    return torch.stack(x, dim=-1)
