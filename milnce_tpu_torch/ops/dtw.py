"""Hard (exact) DTW with path backtracking — an eval-only utility (port of
``milnce_tpu/ops/dtw.py``; on no training path, so plain PyTorch).

:func:`dtw_table` runs the min recurrence over the anti-diagonals of the
cost skewed to diagonal-major layout (``ops/softdtw.py::skew_cost``), as
the JAX ``lax.scan`` does; :func:`dtw_path` backtracks all pairs of the
batch together.

Loss semantics (reference dtw.py:73-75): with the optimal path P,
``logsumexp_j(sum_i cost*P) - logsumexp_j(sum_i cost)``; the path is
detached, so gradients flow through the cost only.
"""

from __future__ import annotations

import torch

from milnce_tpu_torch.ops.softdtw import BIG, _cosine_sim, skew_cost


def dtw_table(cost: torch.Tensor) -> torch.Tensor:
    """(B, N, M) cost -> (B, N, M) accumulated-cost table
    ``tc[i,j] = cost[i,j] + min(tc[i-1,j-1], tc[i-1,j], tc[i,j-1])``."""
    bsz, n, m = cost.shape
    d_skew = skew_cost(cost)                          # (B, N+M-1, N)
    i_buf = torch.arange(n + 1, device=cost.device)
    r_mm = torch.full((bsz, n + 1), BIG, dtype=cost.dtype, device=cost.device)
    r_mm[:, 0] = 0.0
    r_m = torch.full_like(r_mm, BIG)
    border = torch.full((bsz, 1), BIG, dtype=cost.dtype, device=cost.device)
    diags = []
    for p in range(2, n + m + 1):
        best = torch.minimum(torch.minimum(r_mm[:, :-1], r_m[:, :-1]),
                             r_m[:, 1:])
        r_new = torch.cat([border, d_skew[:, p - 2] + best], dim=1)
        j_buf = p - i_buf
        valid = (i_buf >= 1) & (j_buf >= 1) & (j_buf <= m)
        r_new = torch.where(valid[None], r_new, BIG)
        r_mm, r_m = r_m, r_new
        diags.append(r_new)
    # un-skew: tc[i, j] lives at diagonal i + j, buffer row i + 1
    diags = torch.stack(diags, dim=1)                 # (B, N+M-1, N+1)
    i_idx = torch.arange(n, device=cost.device)[:, None]
    j_idx = torch.arange(m, device=cost.device)[None, :]
    return diags[:, i_idx + j_idx, i_idx + 1]


def dtw_path(cost: torch.Tensor) -> torch.Tensor:
    """The optimal alignment path as a (B, N, M) 0/1 mask (reference
    dtw.py:56-72): backtrack from (N-1, M-1), stop at the first border
    hit, always mark (0, 0).  The predecessor is the argmin of the three
    (diagonal first on ties, then up, then left — the reference's check
    order), the same path as the reference's exact-equality test in exact
    arithmetic and robust in float32, as in the JAX version."""
    tc = dtw_table(cost)
    bsz, n, m = cost.shape
    rows = torch.arange(bsz, device=cost.device)
    path = torch.zeros_like(cost)
    path[:, n - 1, m - 1] = 1.0
    i = torch.full((bsz,), n - 1, dtype=torch.long, device=cost.device)
    j = torch.full((bsz,), m - 1, dtype=torch.long, device=cost.device)
    stopped = torch.zeros(bsz, dtype=torch.bool, device=cost.device)
    for _ in range(n + m):
        stalled = (i == 0) | (j == 0)
        im, jm = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        p_diag = tc[rows, im, jm]
        p_up = tc[rows, im, j]
        p_left = tc[rows, i, jm]
        best = torch.minimum(torch.minimum(p_diag, p_up), p_left)
        take_diag = p_diag == best
        take_up = ~take_diag & (p_up == best)
        ni = torch.where(take_diag | take_up, i - 1, i)
        nj = torch.where(take_diag, j - 1, torch.where(take_up, j, j - 1))
        move = ~(stopped | stalled)
        i = torch.where(move, ni, i)
        j = torch.where(move, nj, j)
        path[rows[move], i[move], j[move]] = 1.0
        stopped = stopped | stalled
    path[:, 0, 0] = 1.0
    return path


def dtw_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reference ``DTW.forward`` (dtw.py:22-75) on cosine distance:
    x (B, N, D), y (B, M, D) -> (B,)."""
    cost = 1.0 - _cosine_sim(x, y, 1e-8)
    with torch.no_grad():
        path = dtw_path(cost)
    pos = torch.logsumexp((cost * path).sum(dim=1), dim=1)
    neg = torch.logsumexp(cost.sum(dim=1), dim=1)
    return pos - neg
