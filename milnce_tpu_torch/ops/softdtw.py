"""Soft-DTW: the plain PyTorch recurrence, the cost functions and the
``SoftDTW`` front-end (port of ``milnce_tpu/ops/softdtw.py``).

:func:`softdtw_scan` is the plain version of the recurrence
``R[i, j] = D[i-1, j-1] + softmin_gamma(R[i-1, j-1], R[i-1, j], R[i, j-1])``:
a Python loop over the N + M - 1 anti-diagonals of the padded
(N+1) x (M+1) table, each step one vector op over (batch, diagonal) on the
cost pre-skewed to diagonal-major layout (:func:`skew_cost`), as the JAX
``lax.scan`` runs it.  It runs in the input's dtype and autograd
differentiates through it.  Borders and pruned cells hold the finite
sentinel ``BIG`` instead of +inf, so the gradient stays NaN-free; there
is no length cap.

``SoftDTW(backend=...)`` picks the recurrence: ``scan`` the plain one on
any device, ``cuda`` the hand-written kernels of ``ops/softdtw_cuda.py``
(CUDA tensors only; a CPU tensor raises), ``auto`` the kernels for CUDA
tensors and the plain recurrence for CPU tensors.
"""

from __future__ import annotations

import torch

from milnce_tpu_torch.config import SDTW_BACKENDS

# Finite stand-in for +inf.  Must dominate any real path cost (exp of a
# euclidean distance on raw d=512 features reaches ~1e13 per cell) and
# stay finite after the softmin's scaling by 1/gamma at gamma = 1e-5
# (BIG / gamma = 1e35 < f32 max).  The MIL-NCE stream masks padded logits
# with -BIG: exp(-BIG - m) is exactly 0 in f32 and, unlike -inf, never
# produces inf - inf = nan in a max/rescale.
BIG = 1e30


def skew_cost(D: torch.Tensor) -> torch.Tensor:
    """(B, N, M) cost -> diagonal-major (B, N+M-1, N) with
    ``out[:, p, i] = D[:, i, p - i]`` (0 where out of range)."""
    _, n, m = D.shape
    p_idx = torch.arange(n + m - 1, device=D.device)[:, None]
    i_idx = torch.arange(n, device=D.device)[None, :]
    j_idx = p_idx - i_idx
    valid = (j_idx >= 0) & (j_idx < m)
    gathered = D[:, i_idx, j_idx.clamp(0, m - 1)]
    return torch.where(valid, gathered, torch.zeros((), dtype=D.dtype,
                                                    device=D.device))


def max_sum3(n0, n1, n2):
    """``(mx, s)`` with ``exp(n0) + exp(n1) + exp(n2) = s * exp(mx)``:
    mx the largest, s the sum of ``exp(n - mx)``, in [1, 3]."""
    mx = torch.maximum(torch.maximum(n0, n1), n2)
    return mx, torch.exp(n0 - mx) + torch.exp(n1 - mx) + torch.exp(n2 - mx)


def softmin3(a, b, c, gamma):
    """-gamma * log(exp(-a/g) + exp(-b/g) + exp(-c/g)), stable, in the
    CUDA kernels' arithmetic (and the Pallas kernels'): scaled by 1/gamma,
    then :func:`max_sum3`, then ``log(s) + mx``."""
    inv_gamma = 1.0 / gamma
    mx, s = max_sum3(-a * inv_gamma, -b * inv_gamma, -c * inv_gamma)
    return -gamma * (torch.log(s) + mx)


def check_bandwidth(n: int, m: int, bandwidth: int) -> None:
    """A Sakoe-Chiba band narrower than |N - M| prunes the terminal DP
    cell: every value degenerates to the finite BIG sentinel and training
    silently flatlines (no NaN for the divergence guard to catch)."""
    if 0 < bandwidth < abs(n - m):
        raise ValueError(
            f"sdtw bandwidth {bandwidth} cannot cover the |N-M| = "
            f"{abs(n - m)} length difference of a {n}x{m} alignment — the "
            "terminal cell is outside the band and every soft-DTW value "
            "degenerates to the BIG sentinel")


def valid_cells(n_rows: int, n_cols: int, n: int, m: int, bandwidth: int,
                device) -> torch.Tensor:
    """(n_rows, n_cols) mask of the cells ``(i, p - i)`` of a skewed table
    that lie inside the N x M alignment and the band."""
    p = torch.arange(n_rows, device=device)[:, None]
    i = torch.arange(n_cols, device=device)[None, :]
    j = p - i
    ok = (i >= 1) & (i <= n) & (j >= 1) & (j <= m)
    if bandwidth > 0:                           # soft_dtw_cuda.py:66
        ok &= (i - j).abs() <= bandwidth
    return ok


def wavefront(D: torch.Tensor, gamma: float, bandwidth: int) -> list:
    """The forward recurrence: the N + M + 1 anti-diagonals ``R[:, p]``
    (each (B, N+1), indexed by padded row i) of the padded table, in the
    input's dtype."""
    bsz, n, m = D.shape
    check_bandwidth(n, m, bandwidth)
    d_skew = skew_cost(D)                       # (B, N+M-1, N)
    valid = valid_cells(n + m + 1, n + 1, n, m, bandwidth, D.device)
    big = torch.full((bsz, n + 1), BIG, dtype=D.dtype, device=D.device)
    diag0 = big.clone()
    diag0[:, 0] = 0.0
    diags = [diag0, big]
    for p in range(2, n + m + 1):
        r_mm, r_m = diags[-2], diags[-1]
        interior = d_skew[:, p - 2] + softmin3(r_mm[:, :-1], r_m[:, :-1],
                                               r_m[:, 1:], gamma)
        row = torch.cat([big[:, :1], interior], dim=1)
        diags.append(torch.where(valid[p], row, BIG))
    return diags


def softdtw_scan(D: torch.Tensor, gamma: float,
                 bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW values (B,) of a batch of cost matrices D (B, N, M), the
    plain recurrence; 0 ``bandwidth`` disables pruning.  The same value
    as the forward twin ``ops/softdtw_cuda.py::softdtw_fwd_plain``, which
    keeps the whole table."""
    return wavefront(D, gamma, bandwidth)[-1][:, D.shape[1]]


def euclidean_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """exp(L2 distance) per timestep pair (soft_dtw_cuda.py:325-335; the
    reference really exponentiates the distance)."""
    sq = ((x * x).sum(-1)[:, :, None] + (y * y).sum(-1)[:, None, :]
          - 2.0 * torch.einsum("bnd,bmd->bnm", x, y))
    # Grad-safe sqrt: d/ds sqrt(s) -> inf at s=0 (hit deterministically by
    # the xx/yy legs of normalize=True); pick subgradient 0 there without
    # changing the forward value.
    nonzero = sq > 0.0
    safe = torch.sqrt(torch.where(nonzero, sq, 1.0))
    return torch.exp(torch.where(nonzero, safe, 0.0))


def _cosine_sim(x, y, eps):
    # torch.cosine_similarity semantics: x.y / max(|x||y|, eps)
    num = torch.einsum("bnd,bmd->bnm", x, y)
    nx = torch.linalg.norm(x, dim=-1)[:, :, None]
    ny = torch.linalg.norm(y, dim=-1)[:, None, :]
    return num / torch.clamp(nx * ny, min=eps)


def cosine_cost(x: torch.Tensor, y: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """exp(1 - cosine_similarity) (soft_dtw_cuda.py:337-348)."""
    return torch.exp(1.0 - _cosine_sim(x, y, eps))


def negative_cosine_cost(x: torch.Tensor, y: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """-cosine_similarity (the reference names this option at
    soft_dtw_cuda.py:299-300 but never defines it)."""
    return -_cosine_sim(x, y, eps)


def negative_dot_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-<x, y> per timestep pair (soft_dtw_cuda.py:350-363)."""
    return -torch.einsum("bnd,bmd->bnm", x, y)


DIST_FUNCS = {
    "euclidean": euclidean_cost,
    "cosine": cosine_cost,
    "negative_cosine": negative_cosine_cost,
    "negative_dot": negative_dot_cost,
}


class SoftDTW:
    """Front-end mirroring the reference module (soft_dtw_cuda.py:274-386):
    distance function + optional normalization + batched soft-DTW on the
    ``backend`` named in the module docstring."""

    def __init__(self, gamma: float = 1.0, normalize: bool = False,
                 bandwidth: int | None = None, dist_func: str = "euclidean",
                 backend: str = "scan"):
        self.gamma = float(gamma)
        self.normalize = normalize
        self.bandwidth = 0 if bandwidth is None else int(bandwidth)
        if dist_func not in DIST_FUNCS:
            raise ValueError(
                f"unknown soft-DTW dist_func {dist_func!r} (the "
                f"--loss.sdtw_dist knob); expected one of "
                f"{sorted(DIST_FUNCS)}")
        self.dist_func = DIST_FUNCS[dist_func]
        if backend == "pallas":
            raise ValueError("soft-DTW backend 'pallas' is the TPU kernel of "
                             "the JAX package; the port's kernels are "
                             "backend 'cuda' (or 'auto')")
        if backend not in SDTW_BACKENDS:
            raise ValueError(f"unknown soft-DTW backend {backend!r} "
                             f"(expected one of {', '.join(SDTW_BACKENDS)})")
        self.backend = backend

    def _dp(self, D: torch.Tensor) -> torch.Tensor:
        if self.backend == "cuda" or (self.backend == "auto"
                                      and (D.is_cuda or D.is_meta)):
            from milnce_tpu_torch.ops.softdtw_cuda import softdtw_cuda

            return softdtw_cuda(D, self.gamma, self.bandwidth)
        return softdtw_scan(D, self.gamma, self.bandwidth)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x: (B, N, D), y: (B, M, D) -> (B,) alignment costs."""
        if self.normalize:                      # soft_dtw_cuda.py:376-383
            if x.shape[1] == y.shape[1]:
                # one batched DP over [xy, xx, yy] (the reference's trick)
                xx = torch.cat([x, x, y], dim=0)
                yy = torch.cat([y, x, y], dim=0)
                out_xy, out_xx, out_yy = torch.chunk(
                    self._dp(self.dist_func(xx, yy)), 3)
            else:
                # unequal lengths can't share one cost-matrix shape (the
                # reference's torch.cat would raise here); three DP calls
                out_xy = self._dp(self.dist_func(x, y))
                out_xx = self._dp(self.dist_func(x, x))
                out_yy = self._dp(self.dist_func(y, y))
            return out_xy - 0.5 * (out_xx + out_yy)
        return self._dp(self.dist_func(x, y))
