"""Soft-DTW on hand-written CUDA kernels, with their plain PyTorch
versions and the autograd function (counterpart of
``milnce_tpu/ops/softdtw_pallas.py``).

The six Pallas kernels of the JAX package are three TPU memory layouts of
one recurrence, shaped by VMEM size, Mosaic's (8, 128) tiling and its
block-area caps.  None of that binds on Hopper, so one forward and one
backward kernel (``csrc/softdtw.cu``) cover every length:

====  ========================================  ================  ===========
#     TPU kernel (milnce_tpu/ops/)              regime            here
====  ========================================  ================  ===========
B3    softdtw_pallas.py:282 _fwd_kernel_lanes   many short pairs  softdtw_fwd
B4    softdtw_pallas.py:340 _bwd_kernel_lanes   many short pairs  softdtw_bwd
B5    softdtw_pallas.py:63 _fwd_kernel          mid lengths       softdtw_fwd
B6    softdtw_pallas.py:593 _bwd_kernel         mid lengths       softdtw_bwd
B7    softdtw_pallas.py:106 _fwd_kernel_chunked long sequences    softdtw_fwd
B8    softdtw_pallas.py:489 _bwd_kernel_chunked long sequences    softdtw_bwd
====  ========================================  ================  ===========

One layout serves the kernels and their plain versions, so each kernel
can be held alone against its plain twin on the same inputs:

- ``D`` (B, N, M), the cost, as the caller made it;
- ``R`` (B, N+M+1, N+1), the padded forward table skewed to diagonal-major
  order, ``R[b, p, i] = R_b[i, p - i]`` (the JAX ``r_skew``);
- ``E`` (B, N+M+3, N+2), the Cuturi-Blondel E-matrix over the extended
  coordinates 0..N+1 x 0..M+1, skewed the same way, ``E[b, q, i] =
  E_b[i, q - i]``; ``grad_D[b, i-1, j-1] = g_b * E_b[i, j]``.

The backward needs R alone: it recomputes each successor's softmin
weights from R (:func:`softdtw_bwd_plain` says why), so D is neither read
nor saved for it.

The plain versions run in the input's dtype; the kernels take f32.  As in
the JAX package, the autograd function casts D to f32 for the kernels and
the gradient back to D's dtype.  ``LAUNCHES`` counts kernel launches, one
per launch, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from milnce_tpu_torch.ops import cuda_build
from milnce_tpu_torch.ops.softdtw import (BIG, check_bandwidth, max_sum3,
                                         valid_cells, wavefront)

LAUNCHES = {"softdtw_fwd": 0, "softdtw_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain twins
def softdtw_fwd_plain(D: torch.Tensor, gamma: float, bandwidth: int = 0):
    """Plain forward: ``(value (B,), R (B, N+M+1, N+1))``, the recurrence
    of ``softdtw_scan`` with its whole table kept."""
    n, m = D.shape[1:]
    r = torch.stack(wavefront(D, gamma, bandwidth), dim=1)
    return r[:, n + m, n], r


def _pred_max_sum(R: torch.Tensor, inv_gamma: float):
    """The forward's ``(mx, s)`` of -R/gamma over the three predecessors
    of every cell ``(i, p - i)``, i >= 1, p >= 2, in the forward's
    arithmetic: each (B, N+M-1, N), entry [p - 2, i - 1]."""
    neg = -R * inv_gamma
    return max_sum3(neg[:, :-2, :-1], neg[:, 1:-1, :-1], neg[:, 1:-1, 1:])


def softdtw_bwd_plain(R: torch.Tensor, gamma: float,
                      bandwidth: int = 0) -> torch.Tensor:
    """Plain backward: the reverse wavefront over the extended table,
    ``E (B, N+M+3, N+2)``, from the forward table alone.

    ``E(N+1, M+1) = 1`` and, for every cell inside the alignment and the
    band and reached (R < BIG/2), ``E(i, j) = sum_s E(s) w(i, j -> s)``
    over its successors s = (i+1, j), (i, j+1), (i+1, j+1), with ``w`` the
    weight the forward's softmin at s gave (i, j):
    ``exp(-R(i, j)/gamma - mx_s) / s_s``, ``(mx_s, s_s)`` the
    :func:`max_sum3` of -R/gamma over the predecessors of s.  A successor
    outside the alignment, the band or unreached contributes 0; (N, M)
    reaches the corner with weight 1.

    The JAX kernels write the weight as ``exp((R(s) - R(i, j) - D(s)) /
    gamma)``, equal in exact arithmetic since R(s) = D(s) - gamma lse_s.  In
    f32 that difference cancels to a rounding error of R, which 1/gamma
    blows up (at gamma = 1e-5 the weights of the best path come out
    exp(+-0.2) instead of 1).  ``exp(-R(i, j)/gamma - lse_s)`` avoids that
    but still carries the rounding of lse_s, some ulps of |R|/gamma; with
    the max taken out, the largest predecessor's weight is 1/s_s and the
    others come from differences of neighbouring -R/gamma, so the weights
    are as exact as the forward's own softmin."""
    bsz, n_diag, n1 = R.shape
    n, m = n1 - 1, n_diag - n1
    inv_gamma = 1.0 / gamma
    neg = -R * inv_gamma
    # (mx, s) and "is a live successor" of every cell, padded so that the
    # successors of any cell (diagonals p+1, p+2, rows i, i+1) are in range
    mx, s = _pred_max_sum(R, inv_gamma)
    mx = F.pad(mx, (1, 1, 2, 2))                         # (B, N+M+3, N+2)
    s = F.pad(s, (1, 1, 2, 2), value=1.0)
    live = valid_cells(n_diag, n1, n, m, bandwidth, R.device) & (R < BIG / 2)
    live = F.pad(live, (0, 1, 0, 2))

    def weight(dp: int, di: int) -> torch.Tensor:
        """(B, N+M+1, N+1) weights toward the successor (p+dp, i+di)."""
        succ = (slice(None), slice(dp, dp + n_diag), slice(di, di + n1))
        return torch.where(live[succ], torch.exp(neg - mx[succ]) / s[succ],
                           0.0)

    w_a, w_b, w_c = weight(1, 1), weight(1, 0), weight(2, 1)
    w_c[:, n + m, n] = 1.0                               # (N, M) -> corner
    e = torch.zeros((bsz, n_diag + 2, n + 2), dtype=R.dtype,
                    device=R.device)
    e[:, n + m + 2, n + 1] = 1.0
    for q in range(n + m, 1, -1):
        row = (e[:, q + 1, 1:] * w_a[:, q] + e[:, q + 1, :-1] * w_b[:, q]
               + e[:, q + 2, 1:] * w_c[:, q])
        e[:, q, :-1] = torch.where(live[:, q, :-1], row, 0.0)
    return e


def grad_from_e(E: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """E (B, N+M+3, N+2) -> (B, N, M), the interior ``E_b[i, j]`` for
    1 <= i <= N, 1 <= j <= M."""
    i_idx = torch.arange(n, device=E.device)[:, None]
    j_idx = torch.arange(m, device=E.device)[None, :]
    return E[:, i_idx + j_idx + 2, i_idx + 1]


# ----------------------------------------------------------------- kernels
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("softdtw")
    if not getattr(lib, "_softdtw_typed", False):
        lib.softdtw_fwd.argtypes = [_P, _P, _I, _I, _I, _F, _F, _I, _P]
        lib.softdtw_bwd.argtypes = [_P, _P, _I, _I, _I, _F, _I, _P]
        lib.softdtw_fwd.restype = ctypes.c_int
        lib.softdtw_bwd.restype = ctypes.c_int
        lib._softdtw_typed = True
    return lib


def _check_table(name: str, x: torch.Tensor) -> None:
    """A kernel operand: a non-empty f32 contiguous CUDA tensor (B, *, *)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one "
                         f"on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
    if x.dim() != 3 or min(x.shape) == 0:
        raise ValueError(f"{name}: expected a non-empty (B, rows, cols) "
                         f"tensor, got {tuple(x.shape)}")


def softdtw_fwd(D: torch.Tensor, gamma: float, bandwidth: int = 0):
    """Kernel: ``(value (B,), R (B, N+M+1, N+1))`` of an f32 cost."""
    _check_table("softdtw_fwd", D)
    bsz, n, m = D.shape
    check_bandwidth(n, m, bandwidth)
    r = torch.empty((bsz, n + m + 1, n + 1), dtype=torch.float32,
                    device=D.device)
    err = _lib().softdtw_fwd(D.data_ptr(), r.data_ptr(), bsz, n, m,
                             gamma, 1.0 / gamma, bandwidth,
                             cuda_build.current_stream(D))
    cuda_build.check_launch("softdtw_fwd", err)
    LAUNCHES["softdtw_fwd"] += 1
    return r[:, n + m, n].clone(), r


def softdtw_bwd(R: torch.Tensor, gamma: float,
                bandwidth: int = 0) -> torch.Tensor:
    """Kernel: E (B, N+M+3, N+2) from the f32 forward table R
    (B, N+M+1, N+1), as :func:`softdtw_bwd_plain` computes it."""
    _check_table("softdtw_bwd", R)
    bsz, n_diag, n1 = R.shape
    n, m = n1 - 1, n_diag - n1
    if n < 1 or m < 1:
        raise ValueError(f"softdtw_bwd: R of shape {tuple(R.shape)} is no "
                         "forward table (B, N+M+1, N+1) with N, M >= 1")
    check_bandwidth(n, m, bandwidth)
    e = torch.empty((bsz, n_diag + 2, n + 2), dtype=torch.float32,
                    device=R.device)
    err = _lib().softdtw_bwd(R.data_ptr(), e.data_ptr(), bsz, n, m,
                             1.0 / gamma, bandwidth,
                             cuda_build.current_stream(R))
    cuda_build.check_launch("softdtw_bwd", err)
    LAUNCHES["softdtw_bwd"] += 1
    return e


class _SoftDTWCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma, bandwidth):
        value, r = softdtw_fwd(D.detach().float().contiguous(), gamma,
                               bandwidth)
        ctx.save_for_backward(r)
        ctx.gamma, ctx.bandwidth, ctx.dtype = gamma, bandwidth, D.dtype
        return value

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        n1 = r.shape[2]
        e = softdtw_bwd(r, ctx.gamma, ctx.bandwidth)
        grad = grad_from_e(e, n1 - 1, r.shape[1] - n1)
        return g[:, None, None] * grad.to(ctx.dtype), None, None


def softdtw_cuda(D: torch.Tensor, gamma: float,
                 bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW values (B,) of D (B, N, M) on the kernels, f32; raises for
    a CPU tensor and for a band that cannot reach the terminal cell."""
    check_bandwidth(D.shape[1], D.shape[2], int(bandwidth))
    if not D.is_cuda:
        raise ValueError("soft-DTW backend 'cuda' takes CUDA tensors, got "
                         f"one on {D.device} (use backend 'scan' or 'auto')")
    return _SoftDTWCuda.apply(D, float(gamma), int(bandwidth))
