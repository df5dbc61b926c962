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
  E_b[i, q - i]`` (:func:`softdtw_e_plain`; the kernel keeps it on chip);
- ``grad_D`` (B, N, M), what the backward returns: ``grad_D[b, i-1, j-1]
  = g_b * E_b[i, j]``.

The forward is one launch that writes R and the value R_b(N, M).  A
thread owns a row and keeps its R on the last diagonal in a register,
taking its upper neighbour's by warp shuffle, so no barrier and no memory
access sit on a diagonal step inside a warp; :func:`fwd_plan` places the
rows.  Where N <= 32 a pair is a segment of a warp, several pairs a warp;
longer pairs take a block each, their warps passing the boundary row
through two slots a warp in shared memory, one barrier a diagonal; past
FWD_MAX_THREADS (512) rows the rows go in stripes, one after another.
Each warp copies its rows' costs two groups of FWD_K diagonals ahead into
shared memory by ``cp.async``, so no step waits on a load of D.

The backward needs R and the cotangent alone: it recomputes each
successor's softmin weights from R (:func:`softdtw_e_plain` says why), so
D is neither read nor saved for it.  :func:`bwd_plan` chooses its launch.

The plain versions run in the input's dtype; the kernels take f32.  As in
the JAX package, the autograd function casts D to f32 for the kernels and
the gradient back to D's dtype.  ``LAUNCHES`` counts kernel launches, one
per launch, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

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


def softdtw_e_plain(R: torch.Tensor, gamma: float,
                    bandwidth: int = 0) -> torch.Tensor:
    """The reverse wavefront over the extended table, ``E (B, N+M+3,
    N+2)``, from the forward table alone.

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


def softdtw_bwd_plain(R: torch.Tensor, g: torch.Tensor, gamma: float,
                      bandwidth: int = 0) -> torch.Tensor:
    """Plain backward: ``grad_D (B, N, M) = g_b * E_b(i, j)`` over the
    interior cells, from the forward table R and the cotangent g (B,) (any
    stride), in R's dtype.  Every cell is multiplied, so a NaN ``g_b``
    gives a NaN gradient for pair b."""
    n1 = R.shape[2]
    e = softdtw_e_plain(R, gamma, bandwidth)
    return g[:, None, None] * grad_from_e(e, n1 - 1, R.shape[1] - n1)


# ----------------------------------------------------------------- kernels
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# The forward's layout (csrc/softdtw.cu keeps the same constants and
# refuses a plan that disagrees): a thread a row; a block of
# FWD_SHORT_WARPS warps of short pairs, or a long pair a block of at most
# FWD_MAX_THREADS rows at a time.  Each warp has FWD_TILES tiles of 32 x
# (FWD_K + 1) floats for the costs of the groups of FWD_K diagonals it
# steps and copies; a long pair's warps also have two 4-byte exchange
# slots each.
FWD_MAX_THREADS = 512
FWD_SHORT_WARPS = 4
FWD_K = 8
FWD_TILES = 3
FWD_SHORT_MAX_M = 2**31 // 32


def fwd_smem_bytes(threads: int, long_pairs: bool) -> int:
    """Shared bytes of a forward block of ``threads``."""
    warps = threads // 32
    ring = 4 * 2 * warps if long_pairs else 0
    return ring + 4 * FWD_TILES * 32 * (FWD_K + 1) * warps


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How a ``softdtw_fwd`` launch runs: ``rows`` threads a pair, one
    for each row (a power of two >= N where N <= 32, so that a pair is a
    segment of a warp; else the block, whole warps, the rows in
    ``stripes`` of that many); ``pairs_per_block`` pairs in each of
    ``blocks`` blocks of ``threads``; the cost tiles (and a long pair's
    exchange ring) in ``smem_bytes`` of shared memory."""
    rows: int
    pairs_per_block: int
    threads: int
    blocks: int
    smem_bytes: int
    stripes: int


@functools.lru_cache(maxsize=256)
def fwd_plan(b: int, n: int, m: int) -> FwdPlan:
    """The launch plan of ``softdtw_fwd`` for B pairs of N x M.  Where
    N <= 32 a warp holds 32 / rows pairs and a block up to
    FWD_SHORT_WARPS such warps (fewer where B is small, so that the
    pairs spread over more SMs); longer pairs take a block each, one
    thread a row, in as few stripes of at most FWD_MAX_THREADS rows as
    cover N, each as even as whole warps allow.  A warp of short pairs
    addresses its 32 rows of costs by 32-bit offsets, so rows of
    FWD_SHORT_MAX_M costs or more go as long pairs."""
    if n <= 32 and m < FWD_SHORT_MAX_M:
        rows = 1 << (n - 1).bit_length()
        per_warp = 32 // rows
        warps = min(FWD_SHORT_WARPS, -(-b // per_warp))
        per_block = per_warp * warps
        return FwdPlan(rows, per_block, 32 * warps, -(-b // per_block),
                       fwd_smem_bytes(32 * warps, False), 1)
    threads = -(-n // (32 * -(-n // FWD_MAX_THREADS))) * 32
    return FwdPlan(threads, 1, threads, b, fwd_smem_bytes(threads, True),
                   -(-n // threads))


# The backward's layout (csrc/softdtw.cu, whose launch checks the plan):
# for each row of a pair one chain thread and BWD_BATCH workers, which run a
# period of BWD_BATCH diagonals ahead of the chain, one diagonal each; a
# ring of three periods' diagonals of N + 2 cells of four floats (the three
# weights a cell receives, and E).
BWD_BATCH = 4
BWD_SLOTS = 3 * BWD_BATCH
BWD_ROLES = 1 + BWD_BATCH
BWD_MAX_ROWS = 128                  # chain threads a pair; rows loop past it
BWD_MAX_THREADS = BWD_ROLES * BWD_MAX_ROWS


def bwd_ring_floats(n: int) -> int:
    """Floats of one pair's ring in the backward kernel."""
    return 4 * BWD_SLOTS * (n + 2)


def bwd_shared_max_n(smem_limit: int = cuda_build.SM90_SMEM_OPTIN) -> int:
    """The largest N whose ring fits ``smem_limit`` bytes of shared
    memory (one pair a block)."""
    return smem_limit // (4 * 4 * BWD_SLOTS) - 2


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How a ``softdtw_bwd`` launch runs: ``rows`` chain threads a pair,
    one for each row of the diagonal (a power of two where N <= 32, so
    that a pair's chain lies in one warp; else N rounded up to whole warps,
    at most BWD_MAX_ROWS, a thread looping over rows past it), and
    BWD_BATCH workers for each; ``pairs_per_block`` pairs in each of
    ``blocks`` blocks of ``threads``, the chains first; the ring in
    ``smem_bytes`` of shared memory, or in a global scratch buffer of
    ``scratch_floats`` where the block's rings exceed the card's opt-in
    limit."""
    rows: int
    pairs_per_block: int
    threads: int
    blocks: int
    smem_bytes: int
    scratch_floats: int

    @property
    def ring(self) -> str:
        return "global" if self.scratch_floats else "shared"


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, n: int, m: int,
             smem_limit: int = cuda_build.SM90_SMEM_OPTIN) -> BwdPlan:
    """The launch plan of ``softdtw_bwd`` for B pairs of N x M.  Where
    N <= 32 a pair's chain is one warp or part of one, and a block takes
    the pairs of one chain warp, or two pairs where that is one and
    N + 2 <= 32; longer pairs take a block each.  Small blocks leave the
    most pairs resident on an SM.  ``m`` sets nothing: the diagonal is at
    most N rows."""
    if n <= 32:
        rows = 1 << (n - 1).bit_length()
        per_warp = 32 // rows
        least = 2 if n + 2 <= 32 else 1
        per_block = per_warp * -(-least // per_warp)
    else:
        rows = min(BWD_MAX_ROWS, -(-n // 32) * 32)
        per_block = 1
    threads = BWD_ROLES * rows * per_block
    blocks = -(-b // per_block)
    ring = bwd_ring_floats(n) * per_block
    if 4 * ring <= smem_limit:
        return BwdPlan(rows, per_block, threads, blocks, 4 * ring, 0)
    return BwdPlan(rows, per_block, threads, blocks, 0, ring * blocks)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("softdtw")
    if not getattr(lib, "_softdtw_typed", False):
        lib.softdtw_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _F, _F, _I, _I,
                                    _I, _I, _I, _P]
        lib.softdtw_bwd.argtypes = [_P, _P, _I, _P, _P, _I, _I, _I, _F, _I,
                                    _I, _I, _I, _I, _P]
        lib.softdtw_fwd.restype = ctypes.c_int
        lib.softdtw_bwd.restype = ctypes.c_int
        lib._softdtw_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    """Opt-in shared bytes a block of CUDA device ``index`` may use."""
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin",
                   cuda_build.SM90_SMEM_OPTIN)


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


def _launch_fwd(D: torch.Tensor, gamma: float, bandwidth: int):
    """One launch of the forward kernel, without the operand checks:
    ``(value (B,), R)``."""
    bsz, n, m = D.shape
    plan = fwd_plan(bsz, n, m)
    r = torch.empty((bsz, n + m + 1, n + 1), dtype=torch.float32,
                    device=D.device)
    value = torch.empty(bsz, dtype=torch.float32, device=D.device)
    err = _lib().softdtw_fwd(D.data_ptr(), r.data_ptr(), value.data_ptr(),
                             bsz, n, m, gamma, 1.0 / gamma, bandwidth,
                             plan.rows, plan.threads, plan.blocks,
                             plan.smem_bytes, cuda_build.current_stream(D))
    cuda_build.check_launch("softdtw_fwd", err)
    LAUNCHES["softdtw_fwd"] += 1
    return value, r


def softdtw_fwd(D: torch.Tensor, gamma: float, bandwidth: int = 0):
    """Kernel: ``(value (B,), R (B, N+M+1, N+1))`` of an f32 cost, as
    :func:`softdtw_fwd_plain` computes them, in one launch."""
    _check_table("softdtw_fwd", D)
    check_bandwidth(D.shape[1], D.shape[2], bandwidth)
    return _launch_fwd(D, gamma, bandwidth)


def _launch_bwd(r: torch.Tensor, g: torch.Tensor, gamma: float,
                bandwidth: int) -> torch.Tensor:
    """One launch of the backward kernel, without the operand checks."""
    bsz, n_diag, n1 = r.shape
    n, m = n1 - 1, n_diag - n1
    plan = bwd_plan(bsz, n, m, _smem_optin(r.device.index))
    grad = torch.empty((bsz, n, m), dtype=torch.float32, device=r.device)
    scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                           device=r.device) if plan.ring == "global" else None)
    err = _lib().softdtw_bwd(
        r.data_ptr(), g.data_ptr(), g.stride(0), grad.data_ptr(),
        None if scratch is None else scratch.data_ptr(), bsz, n, m,
        1.0 / gamma, bandwidth, plan.rows, plan.threads, plan.blocks,
        plan.smem_bytes, cuda_build.current_stream(r))
    cuda_build.check_launch("softdtw_bwd", err)
    LAUNCHES["softdtw_bwd"] += 1
    return grad


def softdtw_bwd(R: torch.Tensor, g: torch.Tensor, gamma: float,
                bandwidth: int = 0) -> torch.Tensor:
    """Kernel: grad_D (B, N, M), f32, from the f32 forward table R
    (B, N+M+1, N+1) and the f32 cotangent g (B,) of any stride, as
    :func:`softdtw_bwd_plain` computes it."""
    _check_table("softdtw_bwd", R)
    bsz, n_diag, n1 = R.shape
    n, m = n1 - 1, n_diag - n1
    if n < 1 or m < 1:
        raise ValueError(f"softdtw_bwd: R of shape {tuple(R.shape)} is no "
                         "forward table (B, N+M+1, N+1) with N, M >= 1")
    check_bandwidth(n, m, bandwidth)
    if not g.is_cuda or g.device != R.device:
        raise ValueError(f"softdtw_bwd: the cotangent must lie on R's CUDA "
                         f"device {R.device}, got one on {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"softdtw_bwd: the kernel takes a float32 "
                        f"cotangent, got {g.dtype}")
    if g.shape != (bsz,):
        raise ValueError(f"softdtw_bwd: the cotangent must have shape "
                         f"({bsz},), got {tuple(g.shape)}")
    return _launch_bwd(R, g, gamma, bandwidth)


class _SoftDTWCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma, bandwidth):
        # softdtw_cuda checked D once; the cast and copy make it the
        # kernel's f32 contiguous operand
        value, r = _launch_fwd(D.detach().float().contiguous(), gamma,
                               bandwidth)
        ctx.save_for_backward(r)
        ctx.gamma, ctx.bandwidth, ctx.dtype = gamma, bandwidth, D.dtype
        return value

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        # the table is the forward's own; g is the f32 value's cotangent,
        # often a stride-0 expand, which the kernel reads at its stride
        grad = _launch_bwd(r, g, ctx.gamma, ctx.bandwidth)
        if ctx.dtype != torch.float32:
            grad = grad.to(ctx.dtype)
        return grad, None, None


def softdtw_cuda(D: torch.Tensor, gamma: float,
                 bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW values (B,) of D (B, N, M) on the kernels, f32; raises for
    a CPU tensor, an empty or non-3-D one and a band that cannot reach the
    terminal cell.  These are the call's only operand checks."""
    if D.dim() != 3 or min(D.shape) == 0:
        raise ValueError(f"softdtw_fwd: expected a non-empty (B, N, M) cost, "
                         f"got {tuple(D.shape)}")
    check_bandwidth(D.shape[1], D.shape[2], int(bandwidth))
    if not D.is_cuda:
        raise ValueError("soft-DTW backend 'cuda' takes CUDA tensors, got "
                         f"one on {D.device} (use backend 'scan' or 'auto')")
    return _SoftDTWCuda.apply(D, float(gamma), int(bandwidth))
