"""Sequence-parallel soft-DTW: the DP wavefront sharded over the ranks of
a process group (port of ``milnce_tpu/ops/softdtw_sp.py``).

The single-device recurrences (``ops/softdtw.py``, the CUDA kernels of
``ops/softdtw_cuda.py``) hold one alignment's table on one device; here
the anti-diagonal wavefront itself is split over the ranks, so one
alignment's table and per-diagonal work scale 1/W with the group size.

Decomposition (row-sharded wavefront, as the JAX ``shard_map`` body):

- the (B, N, M) costs are split over N: rank p owns rows
  ``[p*k, (p+1)*k)``, ``k = ceil(N / W)``; the rows past N that pad the
  last ranks are masked out (their cells hold ``BIG``);
- each diagonal of ``R[i, j] = D[i-1, j-1] + softmin(R[i-1, j-1],
  R[i-1, j], R[i, j-1])`` is a vector split the same way; the only
  cross-rank dependency is the ``i-1`` shift, so after each diagonal
  every rank sends its LAST row's value to its right neighbour (the
  halo, one (B,) vector) and rank 0 synthesises the ``i = 0`` border;
- ``R[N, M]`` lives on one rank and is summed to every rank.

JAX differentiates through ``ppermute``; here the backward is written
out: a ``torch.autograd.Function`` whose backward runs the reverse
wavefront from ``R[N, M]`` down, each cell pushing ``E`` times its
softmax weight (recomputed from the saved table, as autograd through
the forward's softmin would) to its three predecessors, and after each
diagonal every rank sends its FIRST row's pushes to its left neighbour
(the reverse halo).  Every rank posts its sends and receives of a
diagonal together in one ``batch_isend_irecv``, in the same order on
every rank.  NCCL carries the halos as CUDA tensors; gloo takes no CUDA
tensor in a send (its TCP transport writes device pointers), so over
gloo each halo goes through host memory.

The computation is float32 whatever the input's dtype (the ``BIG``
border arithmetic needs f32 range).  Two entries:

- :func:`softdtw_seq_parallel_rows`, the rows-local one: each rank
  passes only its own (B, k, M) rows, gets the (B,) values, and in the
  backward the gradient of its own rows.  A rank holds its rows, their
  table on the ``<= k + M + 1`` diagonals they reach and the (Q, B)
  halos, never anything of N rows: the entry for tables that outgrow a
  device, as the JAX body sees only its row block;
- :func:`softdtw_seq_parallel`, a thin layer on top of it: every rank
  passes the same full D, and the backward gathers the ranks' gradient
  rows into the full grad_D on every rank.

Both give the gradient of the one global computation, taking the
values' cotangent to be the same on every rank, as the values are.  Each
diagonal is a few PyTorch ops and one exchange: a plain path, for
alignments whose table outgrows a device, not a fast one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from milnce_tpu_torch.ops.softdtw import BIG, check_bandwidth, max_sum3


def _halo_device(group, like: torch.Tensor) -> torch.device:
    """Where a halo travels: NCCL sends CUDA tensors; gloo sends host
    tensors only."""
    if dist.get_backend(group) == "nccl":
        return like.device
    return torch.device("cpu")


class _Neighbours:
    """This rank's place in the group and one exchange of a diagonal: a
    halo to one neighbour, a halo from the other, posted together."""

    def __init__(self, group, like: torch.Tensor):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = _halo_device(group, like)

    def _global(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def exchange(self, send: torch.Tensor, to: int, frm: int,
                 out_like: torch.Tensor) -> torch.Tensor | None:
        """Send ``send`` to group rank ``to`` and receive a tensor shaped
        as ``out_like`` from ``frm`` (either may be out of range: no
        neighbour).  Returns the received tensor on ``out_like``'s device
        (None with no left/right neighbour to receive from)."""
        ops = []
        if 0 <= to < self.world:
            ops.append(dist.P2POp(dist.isend,
                                  send.to(self.device).contiguous(),
                                  self._global(to), self.group))
        recv = None
        if 0 <= frm < self.world:
            recv = torch.empty(out_like.shape, dtype=out_like.dtype,
                               device=self.device)
            ops.append(dist.P2POp(dist.irecv, recv, self._global(frm),
                                  self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return None if recv is None else recv.to(out_like.device)


def _local_layout(n: int, m: int, world: int, rank: int, device):
    """(k, global row of each local row (k,), diagonal window (lo, hi))
    of rank's block; local row r is padded table row ``i = rows[r] + 1``.
    The block's cells lie on the diagonals ``lo + 2 .. hi`` only; ``lo``
    and ``lo + 1`` hold their first predecessors.  Outside the window
    every local cell is BIG in the forward and 0 in the backward, so a
    rank keeps only ``hi - lo + 1 <= k + m + 1`` diagonals of its rows."""
    k = -(-n // world)
    rows = rank * k + torch.arange(k, device=device)
    lo = min(rank * k, n + m)
    return k, rows, (lo, min(rank * k + k + m, n + m))


def _valid(rows: torch.Tensor, q: int, n: int, m: int,
           bandwidth: int) -> torch.Tensor:
    """(k,) mask: the cells (i, q - i) of the local rows on diagonal q
    inside the N x M alignment and the band."""
    i = rows + 1
    j = q - i
    ok = (j >= 1) & (j <= m) & (i <= n)
    if bandwidth > 0:
        ok &= (i - j).abs() <= bandwidth
    return ok


def _skew_local(D_rows: torch.Tensor, rows: torch.Tensor, first: int,
                count: int, m: int) -> torch.Tensor:
    """Local costs (B, k, M) -> diagonal-major (count, B, k) with
    ``out[t, :, r] = D_rows[:, r, first + t - rows[r]]`` (0 out of
    range); ``first + t`` is the diagonal q - 2."""
    t = first + torch.arange(count, device=D_rows.device)[:, None]
    col = t - rows[None, :]                                  # (T, k)
    ok = (col >= 0) & (col < m)
    k = rows.shape[0]
    r_idx = torch.arange(k, device=D_rows.device)[None, :].expand_as(col)
    vals = D_rows[:, r_idx, col.clamp(0, m - 1)]              # (B, T, k)
    return torch.where(ok, vals, torch.zeros((), dtype=vals.dtype,
                                             device=vals.device)
                       ).permute(1, 0, 2)


def _weights(pred_diag, pred_up, pred_left, inv_gamma):
    """Each cell's softmax weights over its three predecessors, the
    derivative of its softmin with respect to each."""
    mx, s = max_sum3(-pred_diag * inv_gamma, -pred_up * inv_gamma,
                     -pred_left * inv_gamma)
    return (torch.exp(-pred_diag * inv_gamma - mx) / s,
            torch.exp(-pred_up * inv_gamma - mx) / s,
            torch.exp(-pred_left * inv_gamma - mx) / s)


def _forward(D_rows, rows, window, n, m, gamma, bandwidth, nb: _Neighbours):
    """The forward wavefront on this rank's rows: (value (B,) summed to
    every rank, R on the window's diagonals (hi - lo + 1, B, k), left
    halos (Q, B))."""
    bsz, k, _ = D_rows.shape
    dev = D_rows.device
    q_count = n + m + 1
    lo, hi = window
    cost = _skew_local(D_rows, rows, lo, max(0, hi - lo - 1), m)
    R = torch.full((hi - lo + 1, bsz, k), BIG, dtype=torch.float32,
                   device=dev)                               # R[q - lo]
    # left halos: the left neighbour's last row on each diagonal; rank 0
    # holds the i = 0 border, R[0, q] = 0 iff q == 0
    H = torch.full((q_count, bsz), BIG, dtype=torch.float32, device=dev)
    if nb.rank == 0:
        H[0] = 0.0
    big = torch.full((bsz,), BIG, dtype=torch.float32, device=dev)
    inv_gamma = 1.0 / gamma
    for q in range(2, q_count):
        last = big
        if lo + 2 <= q <= hi:
            up, diag = R[q - 1 - lo], R[q - 2 - lo]
            pred_diag = torch.cat([H[q - 2][:, None], diag[:, :-1]], dim=1)
            pred_up = torch.cat([H[q - 1][:, None], up[:, :-1]], dim=1)
            mx, s = max_sum3(-pred_diag * inv_gamma, -pred_up * inv_gamma,
                             -up * inv_gamma)
            interior = cost[q - 2 - lo] - gamma * (torch.log(s) + mx)
            R[q - lo] = torch.where(_valid(rows, q, n, m, bandwidth),
                                    interior, BIG)
            last = R[q - lo][:, -1]
        if q < q_count - 1:
            got = nb.exchange(last, nb.rank + 1, nb.rank - 1, H[q])
            if got is not None:
                H[q] = got
    value = torch.zeros((bsz,), dtype=torch.float32, device=dev)
    if hi == q_count - 1:           # R[N, M] lies in this rank's window
        value = torch.where(rows == n - 1, R[hi - lo], 0.0).sum(dim=1)
    dist.all_reduce(value, group=nb.group)
    return value, R, H


def _backward(g, R, H, rows, lo, n, m, gamma, bandwidth, nb: _Neighbours):
    """The reverse wavefront: this rank's rows of grad_D (B, k, M)."""
    n_win, bsz, k = R.shape
    hi = lo + n_win - 1
    q_count = n + m + 1
    dev = R.device
    inv_gamma = 1.0 / gamma
    E = torch.zeros((n_win, bsz, k), dtype=torch.float32, device=dev)
    # E[N, M] = g on the rank that owns row N-1
    e_q = torch.where(rows == n - 1, g[:, None], 0.0)
    acc = torch.zeros((bsz, k), dtype=torch.float32, device=dev)
    silent = torch.zeros((2, bsz), dtype=torch.float32, device=dev)
    for q in range(q_count - 1, 1, -1):
        if lo + 2 <= q <= hi:
            e_q = torch.where(_valid(rows, q, n, m, bandwidth), e_q, 0.0)
            E[q - lo] = e_q
            up, diag = R[q - 1 - lo], R[q - 2 - lo]
            pred_diag = torch.cat([H[q - 2][:, None], diag[:, :-1]], dim=1)
            pred_up = torch.cat([H[q - 1][:, None], up[:, :-1]], dim=1)
            w_diag, w_up, w_left = _weights(pred_diag, pred_up, up,
                                            inv_gamma)
            push_up, push_diag = e_q * w_up, e_q * w_diag
            nxt = acc + e_q * w_left                       # diagonal q-1
            nxt[:, :-1] += push_up[:, 1:]
            acc = torch.zeros_like(acc)                    # diagonal q-2
            acc[:, :-1] = push_diag[:, 1:]
            send = torch.stack([push_up[:, 0], push_diag[:, 0]])
        else:
            # no cell of this rank on diagonal q: it pushes nothing
            nxt, acc, send = acc, torch.zeros_like(acc), silent
        if q > 2:
            # the first row's pushes belong to the left neighbour's last
            # row; the right neighbour's come into this rank's last row
            got = nb.exchange(send, nb.rank - 1, nb.rank + 1, silent)
            if got is not None:
                nxt[:, -1] += got[0]
                acc[:, -1] += got[1]
        e_q = nxt
    # unskew: grad[b, r, c] = E[rows[r] + c + 2 - lo, b, r]
    c = torch.arange(m, device=dev)
    q_idx = (rows[:, None] - lo + c[None, :] + 2).clamp(max=n_win - 1)
    r_idx = torch.arange(k, device=dev)[:, None].expand_as(q_idx)
    return E[q_idx, :, r_idx].permute(2, 0, 1)


class _SoftDTWRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D_rows, n, gamma, group, bandwidth):
        _, _, m = D_rows.shape
        nb = _Neighbours(group, D_rows)
        _, rows, window = _local_layout(n, m, nb.world, nb.rank,
                                        D_rows.device)
        value, R, H = _forward(D_rows.detach().to(torch.float32), rows,
                               window, n, m, gamma, bandwidth, nb)
        ctx.save_for_backward(R, H, rows)
        ctx.meta = (window[0], n, m, gamma, bandwidth, group, D_rows.dtype)
        return value

    @staticmethod
    def backward(ctx, g):
        R, H, rows = ctx.saved_tensors
        lo, n, m, gamma, bandwidth, group, dtype = ctx.meta
        grad = _backward(g.detach().to(torch.float32), R, H, rows, lo, n,
                         m, gamma, bandwidth, _Neighbours(group, R))
        return grad.to(dtype), None, None, None, None


class _OwnRows(torch.autograd.Function):
    """The full D (B, N, M) -> this rank's rows (B, k, M), the last
    ranks' rows past N zero; the backward gathers every rank's gradient
    rows into the full grad_D."""

    @staticmethod
    def forward(ctx, D, group):
        bsz, n, m = D.shape
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        k = -(-n // world)
        own = D.new_zeros((bsz, k, m))
        first, last = min(rank * k, n), min((rank + 1) * k, n)
        own[:, :last - first] = D[:, first:last]
        ctx.meta = (n, group)
        return own

    @staticmethod
    def backward(ctx, grad_rows):
        n, group = ctx.meta
        grad_rows = grad_rows.contiguous()
        parts = [torch.empty_like(grad_rows)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, grad_rows, group=group)
        return torch.cat(parts, dim=1)[:, :n], None


def softdtw_seq_parallel_rows(D_rows: torch.Tensor, n: int, gamma: float,
                              group, bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW values (B,) of costs (B, N, M) of which each rank of
    ``group`` passes its own rows: rank p the (B, k, M) rows ``p*k ..
    (p+1)*k - 1``, ``k = ceil(N / W)``, the last ranks' rows past N
    padded (their values are ignored).  The values are float32 and the
    same on every rank; the backward gives each rank the gradient of its
    own rows only (zero on the padding), taking the values' cotangent to
    be the same on every rank.  Nothing of N rows is held on a rank: its
    rows, and the table of its rows on the diagonals they reach.  A band
    narrower than |N - M| is refused (``check_bandwidth``)."""
    _, k, m = D_rows.shape
    check_bandwidth(int(n), m, int(bandwidth))
    world = dist.get_world_size(group)
    if k != -(-int(n) // world):
        raise ValueError(f"{k} rows a rank: N = {n} over {world} ranks "
                         f"takes ceil(N / W) = {-(-int(n) // world)}")
    return _SoftDTWRows.apply(D_rows, int(n), float(gamma), group,
                              int(bandwidth))


def softdtw_seq_parallel(D: torch.Tensor, gamma: float, group,
                         bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW values (B,) of the costs D (B, N, M), the same full D on
    every rank of ``group``: each rank takes its rows and runs
    :func:`softdtw_seq_parallel_rows`.  float32 whatever D's dtype, the
    values on every rank.  Differentiable: the backward gathers the
    ranks' gradient rows into the full grad_D on every rank.  A band
    narrower than |N - M| is refused (``check_bandwidth``)."""
    _, n, m = D.shape
    check_bandwidth(n, m, int(bandwidth))
    return softdtw_seq_parallel_rows(_OwnRows.apply(D, group), n, gamma,
                                     group, bandwidth)
