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
border arithmetic needs f32 range).  Every rank passes the same full D
and gets the (B,) values; the backward returns the full grad_D on
every rank (the ranks' row blocks gathered), the gradient of the one
global computation, taking the values' cotangent to be the same on
every rank, as the values are.  Each diagonal is a few PyTorch ops and
one exchange: a plain path, for alignments whose table outgrows a
device, not a fast one.
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
    """(k, global row of each local row (k,), diagonal count Q) of rank's
    block; local row r is padded table row ``i = rows[r] + 1``."""
    k = -(-n // world)
    rows = rank * k + torch.arange(k, device=device)
    return k, rows, n + m + 1


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


def _skew_local(D_rows: torch.Tensor, rows: torch.Tensor, n_diags: int,
                m: int) -> torch.Tensor:
    """Local costs (B, k, M) -> diagonal-major (n_diags, B, k) with
    ``out[t, :, r] = D_rows[:, r, t - rows[r]]`` (0 out of range); t is
    the diagonal q - 2."""
    t = torch.arange(n_diags, device=D_rows.device)[:, None]
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


def _forward(D_rows, rows, n, m, gamma, bandwidth, nb: _Neighbours):
    """The forward wavefront on this rank's rows: (value (B,) summed to
    every rank, R diagonals (Q, B, k), left halos (Q, B))."""
    bsz, k, _ = D_rows.shape
    dev = D_rows.device
    q_count = n + m + 1
    cost = _skew_local(D_rows, rows, n + m - 1, m)           # diag q at q-2
    R = torch.full((q_count, bsz, k), BIG, dtype=torch.float32, device=dev)
    # left halos: the left neighbour's last row on each diagonal; rank 0
    # holds the i = 0 border, R[0, q] = 0 iff q == 0
    H = torch.full((q_count, bsz), BIG, dtype=torch.float32, device=dev)
    if nb.rank == 0:
        H[0] = 0.0
    inv_gamma = 1.0 / gamma
    for q in range(2, q_count):
        pred_diag = torch.cat([H[q - 2][:, None], R[q - 2][:, :-1]], dim=1)
        pred_up = torch.cat([H[q - 1][:, None], R[q - 1][:, :-1]], dim=1)
        mx, s = max_sum3(-pred_diag * inv_gamma, -pred_up * inv_gamma,
                         -R[q - 1] * inv_gamma)
        interior = cost[q - 2] - gamma * (torch.log(s) + mx)
        R[q] = torch.where(_valid(rows, q, n, m, bandwidth), interior, BIG)
        if q < q_count - 1:
            got = nb.exchange(R[q][:, -1], nb.rank + 1, nb.rank - 1, H[q])
            if got is not None:
                H[q] = got
    value = torch.where(rows == n - 1, R[q_count - 1], 0.0).sum(dim=1)
    dist.all_reduce(value, group=nb.group)
    return value, R, H


def _backward(g, R, H, rows, n, m, gamma, bandwidth, nb: _Neighbours):
    """The reverse wavefront: this rank's rows of grad_D (B, k, M)."""
    q_count, bsz, k = R.shape
    dev = R.device
    inv_gamma = 1.0 / gamma
    E = torch.zeros((q_count, bsz, k), dtype=torch.float32, device=dev)
    # E[N, M] = g on the rank that owns row N-1
    e_q = torch.where(rows == n - 1, g[:, None], 0.0)
    acc = torch.zeros((bsz, k), dtype=torch.float32, device=dev)
    for q in range(q_count - 1, 1, -1):
        e_q = torch.where(_valid(rows, q, n, m, bandwidth), e_q, 0.0)
        E[q] = e_q
        pred_diag = torch.cat([H[q - 2][:, None], R[q - 2][:, :-1]], dim=1)
        pred_up = torch.cat([H[q - 1][:, None], R[q - 1][:, :-1]], dim=1)
        w_diag, w_up, w_left = _weights(pred_diag, pred_up, R[q - 1],
                                        inv_gamma)
        push_up, push_diag = e_q * w_up, e_q * w_diag
        nxt = acc + e_q * w_left                           # diagonal q-1
        nxt[:, :-1] += push_up[:, 1:]
        acc = torch.zeros_like(acc)                        # diagonal q-2
        acc[:, :-1] = push_diag[:, 1:]
        if q > 2:
            # the first row's pushes belong to the left neighbour's last
            # row; the right neighbour's come into this rank's last row
            got = nb.exchange(torch.stack([push_up[:, 0], push_diag[:, 0]]),
                              nb.rank - 1, nb.rank + 1,
                              torch.empty((2, bsz), device=dev))
            if got is not None:
                nxt[:, -1] += got[0]
                acc[:, -1] += got[1]
        e_q = nxt
    # unskew: grad[b, r, c] = E[rows[r] + c + 2, b, r]
    c = torch.arange(m, device=dev)
    q_idx = (rows[:, None] + c[None, :] + 2).clamp(max=q_count - 1)
    r_idx = torch.arange(k, device=dev)[:, None].expand_as(q_idx)
    return E[q_idx, :, r_idx].permute(2, 0, 1)


class _SoftDTWSeqParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma, group, bandwidth):
        bsz, n, m = D.shape
        nb = _Neighbours(group, D)
        k, rows, _ = _local_layout(n, m, nb.world, nb.rank, D.device)
        D32 = D.detach().to(torch.float32)
        pad = k * nb.world - n
        if pad:
            D32 = torch.cat([D32, D32.new_zeros((bsz, pad, m))], dim=1)
        D_rows = D32[:, nb.rank * k:(nb.rank + 1) * k]
        value, R, H = _forward(D_rows, rows, n, m, gamma, bandwidth, nb)
        ctx.save_for_backward(R, H, rows)
        ctx.meta = (n, m, gamma, bandwidth, group, D.dtype)
        return value

    @staticmethod
    def backward(ctx, g):
        R, H, rows = ctx.saved_tensors
        n, m, gamma, bandwidth, group, dtype = ctx.meta
        nb = _Neighbours(group, R)
        local = _backward(g.detach().to(torch.float32), R, H, rows, n, m,
                          gamma, bandwidth, nb).contiguous()
        parts = [torch.empty_like(local) for _ in range(nb.world)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts, dim=1)[:, :n].to(dtype), None, None, None


def softdtw_seq_parallel(D: torch.Tensor, gamma: float, group,
                         bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW values (B,) of the costs D (B, N, M), the same full D on
    every rank of ``group``, the wavefront split over the ranks by rows;
    float32 whatever D's dtype, the values on every rank.  Differentiable:
    the backward returns the full grad_D on every rank.  A band narrower
    than |N - M| is refused (``check_bandwidth``)."""
    _, n, m = D.shape
    check_bandwidth(n, m, int(bandwidth))
    return _SoftDTWSeqParallel.apply(D, float(gamma), group, int(bandwidth))
