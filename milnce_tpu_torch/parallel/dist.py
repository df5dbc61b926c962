"""Process groups and the differentiable collectives of data parallelism
(port of ``milnce_tpu/parallel/mesh.py::initialize_distributed``,
``parallel/compat.py::psum_with_identity_grad`` and the
``lax.all_gather(..., tiled=True)`` of the losses).

One process a rank, as ``torchrun`` launches them.  The JAX package runs
one SPMD program over a mesh axis; here every rank runs the same step on
its shard of the global batch, and the collectives below stand where the
JAX step has its mesh-axis collectives.  Their backward passes are the
transposes JAX takes:

- :func:`all_gather_tiled` -- forward: the ranks' tensors concatenated
  along dim 0 in rank order.  Backward: the cotangent SUMMED over the
  ranks, then this rank's slice (a reduce-scatter, the transpose of
  ``lax.all_gather``).  Every rank's loss reads every rank's embeddings,
  so a backward that kept only the local slice of the local cotangent
  would drop the cross-rank terms.
- :func:`psum_identity_grad` -- forward: the sum over the ranks.
  Backward: the identity, so each rank differentiates its own term.
- :func:`all_reduce_sum` -- forward: the sum over the ranks; backward:
  the sum of the cotangents (sync BatchNorm's statistics).

Each collective is ``all_gather`` or ``all_reduce``, which every backend
takes on CPU and CUDA tensors alike (gloo included).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the run: ``group`` is None on the
    single-process path, where every collective is skipped."""
    group: Optional[object] = None
    rank: int = 0
    world: int = 1
    local_rank: int = 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Destroy the group this run created."""
        if self.group is not None:
            dist.destroy_process_group(self.group)


def _init_method(address: str) -> str:
    """``parallel.coordinator_address`` -> an ``init_method``: a bare
    ``host:port`` is TCP; a URL (``tcp://`` or ``file://``) is taken as
    it is."""
    return address if "://" in address else f"tcp://{address}"


def _source(cfg) -> Optional[tuple]:
    """(init_method, world, rank, local_rank) from the config's
    coordinator knobs or the ``torchrun`` environment; None when neither
    names a group."""
    if cfg.coordinator_address:
        if cfg.num_processes is None or cfg.process_id is None:
            raise ValueError("parallel.coordinator_address needs "
                             "parallel.num_processes and parallel.process_id")
        world, rank = int(cfg.num_processes), int(cfg.process_id)
        if not 0 <= rank < world:
            raise ValueError(f"parallel.process_id={rank} outside the "
                             f"{world} processes")
        local = os.environ.get("LOCAL_RANK")
        if local is not None:
            local_rank = int(local)
        elif cfg.platform == "cuda" and torch.cuda.is_available():
            local_rank = rank % torch.cuda.device_count()
        else:
            local_rank = 0
        return _init_method(cfg.coordinator_address), world, rank, local_rank
    if all(name in os.environ for name in _TORCHRUN_ENV):
        return ("env://", int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"]))
    return None


def _check_num_devices(cfg, world: int) -> None:
    """``parallel.num_devices`` (0 = every rank of the run) must not pass
    the devices there are (CUDA: the visible cards; CPU: the ranks) and
    must equal the run's world size: the port has one rank a device."""
    n = int(cfg.num_devices or 0)
    if not n:
        return
    visible = torch.cuda.device_count() if cfg.platform == "cuda" else world
    if n > visible:
        raise ValueError(f"parallel.num_devices={n} exceeds the {visible} "
                         "visible devices")
    if n != world:
        raise ValueError(f"parallel.num_devices={n} differs from the run's "
                         f"{world} ranks (one rank a device)")


def initialize_distributed(cfg) -> Ranks:
    """Join the process group that ``cfg`` (a ParallelConfig) or the
    ``torchrun`` environment names, on NCCL for ``platform cuda`` and gloo
    for ``cpu``; with neither source, no group (:class:`Ranks` of one
    process).  A CUDA rank takes the device ``cuda:<local rank>``.  NCCL
    that does not come up raises: there is no fallback to gloo or the
    CPU.  ``parallel.num_devices`` is checked before any group forms.
    A collective or barrier of the group fails after
    ``parallel.group_timeout_s``."""
    source = _source(cfg)
    _check_num_devices(cfg, source[1] if source else 1)
    if source is None:
        return Ranks()
    init_method, world, rank, local_rank = source
    if cfg.platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("parallel.platform=cuda but no CUDA device is "
                               "visible (use --parallel.platform cpu)")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif cfg.platform == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unknown parallel.platform {cfg.platform!r} "
                         "(expected cuda | cpu)")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=cfg.group_timeout_s))
    return Ranks(dist.group.WORLD, rank, world, local_rank)


def names_a_group(cfg) -> bool:
    """Whether ``cfg``'s coordinator knobs or the ``torchrun`` environment
    name a process group (checked before any group forms)."""
    return _source(cfg) is not None


def initialize_serving(cfg) -> tuple:
    """Join the process group that ``cfg`` (a ParallelConfig) or the
    ``torchrun`` environment names, to serve on a grid
    (``parallel/devices.py::Grid``): -> (:class:`Ranks`, this rank's
    device group), or (``Ranks()``, None) with neither source.  A CUDA
    rank holds G cards, :func:`~milnce_tpu_torch.parallel.devices.
    rank_cards` of ``LOCAL_RANK`` among ``LOCAL_WORLD_SIZE`` (default 0
    of 1: a rank a host, as the coordinator knobs start them), and sets
    the first as its current card; a CPU rank holds one CPU device.
    ``parallel.num_devices`` (0: no check) must equal W x G.  NCCL on
    ``cuda``, gloo on ``cpu``; a collective fails after
    ``parallel.group_timeout_s``.  The trainer's
    :func:`initialize_distributed` (one rank a card) is not this."""
    from milnce_tpu_torch.parallel.devices import rank_cards

    source = _source(cfg)
    if source is None:
        return Ranks(), None
    init_method, world, rank, _ = source
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if cfg.platform == "cuda":
        devices = rank_cards(local_rank,
                             int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        backend = "nccl"
    elif cfg.platform == "cpu":
        devices, backend = ["cpu"], "gloo"
    else:
        raise ValueError(f"unknown parallel.platform {cfg.platform!r} "
                         "(expected cuda | cpu)")
    n = int(cfg.num_devices or 0)
    if n and n != world * len(devices):
        raise ValueError(f"parallel.num_devices={n} differs from the grid's "
                         f"{world} ranks x {len(devices)} devices")
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=cfg.group_timeout_s))
    return Ranks(dist.group.WORLD, rank, world, local_rank), devices


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(R, ...) on every rank -> (W*R, ...) in rank order, on ``x``'s
    device, outside autograd: over NCCL from the card, over gloo through
    the host."""
    hop = (x.device if dist.get_backend(group) == "nccl"
           else torch.device("cpu"))
    return _gather_cat(x.to(hop), group).to(x.device)


def broadcast_str(value: str, group=None, max_len: int = 64) -> str:
    """Every rank returns rank 0's ``value`` (utf-8, truncated to
    ``max_len`` bytes), over ``group`` (port of
    ``milnce_tpu/parallel/mesh.py::broadcast_str``): the run's one
    ``run_id``.  No group is a pass-through.  Over NCCL the rank's CUDA
    device must be set first, as :func:`initialize_distributed` does."""
    if group is None:
        return value
    box = [value.encode("utf-8")[:max_len].decode("utf-8", "ignore")]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


# ------------------------------------------------ differentiable collectives
def _gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return _gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return grad[start:start + ctx.rows], None


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """(B, ...) on every rank -> (W*B, ...) in rank order; the backward
    sums the cotangent over the ranks and returns this rank's slice."""
    return _AllGatherTiled.apply(x, group)


class _PsumIdentityGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_identity_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks, whose gradient is that of the local term."""
    return _PsumIdentityGrad.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks; the backward sums the cotangents, since
    every rank's term reads the sum."""
    return _AllReduceSum.apply(x, group)


# ------------------------------------------------------ the step's reductions
def all_reduce_flat(tensors: list, group, mean: bool = False) -> None:
    """Sum (or average) ``tensors`` over the ranks in place, through one
    flat buffer: one collective, as the JAX 1-D step's fused psum."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class IssueQueue:
    """Collectives issued in one fixed order, whatever order their inputs
    become final in: ``ready(i)`` marks item ``i`` (a position in that
    order) final and issues the ready prefix of the order as it grows;
    :meth:`flush` issues the rest.  Every rank that builds the queue over
    the same order issues the same collectives in the same sequence on
    each communicator, which NCCL and gloo need (they match a group's
    collectives by their position), even when the ranks see their inputs
    become final in different orders."""

    def __init__(self, n: int, issue):
        self.n, self.issue = n, issue
        self.reset()

    def reset(self) -> None:
        self._ready = [False] * self.n
        self._next = 0

    def ready(self, i: int) -> None:
        self._ready[i] = True
        while self._next < self.n and self._ready[self._next]:
            self._next += 1
            self.issue(self._next - 1)

    def flush(self, present) -> None:
        """Issue, in order, every item not issued yet for which
        ``present(i)`` holds (an item with no input this time is skipped
        on every rank alike)."""
        while self._next < self.n:
            self._next += 1
            if self._ready[self._next - 1] or present(self._next - 1):
                self.issue(self._next - 1)


# ------------------------------------------------------------ host verdicts
def _verdict_device(group) -> torch.device:
    """NCCL takes CUDA tensors only (on this rank's current card); gloo
    takes CPU tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_flag(flag: bool, group) -> bool:
    """The MAX of one flag over the ranks of ``group`` (port of
    ``milnce_tpu/parallel/mesh.py::make_flag_reducer``): every rank that
    calls it at the same step gets the same verdict, True when any rank's
    flag is.  No group is a pass-through."""
    if group is None:
        return bool(flag)
    box = torch.tensor([int(bool(flag))], dtype=torch.int32,
                       device=_verdict_device(group))
    dist.all_reduce(box, op=dist.ReduceOp.MAX, group=group)
    return bool(box.item())


def reduce_flag_device(flag: torch.Tensor, group) -> torch.Tensor:
    """The MAX of a 0-d flag tensor over the ranks of ``group``, in place
    and on its device: no host read (the JAX 2-D guarded step's one extra
    psum).  No group is a pass-through."""
    if group is not None:
        dist.all_reduce(flag.view(1), op=dist.ReduceOp.MAX, group=group)
    return flag


def gather_floats(value: float, group) -> list:
    """Every rank's ``value`` in rank order, on every rank (one float a
    rank, so that rank 0 can feed the straggler policy).  No group gives
    ``[value]``."""
    if group is None:
        return [float(value)]
    x = torch.tensor([float(value)], dtype=torch.float64,  # graftlint: disable=GL004(one host float a rank, gathered as it is: the straggler policy reads seconds)
                     device=_verdict_device(group))
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return [float(p.item()) for p in parts]


def gather_arrays(x: np.ndarray, group) -> list:
    """Every rank's ``x`` (one shape and dtype on every rank) in rank
    order, on every rank, as host arrays.  No group gives ``[x]``."""
    if group is None:
        return [x]
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_verdict_device(group))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return [p.cpu().numpy() for p in parts]


def gather_objects(obj, group) -> list:
    """Every rank's picklable ``obj`` in rank order, on every rank.  No
    group gives ``[obj]``."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
