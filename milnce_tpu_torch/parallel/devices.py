"""Device groups: an ordered list of devices one process runs a model on,
a copy of the model on each (the JAX package's mesh over its local
devices, seen from one process).

The serving engine (``serving/engine.py``) splits each bucket's rows
over its group; the evals (``eval/retrieval.py``, ``eval/linear_probe.py``)
split each batch over the group of every rank.  One device is the group
of one; a group may name one card more than once (one card then runs the
whole group path).

A :class:`Grid` is a process group of such groups: W ranks (a host each
in production), each serving on its own group of G devices, W x G data
shards in rank-major, device-minor order -- the order of ``jax.devices()``
over processes, so of the JAX mesh that spans them.  With no process
group the grid is the one device group.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


def device_group(devices) -> list:
    """One device, or an ordered list of them (a group; it may name one
    card more than once), as a list of torch devices of one type.  Checked
    before anything loads: ``cuda`` without a card raises instead of
    falling back to the CPU, and so does a card that is not there; nothing
    narrows the group."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    group = [torch.device(d) for d in devices]
    if not group:
        raise ValueError("an empty device group")
    cards = [d for d in group if d.type == "cuda"]
    if cards and not torch.cuda.is_available():
        raise RuntimeError(f"device {cards[0]} requested but no CUDA device "
                           "is visible (pass device='cpu')")
    count = torch.cuda.device_count() if cards else 0
    missing = [str(d) for d in cards
               if d.index is not None and d.index >= count]
    if missing:
        raise RuntimeError(f"devices {missing} requested but only {count} "
                           "CUDA devices are visible")
    if len({d.type for d in group}) > 1:
        raise ValueError(f"a device group mixes device types: {group}")
    return group


def place_replicas(model: torch.nn.Module, group: list) -> list:
    """The model on the group's first device and a deep copy of it on each
    other one, in eval mode, in the group's order: one explicit move each,
    the model itself the first copy."""
    copies = [model] + [copy.deepcopy(model) for _ in group[1:]]
    return [m.to(dev).eval() for m, dev in zip(copies, group)]


def rank_cards(local_rank: int, local_world: int) -> list:
    """A serving rank's cards: the visible cards split into
    ``local_world`` even, contiguous parts (the ranks of one host), part
    number ``local_rank``.  No card, an uneven split or a rank outside
    the host's ranks is refused; nothing narrows or falls back."""
    if not 0 <= local_rank < local_world:
        raise ValueError(f"local rank {local_rank} outside the host's "
                         f"{local_world} ranks")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not visible:
        raise RuntimeError("a serving rank on cuda but no CUDA device is "
                           "visible (use --parallel.platform cpu)")
    if visible % local_world:
        raise ValueError(f"{visible} visible cards do not split evenly "
                         f"over the host's {local_world} ranks")
    per = visible // local_world
    return [f"cuda:{local_rank * per + j}" for j in range(per)]


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a serving grid: its device group
    (``devices``), the process group (None: this process alone), its
    rank and the world W.  Shard ``rank * G + d`` lives on device ``d``."""
    devices: tuple
    group: Optional[object] = None
    rank: int = 0
    world: int = 1

    @property
    def extent(self) -> int:
        """The data extent W x G (the JAX mesh's data axis)."""
        return self.world * len(self.devices)

    @property
    def shards(self) -> list:
        """The global shard id of each of this rank's devices."""
        g = len(self.devices)
        return [self.rank * g + d for d in range(g)]


def serving_grid(devices, process_group=None) -> Grid:
    """The grid of ``devices`` (one device or a group, checked as
    :func:`device_group` checks it) on every rank of ``process_group``.
    With a group every rank must call it at the same point, since one
    collective checks that every rank holds as many devices: a grid of
    unequal groups is refused, not narrowed."""
    group = tuple(device_group(devices))
    if process_group is None:
        return Grid(group)
    from milnce_tpu_torch.parallel.dist import gather_objects

    sizes = gather_objects(len(group), process_group)
    if len(set(sizes)) > 1:
        raise ValueError(f"the ranks' device groups differ in size {sizes}: "
                         "a grid holds G devices on every rank")
    return Grid(group, process_group, dist.get_rank(process_group),
                dist.get_world_size(process_group))
