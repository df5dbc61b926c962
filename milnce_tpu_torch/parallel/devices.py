"""Device groups: an ordered list of devices one process runs a model on,
a copy of the model on each (the JAX package's mesh over its local
devices, seen from one process).

The serving engine (``serving/engine.py``) splits each bucket's rows
over its group; the evals (``eval/retrieval.py``, ``eval/linear_probe.py``)
split each batch over the group of every rank.  One device is the group
of one; a group may name one card more than once (one card then runs the
whole group path).
"""

from __future__ import annotations

import copy

import torch


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
