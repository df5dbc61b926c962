"""Optimizer factory (port of ``milnce_tpu/train/state.py``).

Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, as in optax)
over every parameter except the frozen word table
``text_module.word_embd``, which gets no moments.  Both optimizers are
PyTorch's fused ones, so the train step's finite guard hands its
device-side verdict in as ``optimizer.found_inf`` and a non-finite step
moves no parameter, moment or step count, with no host sync.

The learning rate is a 0-d tensor on the parameters' device that every
param group reads, written by :class:`DeviceLR` from a device-side count
of applied updates: update n uses ``schedule(n)``, the count *before*
the increment, exactly as ``optax.inject_hyperparams`` evaluates it (so
the first update of a warmup runs at lr 0), and a skipped update leaves
the count, as optax's does.

On the 2-D layout the optimizer steps each sharded parameter's local
slice (``parallel/sharding_map.py``), so its moments are slices too;
:func:`local_state_bytes` counts what this rank holds (JAX
``per_device_state_bytes``).
"""

from __future__ import annotations

import torch

from milnce_tpu_torch.config import OptimConfig


def trainable_parameters(model: torch.nn.Module) -> list:
    return [p for name, p in model.named_parameters()
            if "word_embd" not in name.split(".")]


class DeviceLR:
    """The learning rate as a device function of a device-side count of
    applied updates: ``lr = schedule(count)``, with ``schedule`` called
    on the 0-d count in the parameters' float type (``cosine_with_warmup``
    computes on it; a schedule returning a Python float is written as it
    is).  float32 counts every step exactly up to 2**24.
    :meth:`advance` adds ``keep`` (a 0-d device tensor, 1 applied or 0
    skipped) to the count and rewrites the lr, with no host read.
    ``last_epoch`` reads the count on the host (checkpoints, tests)."""

    def __init__(self, optimizer, schedule):
        first = optimizer.param_groups[0]["params"][0]
        self.optimizer, self.schedule = optimizer, schedule
        # the parameters' float type: float32 on the card, float64 only
        # in the float64 parity runs
        dtype = first.dtype if first.is_floating_point() else torch.float32
        self.count = torch.zeros((), dtype=dtype, device=first.device)
        self.lr = torch.zeros((), dtype=dtype, device=first.device)
        self._write()

    def _write(self) -> None:
        value = self.schedule(self.count)
        if torch.is_tensor(value):
            self.lr.copy_(value)
        else:
            self.lr.fill_(value)
        # rebound each time: an optimizer state_dict load replaces it
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr

    def advance(self, keep: torch.Tensor | None = None) -> None:
        self.count.add_(1 if keep is None else keep)
        self._write()

    def step(self) -> None:
        self.advance()

    @property
    def last_epoch(self) -> int:
        return int(self.count)

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.count.fill_(state["last_epoch"])
        self._write()


def build_optimizer(model: torch.nn.Module, cfg: OptimConfig, schedule):
    """-> (optimizer, :class:`DeviceLR`).  ``schedule`` maps the count of
    applied updates to the learning rate.  Build it with the model on
    its device: the lr and the count live there."""
    params = trainable_parameters(model)
    if cfg.name == "adam":
        opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                               fused=True)
    elif cfg.name == "sgd":
        opt = torch.optim.SGD(params, lr=1.0, momentum=cfg.momentum,
                              fused=True)
        _seed_momentum(opt)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return opt, DeviceLR(opt, schedule)


def _seed_momentum(optimizer) -> None:
    """Zero momentum buffers for a fused SGD's parameters that have none:
    the fused kernel skips the whole update under found_inf, so a skipped
    first step must find a buffer to keep; zeros give the first update's
    buffer = grad, as unfused SGD sets it."""
    if not isinstance(optimizer, torch.optim.SGD):
        return
    for group in optimizer.param_groups:
        if group["momentum"]:
            for p in group["params"]:
                if optimizer.state[p].get("momentum_buffer") is None:
                    optimizer.state[p]["momentum_buffer"] = \
                        torch.zeros_like(p)


def load_optimizer_state(optimizer, state: dict) -> None:
    """``optimizer.load_state_dict(state)``, keeping the optimizer's own
    fused form: a load takes the saved groups' flags, and a checkpoint
    written by an unfused optimizer (``fused`` None) would otherwise
    leave a step that refuses the finite guard's ``found_inf``."""
    optimizer.load_state_dict(state)
    for group in optimizer.param_groups:
        for key in ("fused", "foreach"):
            if key in optimizer.defaults:
                group[key] = optimizer.defaults[key]
    _seed_momentum(optimizer)


def local_state_bytes(model: torch.nn.Module, optimizer,
                      params=None) -> int:
    """Bytes this rank holds of the train state: the parameters as they
    lie (a 2-D layout's sharded ones between steps: their slices), the
    buffers and every optimizer tensor (Adam's moments and step counts).
    ``params``: count only these parameters and their optimizer tensors
    of the parameter's shape (Adam's moments), no buffers."""
    def nbytes(t):
        return t.numel() * t.element_size()

    chosen = list(model.parameters()) if params is None else list(params)
    total = sum(nbytes(p) for p in chosen)
    if params is None:
        total += sum(nbytes(b) for b in model.buffers())
    for p in chosen:
        total += sum(nbytes(v) for v in optimizer.state.get(p, {}).values()
                     if torch.is_tensor(v)
                     and (params is None or v.shape == p.shape))
    return total
