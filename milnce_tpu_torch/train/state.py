"""Optimizer factory (port of ``milnce_tpu/train/state.py``).

Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, as in optax)
over every parameter except the frozen word table
``text_module.word_embd``, which gets no moments.  The learning rate
comes from the schedule through ``LambdaLR``, stepped after each applied
``optimizer.step()``: update n uses ``schedule(n)``, the count *before*
the increment, exactly as ``optax.inject_hyperparams`` evaluates it (so
the first update of a warmup runs at lr 0).

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


def build_optimizer(model: torch.nn.Module, cfg: OptimConfig, schedule):
    """-> (optimizer, lr_scheduler).  ``schedule`` maps the count of
    applied updates to the learning rate."""
    params = trainable_parameters(model)
    if cfg.name == "adam":
        opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    elif cfg.name == "sgd":
        opt = torch.optim.SGD(params, lr=1.0, momentum=cfg.momentum)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    # base lr 1.0, so the lambda's value is the learning rate itself
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


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
