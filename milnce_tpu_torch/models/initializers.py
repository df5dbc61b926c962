"""Weight initializers (port of ``milnce_tpu/models/initializers.py``).

``weight_init='uniform'`` is the torch default for every Conv3d and
Linear (kaiming-uniform with a=sqrt(5), bias U(±1/sqrt(fan_in)));
``'kaiming_normal'`` re-inits the Conv3d kernels with
``kaiming_normal_(mode='fan_in', nonlinearity='relu')`` and leaves the
Linears at torch defaults, as the reference does (s3dg.py:240-246).
The word table is N(0, 1), BatchNorm scale 1 and bias 0.

Every draw takes an explicit ``torch.Generator`` so a seed fixes the
weights whatever else the process did with the global RNG.
"""

from __future__ import annotations

import math

import torch
from torch import nn

WEIGHT_INITS = ("uniform", "kaiming_normal")


@torch.no_grad()
def _torch_default_(weight: torch.Tensor, bias, gen: torch.Generator) -> None:
    nn.init.kaiming_uniform_(weight, a=math.sqrt(5), generator=gen)
    if bias is not None:
        bound = 1.0 / math.sqrt(weight[0].numel())
        nn.init.uniform_(bias, -bound, bound, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, scheme: str,
                 gen: torch.Generator) -> None:
    """Re-draw every parameter of ``model`` in module order from ``gen``."""
    if scheme not in WEIGHT_INITS:
        raise ValueError(f"unknown weight_init {scheme!r} "
                         f"(expected one of {', '.join(WEIGHT_INITS)})")
    for mod in model.modules():
        if isinstance(mod, nn.Conv3d):
            if scheme == "kaiming_normal":
                nn.init.kaiming_normal_(mod.weight, mode="fan_in",
                                        nonlinearity="relu", generator=gen)
            else:
                _torch_default_(mod.weight, None, gen)
        elif isinstance(mod, nn.Linear):
            _torch_default_(mod.weight, mod.bias, gen)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, 0.0, 1.0, generator=gen)
        elif isinstance(mod, nn.BatchNorm3d):
            mod.reset_parameters()
