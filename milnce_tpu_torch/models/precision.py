"""The model's compute dtype (port of ``ModelConfig.dtype`` and the Flax
modules' ``dtype``): where a bf16 model computes in bf16 and where in f32.

The parameters stay f32 in training; a bf16 model casts each weight to
bf16 at its use (Flax ``promote_dtype``), so the gradient flows back to
the f32 parameter through the cast.  Every module of the towers that
computes carries a ``compute_dtype`` attribute, and each follows its JAX
twin:

- convolutions and :class:`Dense` layers cast input, weight and bias to
  the compute dtype;
- BatchNorm normalizes in f32 (statistics, ``x - mean`` and the scale)
  and casts its output (``models/s3dg.py::BatchNorm3d``);
- means over (T, H, W) accumulate in f32 and round once (:func:`mean`,
  ``jnp.mean``);
- the word table's rows are cast after the lookup (the same bits as
  casting the table first).

``compute_dtype`` None (a float32 model) casts nothing: the model
computes in its parameters' dtype, as it did before it had a compute
dtype (so a model moved to float64 for a parity test computes in
float64).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` -> the torch dtype; raises for one the port
    has no model for."""
    if name not in DTYPES:
        raise ValueError(f"model.dtype={name!r}: the torch port runs "
                         f"{' or '.join(DTYPES)}")
    return DTYPES[name]


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    """Give every module of ``model`` that computes (each with a
    ``compute_dtype`` attribute) the compute dtype ``dtype`` (float32:
    None, no casts); parameters and buffers keep theirs."""
    value = None if dtype == torch.float32 else dtype
    for module in model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = value


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in the compute ``dtype``; as it is for None."""
    return x if dtype is None else x.to(dtype)


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least f32: a 16-bit float upcast, any other as it is."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def mean(x: torch.Tensor, dims) -> torch.Tensor:
    """The mean of ``x`` over ``dims`` in ``x``'s dtype, accumulated in at
    least f32 and rounded once, as ``jnp.mean`` of a bf16 array."""
    if widen(x) is x:
        return x.mean(dim=dims)
    return x.mean(dim=dims, dtype=torch.float32).to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` in the compute dtype (Flax ``nn.Dense(dtype=...)``):
    input, weight and bias cast to it."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt),
                        cast(self.bias, dt))
