"""3D convolution of the S3D-G trunk (port of ``milnce_tpu/models/conv3d.py``).

Only the ``native`` lowering is ported: one ``F.conv3d`` (cuDNN on the
card) on NCDHW tensors, bias-free, with torch's symmetric padding.  The
JAX package's ``fold2d`` and ``im2col`` lowerings were TPU tilings of
the same math and have no port yet; asking for them raises.

The weight is torch's ``(O, I, t, h, w)``; ``utils/torch_convert.py``
maps it to and from the JAX package's ``(t, h, w, I, O)`` kernel.  In a
bf16 model (``compute_dtype``, ``models/precision.py``) the input and the
f32 weight are cast to bf16 at the call, as Flax's ``promote_dtype``
does, and the convolution runs in bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from milnce_tpu_torch.models.precision import cast

IMPLS = ("native",)


class Conv3D(nn.Conv3d):
    """Bias-free ``nn.Conv3d`` in the compute dtype that refuses a
    lowering the port lacks."""

    compute_dtype = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, impl: str = "native"):
        if impl not in IMPLS:
            raise ValueError(f"conv impl {impl!r} is not ported (the torch "
                             f"port has: {', '.join(IMPLS)})")
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt), None)
