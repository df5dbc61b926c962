"""The C++ soft-DTW recurrences on the host (port of
``milnce_tpu/native/softdtw_cpu.py``; ctypes front-end).

The exact forward and the Cuturi-Blondel E-matrix backward, threaded
over the batch: the role of the reference's numba ``nopython`` kernels
(soft_dtw_cuda.py:185-240).  A host golden check beside the plain twin
(``ops/softdtw.py``) and the CUDA kernels (``ops/softdtw_cuda.py``), on
CPU float32 tensors only: a CUDA tensor raises (copy it to the host
first).  Tables use the (B, N+2, M+2) layout of the kernels' R, with
+inf (not the plain twin's ``BIG``) on the borders and pruned cells;
``bandwidth`` 0 disables the Sakoe-Chiba band.

:func:`softdtw_native` is the differentiable form, a
``torch.autograd.Function`` whose backward calls the C++ backward.
"""

from __future__ import annotations

import ctypes

import torch

from milnce_tpu_torch.native.build import load_native_library
from milnce_tpu_torch.ops.softdtw import check_bandwidth


def _host_f32(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.device.type != "cpu":
        raise ValueError(f"the host soft-DTW takes CPU tensors; {name} is on "
                         f"{x.device}")
    return x.detach().to(torch.float32).contiguous()


def _f32p(x: torch.Tensor):
    return ctypes.cast(x.data_ptr(), ctypes.POINTER(ctypes.c_float))


def softdtw_forward_native(D: torch.Tensor, gamma: float,
                           bandwidth: int = 0):
    """D (B, N, M) -> (value (B,), R (B, N+2, M+2)), float32 on the CPU."""
    lib = load_native_library()
    D = _host_f32(D, "D")
    b, n, m = D.shape
    R = torch.empty((b, n + 2, m + 2), dtype=torch.float32)
    value = torch.empty((b,), dtype=torch.float32)
    lib.softdtw_forward_cpu(_f32p(D), _f32p(R), _f32p(value), b, n, m,
                            ctypes.c_float(gamma), int(bandwidth))
    return value, R


def softdtw_backward_native(D: torch.Tensor, R: torch.Tensor,
                            grad_out: torch.Tensor, gamma: float,
                            bandwidth: int = 0) -> torch.Tensor:
    """grad_D (B, N, M) = ``grad_out[b]`` times d value[b] / d D, from the
    forward's table R."""
    lib = load_native_library()
    D = _host_f32(D, "D")
    R = _host_f32(R, "R")
    grad_out = _host_f32(grad_out, "grad_out")
    b, n, m = D.shape
    E = torch.empty((b, n, m), dtype=torch.float32)
    lib.softdtw_backward_cpu(_f32p(D), _f32p(R), _f32p(grad_out), _f32p(E),
                             b, n, m, ctypes.c_float(gamma), int(bandwidth))
    return E


class _SoftDTWNative(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma, bandwidth):
        value, R = softdtw_forward_native(D, gamma, bandwidth)
        ctx.save_for_backward(D, R)
        ctx.gamma, ctx.bandwidth = gamma, bandwidth
        return value.to(D.dtype)

    @staticmethod
    def backward(ctx, grad):
        D, R = ctx.saved_tensors
        grad_d = softdtw_backward_native(D, R, grad, ctx.gamma,
                                         ctx.bandwidth)
        return grad_d.to(D.dtype), None, None


def softdtw_native(D: torch.Tensor, gamma: float,
                   bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW values (B,) of CPU costs D (B, N, M) on the C++ recurrence,
    differentiable: autograd's backward runs the C++ E-matrix backward.
    A band narrower than |N - M| is refused (``check_bandwidth``)."""
    check_bandwidth(D.shape[1], D.shape[2], int(bandwidth))
    return _SoftDTWNative.apply(D, float(gamma), int(bandwidth))
