"""Streamed MIL-NCE logsumexp: plain PyTorch and hand-written CUDA
(port of ``milnce_tpu/ops/milnce_pallas.py`` and of the scan stream in
``milnce_tpu/losses/milnce_chunked.py``).

The contract of both versions is the JAX ``_stream_lse_scan``:
``(v (B, D), t (B*K, D), v_all (Bg, D), t_all (Bg*K, D), chunk) ->
(row_lse (B,), col_lse (B*K,))``, the logsumexp of every local row and
column of the similarity cube, without ever holding an O(B * Bg * K)
block, and a backward that recomputes the logits.

It is one primitive applied twice: for A (R, D) and B (C, D),
``lse_r = logsumexp_j A_r . B_j``, with the rows running ``v`` against
``t_all`` and the columns ``t`` against ``v_all``.  Each primitive has a
plain version and a kernel:

=====================  =========================  ==========================
primitive              plain (any device)         kernel (csrc/milnce_stream.cu)
=====================  =========================  ==========================
forward lse            :func:`lse_plain`          :func:`lse_fwd`
dA = sum_j w_rj B_j    :func:`lse_bwd_rows_plain` :func:`lse_bwd_rows`
dB = sum_r w_rj A_r    :func:`lse_bwd_cols_plain` :func:`lse_bwd_cols`
=====================  =========================  ==========================

with ``w_rj = exp(A_r . B_j - lse_r) * g_r``.  The plain versions keep
the JAX stream's chunk layout (blocks of ``chunk`` gathered samples,
zero-padded to whole chunks, padded logits masked to ``-BIG``); the
kernels tile columns their own way, so the two agree up to summation
order.  :func:`milnce_stream` takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernels or raises.

``LAUNCHES`` counts kernel launches, one per launch, so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from milnce_tpu_torch.ops import cuda_build
from milnce_tpu_torch.ops.softdtw import BIG

LAUNCHES = {"lse_fwd": 0, "lse_bwd_rows": 0, "lse_bwd_cols": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain twins
def _blocks(b: torch.Tensor, width: int):
    """Zero-pad ``b`` (C, D) to whole blocks of ``width`` rows, in f32:
    yields (start, block)."""
    c = b.shape[0]
    nc = -(-c // width)
    pad = nc * width - c
    if pad:
        b = torch.cat([b, b.new_zeros(pad, b.shape[1])])
    for i in range(nc):
        yield i * width, b[i * width:(i + 1) * width].float()


def _mask(start: int, width: int, c: int, device) -> torch.Tensor:
    return (start + torch.arange(width, device=device)) < c


def lse_plain(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Online logsumexp of ``a @ b.T`` over blocks of ``width`` columns."""
    af = a.float()
    c = b.shape[0]
    m = torch.full((a.shape[0],), -math.inf, device=a.device)
    s = torch.zeros((a.shape[0],), device=a.device)
    for start, blk in _blocks(b, width):
        x = af @ blk.T
        x = torch.where(_mask(start, width, c, a.device)[None, :], x, -BIG)
        mn = torch.maximum(m, x.amax(dim=1))
        s = s * torch.exp(m - mn) + torch.exp(x - mn[:, None]).sum(dim=1)
        m = mn
    return m + torch.log(s)


def _weights(af, blk, start, width, c, lse, g):
    x = af @ blk.T
    ok = _mask(start, width, c, af.device)[None, :]
    return torch.where(ok, torch.exp(x - lse[:, None]), 0.0) * g[:, None]


def lse_bwd_rows_plain(a, b, lse, g, width: int) -> torch.Tensor:
    """dA (R, D) = sum_j w_rj B_j, streamed over blocks of ``width``."""
    af, lse, g = a.float(), lse.float(), g.float()
    out = torch.zeros_like(af)
    for start, blk in _blocks(b, width):
        out += _weights(af, blk, start, width, b.shape[0], lse, g) @ blk
    return out.to(a.dtype)


def lse_bwd_cols_plain(a, b, lse, g, width: int) -> torch.Tensor:
    """dB (C, D) = sum_r w_rj A_r, one block of ``width`` rows at a time,
    each cast to ``b``'s dtype."""
    af, lse, g = a.float(), lse.float(), g.float()
    c = b.shape[0]
    parts = [(_weights(af, blk, start, width, c, lse, g).T @ af).to(b.dtype)
             for start, blk in _blocks(b, width)]
    return torch.cat(parts)[:c]


class _StreamPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, t, v_all, t_all, chunk):
        k = t.shape[0] // v.shape[0]
        row = lse_plain(v, t_all, chunk * k)
        col = lse_plain(t, v_all, chunk)
        ctx.save_for_backward(v, t, v_all, t_all, row, col)
        ctx.chunk = chunk
        return row, col

    @staticmethod
    def backward(ctx, g_row, g_col):
        v, t, v_all, t_all, row, col = ctx.saved_tensors
        chunk = ctx.chunk
        ck = chunk * (t.shape[0] // v.shape[0])
        return (lse_bwd_rows_plain(v, t_all, row, g_row, ck),
                lse_bwd_rows_plain(t, v_all, col, g_col, chunk),
                lse_bwd_cols_plain(t, v_all, col, g_col, chunk),
                lse_bwd_cols_plain(v, t_all, row, g_row, ck),
                None)


def milnce_stream_plain(v, t, v_all, t_all, chunk: int):
    """(row_lse (B,), col_lse (B*K,)), plain PyTorch on any device."""
    return _StreamPlain.apply(v, t, v_all, t_all, int(chunk))


# ----------------------------------------------------------------- kernels
_SM90_SMEM_OPTIN = 232448          # bytes a block may use on an H100
_STATIC_SMEM = 4 * 2 * 16 * 68    # the kernels' ``Stage`` struct
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("milnce_stream")
    if not getattr(lib, "_milnce_typed", False):
        lib.milnce_lse_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.milnce_lse_bwd_rows.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _P]
        lib.milnce_lse_bwd_cols.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _P]
        for fn in (lib.milnce_lse_fwd, lib.milnce_lse_bwd_rows,
                   lib.milnce_lse_bwd_cols):
            fn.restype = ctypes.c_int
        lib.milnce_bwd_smem.argtypes = [_I]
        lib.milnce_bwd_smem.restype = ctypes.c_size_t
        lib._milnce_typed = True
    return lib


def _check_operands(name: str, a, b, *rows) -> None:
    for x in (a, b, *rows):
        if not x.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"one on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{name}: expected A (R, D) and B (C, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] == 0 or b.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"{name}: empty operand {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    for x in rows:
        if x.shape != (a.shape[0],):
            raise ValueError(f"{name}: per-row vector of shape "
                             f"{tuple(x.shape)}, expected ({a.shape[0]},)")
    if a.device != b.device or any(x.device != a.device for x in rows):
        raise ValueError(f"{name}: operands on different devices")


def _split(r: int, c: int, device) -> tuple:
    """(nsplit, tiles per split) of the column loop: enough blocks for
    two per SM when the row tiles alone are too few."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_tiles, col_tiles = -(-r // 64), -(-c // 64)
    nsplit = min(col_tiles, max(1, -(-2 * sms // row_tiles)))
    tps = -(-col_tiles // nsplit)
    return -(-col_tiles // tps), tps


def _check_smem(name: str, need: int, device) -> None:
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin",
                    _SM90_SMEM_OPTIN) - _STATIC_SMEM
    if need > limit:
        raise ValueError(f"{name}: depth needs {need} bytes of shared "
                         f"memory, the card allows {limit}")


def lse_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel: lse_r = logsumexp_j a_r . b_j, (R,) f32."""
    _check_operands("lse_fwd", a, b)
    lib = _lib()
    (r, d), c = a.shape, b.shape[0]
    nsplit, tps = _split(r, c, a.device)
    part_m = torch.empty((nsplit, r), device=a.device)
    part_s = torch.empty((nsplit, r), device=a.device)
    err = lib.milnce_lse_fwd(a.data_ptr(), b.data_ptr(), part_m.data_ptr(),
                             part_s.data_ptr(), r, c, d, nsplit, tps,
                             cuda_build.current_stream(a))
    cuda_build.check_launch("lse_fwd", err)
    LAUNCHES["lse_fwd"] += 1
    m = part_m.amax(dim=0)
    return m + torch.log((part_s * torch.exp(part_m - m)).sum(dim=0))


def lse_bwd_rows(a, b, lse, g) -> torch.Tensor:
    """Kernel: dA (R, D) = sum_j exp(a_r . b_j - lse_r) g_r b_j."""
    _check_operands("lse_bwd_rows", a, b, lse, g)
    lib = _lib()
    (r, d), c = a.shape, b.shape[0]
    _check_smem("lse_bwd_rows", lib.milnce_bwd_smem(d), a.device)
    nsplit, tps = _split(r, c, a.device)
    part = torch.empty((nsplit, r, d), device=a.device)
    err = lib.milnce_lse_bwd_rows(a.data_ptr(), b.data_ptr(), lse.data_ptr(),
                                  g.data_ptr(), part.data_ptr(), r, c, d,
                                  nsplit, tps, cuda_build.current_stream(a))
    cuda_build.check_launch("lse_bwd_rows", err)
    LAUNCHES["lse_bwd_rows"] += 1
    return part[0] if nsplit == 1 else part.sum(dim=0)


def lse_bwd_cols(a, b, lse, g) -> torch.Tensor:
    """Kernel: dB (C, D) = sum_r exp(a_r . b_j - lse_r) g_r a_r."""
    _check_operands("lse_bwd_cols", a, b, lse, g)
    lib = _lib()
    (r, d), c = a.shape, b.shape[0]
    _check_smem("lse_bwd_cols", lib.milnce_bwd_smem(d), a.device)
    out = torch.empty((c, d), device=a.device)
    err = lib.milnce_lse_bwd_cols(a.data_ptr(), b.data_ptr(), lse.data_ptr(),
                                  g.data_ptr(), out.data_ptr(), r, c, d,
                                  cuda_build.current_stream(a))
    cuda_build.check_launch("lse_bwd_cols", err)
    LAUNCHES["lse_bwd_cols"] += 1
    return out


class _StreamCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, t, v_all, t_all):
        v, t = v.contiguous(), t.contiguous()
        v_all, t_all = v_all.contiguous(), t_all.contiguous()
        row = lse_fwd(v, t_all)
        col = lse_fwd(t, v_all)
        ctx.save_for_backward(v, t, v_all, t_all, row, col)
        return row, col

    @staticmethod
    def backward(ctx, g_row, g_col):
        v, t, v_all, t_all, row, col = ctx.saved_tensors
        g_row, g_col = g_row.contiguous(), g_col.contiguous()
        return (lse_bwd_rows(v, t_all, row, g_row),
                lse_bwd_rows(t, v_all, col, g_col),
                lse_bwd_cols(t, v_all, col, g_col),
                lse_bwd_cols(v, t_all, row, g_row))


def milnce_stream_cuda(v, t, v_all, t_all, chunk: int):
    """(row_lse (B,), col_lse (B*K,)) on the CUDA kernels.  ``chunk`` is
    the plain stream's block size, kept for the same signature; the
    kernels tile columns their own way."""
    del chunk
    return _StreamCuda.apply(v, t, v_all, t_all)


def milnce_stream(v, t, v_all, t_all, chunk: int):
    """The plain stream for CPU tensors, the kernels for CUDA tensors."""
    if v.is_cuda:
        return milnce_stream_cuda(v, t, v_all, t_all, chunk)
    return milnce_stream_plain(v, t, v_all, t_all, chunk)
