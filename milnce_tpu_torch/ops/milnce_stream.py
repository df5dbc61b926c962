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
import dataclasses
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
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(defines=()) -> ctypes.CDLL:
    lib = cuda_build.load("milnce_stream", defines)
    if not getattr(lib, "_milnce_typed", False):
        lib.milnce_lse_fwd.argtypes = [_P, _P, _P, _P, *[_I] * 9, _P]
        lib.milnce_lse_bwd.argtypes = [_P, _P, _P, _P, _P, *[_I] * 9, _P]
        for fn in (lib.milnce_lse_fwd, lib.milnce_lse_bwd):
            fn.restype = ctypes.c_int
        lib.milnce_bwd_rows_smem.argtypes = [_I, _I]
        lib.milnce_fwd_smem.argtypes = [_I, _I, _I]
        for fn in (lib.milnce_bwd_rows_smem, lib.milnce_fwd_smem):
            fn.restype = ctypes.c_size_t
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


ROWS_INSTANCES = (256, 512, 768)   # kernel instances of every mode: D <= each
STREAM_DMAX = ROWS_INSTANCES[-1]   # the largest depth the stream kernels take
ROWS_BM, ROWS_THREADS = 32, 256
_ROWS_BK, _ROWS_STAGES = 32, 3
# the forward's (owned rows, streamed tile) for each instance
FWD_TILES = {256: (64, 128), 512: (64, 128), 768: (32, 256)}


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """How a launch of the ``rows::`` kernel family runs: it owns ``bm``
    rows of one operand a block and streams the other in tiles of ``bn``
    rows.  Instance ``dmax``, a grid of (row_tiles, nsplit) blocks of
    ``threads``, row_tiles owned tiles, split y covering streamed tiles
    ``tiles(y)`` of ``col_tiles``, partials in a ``scratch`` tensor:
    (nsplit, owned rows, D) of gradient in the backward, (nsplit, R) of
    maxima and as many of sums in the forward.  ``lse_fwd`` and
    ``lse_bwd_rows`` own A and stream B, ``lse_bwd_cols`` owns B and
    streams A."""
    dmax: int
    bm: int
    bn: int
    threads: int
    row_tiles: int
    col_tiles: int
    nsplit: int
    tps: int
    smem_bytes: int
    scratch: tuple

    def tiles(self, split: int) -> range:
        return range(split * self.tps,
                     min(self.col_tiles, (split + 1) * self.tps))


def check_depth(name: str, d: int) -> int:
    """The smallest kernel instance that holds depth ``d``; raises past
    :data:`STREAM_DMAX`."""
    if d > STREAM_DMAX:
        raise ValueError(f"{name}: depth {d} is above the largest kernel "
                         f"instance, D <= {STREAM_DMAX}")
    return next(x for x in ROWS_INSTANCES if d <= x)


def _plan(dmax: int, owned: int, streamed: int, sms: int, bm: int, sn: int,
          smem: int, scratch: tuple) -> RowsPlan:
    """The fewest streamed tiles per split that keep the grid to one wave
    of one block per SM (a grid past one wave only when the owned tiles
    alone pass it)."""
    row_tiles, col_tiles = -(-owned // bm), -(-streamed // sn)
    per_row = min(col_tiles, max(1, sms // row_tiles))
    tps = -(-col_tiles // per_row)
    nsplit = -(-col_tiles // tps)
    return RowsPlan(dmax, bm, sn, ROWS_THREADS, row_tiles, col_tiles, nsplit,
                    tps, smem, (nsplit, *scratch))


def _bwd_plan(name: str, owned: int, streamed: int, d: int, sms: int,
              sn: int) -> RowsPlan:
    """The smallest instance that holds d; 32 owned rows a block."""
    dmax = check_depth(name, d)
    nb = 32 if dmax <= 256 else 8          # streamed rows of a product slab
    stage = max(sn * _ROWS_BK, nb * dmax)
    smem = 4 * (ROWS_BM * (dmax + 4) + 4 * (8 * sn + 4)
                + _ROWS_STAGES * stage + 2 * ROWS_BM)
    return _plan(dmax, owned, streamed, sms, ROWS_BM, sn, smem, (owned, d))


def fwd_plan(r: int, c: int, d: int, sms: int) -> RowsPlan:
    """The launch plan of ``lse_fwd`` for A (r, d), B (c, d) on a card with
    ``sms`` SMs: blocks own 64 rows of A and stream B in 128-row tiles (32
    rows and 256-row tiles at D <= 768, where 64 rows of A would leave no
    room for the ring)."""
    dmax = check_depth("lse_fwd", d)
    bm, sn = FWD_TILES[dmax]
    smem = 4 * (bm * (dmax + 4) + _ROWS_STAGES * sn * _ROWS_BK)
    return _plan(dmax, r, c, sms, bm, sn, smem, (r,))


def rows_plan(r: int, c: int, d: int, sms: int) -> RowsPlan:
    """The launch plan of ``lse_bwd_rows`` for A (r, d), B (c, d) on a card
    with ``sms`` SMs: blocks own 32 rows of A and stream B in 256-row
    tiles."""
    return _bwd_plan("lse_bwd_rows", r, c, d, sms, 256)


def cols_plan(r: int, c: int, d: int, sms: int) -> RowsPlan:
    """The launch plan of ``lse_bwd_cols`` for A (r, d), B (c, d) on a card
    with ``sms`` SMs: blocks own 32 rows of B and stream A in 128-row
    tiles (a 256-row tile never pads A less, and pads the step's R = 128
    launch by half)."""
    return _bwd_plan("lse_bwd_cols", c, r, d, sms, 128)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_smem(name: str, query, need: int, device) -> None:
    """Raise unless the library's instance takes ``need`` bytes of shared
    memory, as the plan says (``query()``), and the card allows them."""
    if query() != need:
        raise RuntimeError(f"{name}: the launch plan's shared memory "
                           "disagrees with the kernel's")
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin",
                    cuda_build.SM90_SMEM_OPTIN)
    if need > limit:
        raise ValueError(f"{name}: depth needs {need} bytes of shared "
                         f"memory, the card allows {limit}")


def _vec(a, b) -> bool:
    """Whether the kernel may copy both operands in 16-byte chunks."""
    return (a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0)


def lse_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel: lse_r = logsumexp_j a_r . b_j, (R,) f32."""
    _check_operands("lse_fwd", a, b)
    out = launch_fwd(_lib(), a, b)
    LAUNCHES["lse_fwd"] += 1
    return out


def launch_fwd(lib, a, b) -> torch.Tensor:
    """One launch of ``lib``'s forward kernel on checked operands, with
    the plan of :func:`fwd_plan`; then the combination of its partial
    (max, sum) pairs."""
    (r, d), c = a.shape, b.shape[0]
    plan = fwd_plan(r, c, d, _sms(a.device))
    _check_smem("lse_fwd", lambda: lib.milnce_fwd_smem(
        plan.dmax, plan.bm, plan.bn), plan.smem_bytes, a.device)
    part_m, part_s = torch.empty((2, *plan.scratch), device=a.device)
    err = lib.milnce_lse_fwd(a.data_ptr(), b.data_ptr(), part_m.data_ptr(),
                             part_s.data_ptr(), r, c, d, plan.dmax, plan.bm,
                             plan.bn, plan.nsplit, plan.tps, int(_vec(a, b)),
                             cuda_build.current_stream(a))
    cuda_build.check_launch("lse_fwd", err)
    m = part_m.amax(dim=0)
    return m + torch.log((part_s * torch.exp(part_m - m)).sum(dim=0))


def lse_bwd_rows(a, b, lse, g) -> torch.Tensor:
    """Kernel: dA (R, D) = sum_j exp(a_r . b_j - lse_r) g_r b_j."""
    _check_operands("lse_bwd_rows", a, b, lse, g)
    out = launch_bwd(_lib(), a, b, lse, g, cols=False)
    LAUNCHES["lse_bwd_rows"] += 1
    return out


def lse_bwd_cols(a, b, lse, g) -> torch.Tensor:
    """Kernel: dB (C, D) = sum_r exp(a_r . b_j - lse_r) g_r a_r."""
    _check_operands("lse_bwd_cols", a, b, lse, g)
    out = launch_bwd(_lib(), a, b, lse, g, cols=True)
    LAUNCHES["lse_bwd_cols"] += 1
    return out


def launch_bwd(lib, a, b, lse, g, cols: bool) -> torch.Tensor:
    """One launch of ``lib``'s backward kernel on checked operands: dA
    (R, D) with the plan of :func:`rows_plan`, or dB (C, D) with that of
    :func:`cols_plan` when ``cols``; then the sum of its partials."""
    name = "lse_bwd_cols" if cols else "lse_bwd_rows"
    (r, d), c = a.shape, b.shape[0]
    plan = (cols_plan if cols else rows_plan)(r, c, d, _sms(a.device))
    _check_smem(name, lambda: lib.milnce_bwd_rows_smem(plan.dmax, plan.bn),
                plan.smem_bytes, a.device)
    part = torch.empty(plan.scratch, device=a.device)
    err = lib.milnce_lse_bwd(a.data_ptr(), b.data_ptr(), lse.data_ptr(),
                             g.data_ptr(), part.data_ptr(), r, c, d,
                             int(cols), plan.dmax, plan.bn, plan.nsplit,
                             plan.tps, int(_vec(a, b)),
                             cuda_build.current_stream(a))
    cuda_build.check_launch(name, err)
    return part[0] if plan.nsplit == 1 else part.sum(dim=0)


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
    kernels tile columns their own way.  A depth past
    :data:`STREAM_DMAX` is refused before the first launch, so that no
    forward runs only for its backward to fail."""
    del chunk
    check_depth("milnce_stream_cuda", v.shape[-1])
    return _StreamCuda.apply(v, t, v_all, t_all)


def milnce_stream(v, t, v_all, t_all, chunk: int):
    """The plain stream for CPU tensors, the kernels for CUDA tensors."""
    if v.is_cuda:
        return milnce_stream_cuda(v, t, v_all, t_all, chunk)
    return milnce_stream_plain(v, t, v_all, t_all, chunk)
