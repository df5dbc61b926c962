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
tensors; for CUDA tensors it launches the kernels or raises.  Up to
:data:`STREAM_DMAX` a kernel holds a row of D on chip (the held mode);
past it each kernel runs its deep mode (the plan's ``mode``): it splits D
into :func:`deep_parts` over a thread-block cluster up to
:data:`CLUSTER_REACH` (``deep``) and past it streams both operands in
depth slabs (``deep_slab``).  On both deep paths every kernel computes a
logit as the parts' chains summed in rank order, so the forward's and the
backward's logits are equal bit for bit; the plain twins sum the same
parts when given them (``parts``).

The bf16 mode (a bf16 model, JAX ``model.dtype = bfloat16``): the
gathered operands ``v_all``/``t_all`` stay bf16, as the JAX kernels take
them (``milnce_tpu/ops/milnce_pallas.py`` pads them uncast and upcasts
each chunk inside the kernel); the local ``v``/``t`` are upcast to f32.
Each kernel widens the bf16 operand to f32 as it copies it on chip, and
every product and sum stays f32 (no bf16 tensor-core product: A is
f32), so each output equals the f32 mode's on the operand widened, bit
for bit (dB rounded to bf16).  ``lse_bwd_cols`` writes the gathered
gradients in bf16, each f32 sum rounded once; ``g_v``/``g_t`` come back
in the local operands' dtype.
The plain twins follow the same contract: each block upcast to f32, the
gathered gradients rounded to their operand's dtype a block at a time.

``LAUNCHES`` counts kernel launches, one per launch, under the kernel's
name, the cluster path's under the name with ``_deep`` added and the
slab path's with ``_deep_slab``, each with ``_bf16`` after it in the bf16
mode, so a run can show that it went through the kernels and in which
mode; ``cuda_build.check_launch`` hands the same name to the op trace's
launch hooks.

On the ``meta`` device (the memory planner, ``analysis/memplan.py``) the
kernel path runs as on the card with the launch left out: the same plan
(an H100's SM count and resident clusters), the same scratch and output
allocations, and the launch noted to the hooks (``cuda_build.
note_launch``), not counted in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from milnce_tpu_torch.ops import cuda_build
from milnce_tpu_torch.ops.softdtw import BIG

KERNELS = ("lse_fwd", "lse_bwd_rows", "lse_bwd_cols")
# the gathered operand's dtypes the kernels take, and the key suffix of each
ELEMENT_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
LAUNCHES = {f"{name}{mode}{elem}": 0 for elem in ELEMENT_SUFFIX.values()
            for mode in ("", "_deep", "_deep_slab") for name in KERNELS}


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


def lse_plain(a: torch.Tensor, b: torch.Tensor, width: int,
              parts=None) -> torch.Tensor:
    """Online logsumexp of ``a @ b.T`` over blocks of ``width`` columns;
    with ``parts`` the logits are summed over those depth parts."""
    af = a.float()
    c = b.shape[0]
    m = torch.full((a.shape[0],), -math.inf, device=a.device)
    s = torch.zeros((a.shape[0],), device=a.device)
    for start, blk in _blocks(b, width):
        x = _logits(af, blk, parts)
        x = torch.where(_mask(start, width, c, a.device)[None, :], x, -BIG)
        mn = torch.maximum(m, x.amax(dim=1))
        s = s * torch.exp(m - mn) + torch.exp(x - mn[:, None]).sum(dim=1)
        m = mn
    return m + torch.log(s)


def _logits(af, blk, parts):
    """af @ blk.T, or with ``parts`` (:func:`deep_parts`) the partial
    products over each depth part summed in part order, as the deep paths
    sum them."""
    if not parts:
        return af @ blk.T
    x = None
    for k0, width in parts:
        p = af[:, k0:k0 + width] @ blk[:, k0:k0 + width].T
        x = p if x is None else x + p
    return x


def _weights(af, blk, start, width, c, lse, g, parts=None):
    x = _logits(af, blk, parts)
    ok = _mask(start, width, c, af.device)[None, :]
    return torch.where(ok, torch.exp(x - lse[:, None]), 0.0) * g[:, None]


def lse_bwd_rows_plain(a, b, lse, g, width: int, parts=None) -> torch.Tensor:
    """dA (R, D) = sum_j w_rj B_j, streamed over blocks of ``width``; with
    ``parts`` the logits are summed over those depth parts."""
    af, lse, g = a.float(), lse.float(), g.float()
    out = torch.zeros_like(af)
    for start, blk in _blocks(b, width):
        out += _weights(af, blk, start, width, b.shape[0], lse, g, parts) @ blk
    return out.to(a.dtype)


def lse_bwd_cols_plain(a, b, lse, g, width: int, parts=None) -> torch.Tensor:
    """dB (C, D) = sum_r w_rj A_r, one block of ``width`` rows at a time,
    each cast to ``b``'s dtype; with ``parts`` the logits are summed over
    those depth parts."""
    af, lse, g = a.float(), lse.float(), g.float()
    c = b.shape[0]
    out = [(_weights(af, blk, start, width, c, lse, g, parts).T
            @ af).to(b.dtype) for start, blk in _blocks(b, width)]
    return torch.cat(out)[:c]


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
        lib.milnce_lse_fwd.argtypes = [_P, _P, _P, _P, *[_I] * 12, _P]
        lib.milnce_lse_bwd.argtypes = [_P, _P, _P, _P, _P, _P, *[_I] * 12,
                                       _P]
        lib.milnce_bwd_clusters.argtypes = [_I, _I]
        lib.milnce_fwd_clusters.argtypes = [_I]
        for fn in (lib.milnce_lse_fwd, lib.milnce_lse_bwd,
                   lib.milnce_bwd_clusters, lib.milnce_fwd_clusters):
            fn.restype = ctypes.c_int
        lib.milnce_bwd_rows_smem.argtypes = [_I, _I, _I]
        lib.milnce_fwd_smem.argtypes = [_I, _I, _I, _I]
        for fn in (lib.milnce_bwd_rows_smem, lib.milnce_fwd_smem):
            fn.restype = ctypes.c_size_t
        lib._milnce_typed = True
    return lib


def _check_operands(name: str, a, b, *rows) -> None:
    """A and the per-row vectors f32; B (the gathered operand) f32 or
    bf16."""
    for x in (a, b, *rows):
        if not (x.is_cuda or x.is_meta):
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"one on {x.device}")
        if x is b:
            if x.dtype not in ELEMENT_SUFFIX:
                raise TypeError(f"{name}: the kernel takes a float32 or "
                                f"bfloat16 B, got {x.dtype}")
        elif x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes a float32 A, lse and "
                            f"g, got {x.dtype}")
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


ROWS_INSTANCES = (256, 512, 768)   # held instances of every mode: D <= each
STREAM_DMAX = ROWS_INSTANCES[-1]   # the largest depth held on chip; past it
                                   # the deep mode
ROWS_BM, ROWS_THREADS = 32, 256
_ROWS_BK, _ROWS_STAGES = 32, 3
# the forward's (owned rows, streamed tile) for each held instance (the
# slab path's those of STREAM_DMAX)
FWD_TILES = {256: (64, 128), 512: (64, 128), 768: (32, 256)}
# the cluster path: depth parts of at most CLUSTER_DMAX, one block each, at
# most CLUSTER_MAX blocks (a portable cluster)
CLUSTER_DMAX, CLUSTER_MAX = 512, 8
CLUSTER_REACH = CLUSTER_DMAX * CLUSTER_MAX
# the forward's cluster path's (owned rows, streamed tile): 32 x 256, 1-2 %
# faster than 64 x 128 (PERF.md)
FWD_CLUSTER_TILES = (32, 256)
# clusters of nz blocks of the cluster path (one block an SM) that an H100
# 80GB HBM3 (132 SMs, in GPCs of unequal size) keeps resident at once,
# every kernel's instance (cudaOccupancyMaxActiveClusters, printed by
# ops/rows_probe.py --accuracy): the plan's wave where no card is asked
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# the mode codes of milnce_lse_fwd and milnce_lse_bwd
_MODES = {"held": 0, "deep": 1, "deep_slab": 2}


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """How a launch of the ``rows::`` kernel family runs: it owns ``bm``
    rows of one operand a block and streams the other in tiles of ``bn``
    rows.  Instance ``dmax``, a grid of (row_tiles, nsplit, nz) blocks of
    ``threads``, row_tiles owned tiles, split y covering streamed tiles
    ``tiles(y)`` of ``col_tiles``, partials in a ``scratch`` tensor:
    (nsplit, owned rows, D) of gradient in the backward, (nsplit, R) of
    maxima and as many of sums in the forward.  ``lse_fwd`` and
    ``lse_bwd_rows`` own A and stream B, ``lse_bwd_cols`` owns B and
    streams A.  ``mode`` is ``held`` (the owned tile on chip at full depth,
    D <= dmax) or, past STREAM_DMAX, ``deep``: clusters of ``nz`` blocks,
    block z holding depth part ``parts[z]`` of the owned rows, of which
    the card keeps ``clusters`` resident at once (the cluster path); or
    ``deep_slab`` (past CLUSTER_REACH, or on request): both operands
    streamed in depth slabs, the backward's ``nz`` gradient slabs of
    ``dmax`` depths one a grid z-index, each recomputing the full-depth
    logits.  Both deep paths sum the logits over ``parts``."""
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
    mode: str = "held"
    nz: int = 1
    parts: tuple = ()
    clusters: int = 0

    def tiles(self, split: int) -> range:
        return range(split * self.tps,
                     min(self.col_tiles, (split + 1) * self.tps))


def check_depth(name: str, d: int) -> tuple[int, str]:
    """(instance, mode) for depth ``d``: the smallest held instance that
    holds it, or past :data:`STREAM_DMAX` the deep mode (its instance is
    tagged STREAM_DMAX).  Raises for d < 1."""
    if d < 1:
        raise ValueError(f"{name}: depth {d}, expected at least 1")
    if d > STREAM_DMAX:
        return STREAM_DMAX, "deep"
    return next(x for x in ROWS_INSTANCES if d <= x), "held"


def deep_parts(d: int) -> list[tuple[int, int]]:
    """The depth parts [(k0, width), ...] of the deep paths at depth
    ``d``: ceil(d / CLUSTER_DMAX) parts of one width, ceil(d /
    parts) rounded up to a multiple of 32 (a logits slab), the last
    taking the remainder.  They cover 0 .. d - 1 once."""
    nz = -(-d // CLUSTER_DMAX)
    per_part = -(-d // nz)
    width = -(-per_part // _ROWS_BK) * _ROWS_BK
    return [(k0, min(width, d - k0)) for k0 in range(0, d, width)]


def launch_mode(name: str, d: int, slab: bool = False
                ) -> tuple[int, str, int]:
    """(instance, mode, nz) of a launch of kernel ``name`` at depth ``d``:
    the smallest held instance that holds it; past :data:`STREAM_DMAX` the
    cluster path (``deep``: instance CLUSTER_DMAX, nz depth parts) up to
    :data:`CLUSTER_REACH`; past it, or with ``slab``, the slab path
    (``deep_slab``: instance STREAM_DMAX, nz gradient slabs in the
    backward, 1 in the forward)."""
    dmax, mode = check_depth(name, d)
    if mode == "held":
        return dmax, mode, 1
    if d <= CLUSTER_REACH and not slab:
        return CLUSTER_DMAX, "deep", len(deep_parts(d))
    return (STREAM_DMAX, "deep_slab",
            1 if name == "lse_fwd" else -(-d // STREAM_DMAX))


def launch_key(name: str, d: int, dtype=torch.float32,
               slab: bool = False) -> str:
    """The ``LAUNCHES`` key under which a launch of kernel ``name`` at
    depth ``d`` (``slab`` as in :func:`launch_mode`) with a gathered
    operand of ``dtype`` counts."""
    return _key(name, launch_mode(name, d, slab)[1], dtype)


def _key(name: str, mode: str, dtype) -> str:
    """The ``LAUNCHES`` key of a launch of ``name`` in ``mode`` (a plan's)
    with a gathered operand of ``dtype``."""
    mode = "" if mode == "held" else f"_{mode}"
    return f"{name}{mode}{ELEMENT_SUFFIX[dtype]}"


def _plan(dmax: int, owned: int, streamed: int, d: int, sms: int, bm: int,
          sn: int, smem: int, scratch: tuple, mode: str, nz: int,
          clusters: int | None) -> RowsPlan:
    """The fewest streamed tiles per split that keep the grid to one wave
    of (row tile, split) units: on the cluster path of ``clusters``
    clusters (the card's count, else the H100's, :data:`H100_CLUSTERS`),
    else of one block an SM for each of the ``nz`` (a grid past one wave
    only when the owned tiles alone pass it); the deep paths' depth
    parts."""
    parts = () if mode == "held" else tuple(deep_parts(d))
    if mode == "deep":
        slots = clusters = H100_CLUSTERS[nz] if clusters is None else clusters
    else:
        slots, clusters = sms // nz, 0
    row_tiles, col_tiles = -(-owned // bm), -(-streamed // sn)
    per_row = min(col_tiles, max(1, slots // row_tiles))
    tps = -(-col_tiles // per_row)
    nsplit = -(-col_tiles // tps)
    return RowsPlan(dmax, bm, sn, ROWS_THREADS, row_tiles, col_tiles, nsplit,
                    tps, smem, (nsplit, *scratch), mode, nz, parts, clusters)


def _bwd_plan(name: str, owned: int, streamed: int, d: int, sms: int,
              sn: int, clusters: int | None, slab: bool) -> RowsPlan:
    """The mode of :func:`launch_mode`; 32 owned rows a block."""
    dmax, mode, nz = launch_mode(name, d, slab)
    nb = 32 if dmax <= 256 else 8          # streamed rows of a product slab
    streamed_owned = mode == "deep_slab"
    stage = max((sn + ROWS_BM * streamed_owned) * _ROWS_BK, nb * dmax)
    held = 0 if streamed_owned else ROWS_BM * (dmax + 4)
    partial = 0 if mode == "held" else ROWS_BM * sn
    smem = 4 * (held + 4 * (8 * sn + 4) + _ROWS_STAGES * stage + 2 * ROWS_BM
                + partial)
    return _plan(dmax, owned, streamed, d, sms, ROWS_BM, sn, smem,
                 (owned, d), mode, nz, clusters)


def fwd_plan(r: int, c: int, d: int, sms: int, clusters: int | None = None,
             slab: bool = False) -> RowsPlan:
    """The launch plan of ``lse_fwd`` for A (r, d), B (c, d) on a card with
    ``sms`` SMs (holding ``clusters`` clusters of the cluster path at
    once): blocks own 64 rows of A and stream B in 128-row tiles (32 rows
    and 256-row tiles at D <= 768, where 64 rows of A would leave no room
    for the ring).  Past it the cluster path in :data:`FWD_CLUSTER_TILES`,
    each block holding its depth part of the rows and a tile of partial
    logits; past CLUSTER_REACH, or with ``slab``, the slab
    path: the 768 instance's tiles, the A rows streamed in each stage
    beside B's, a tile of the finished parts' logits."""
    dmax, mode, nz = launch_mode("lse_fwd", d, slab)
    if mode == "deep":
        bm, sn = FWD_CLUSTER_TILES
        smem = 4 * (bm * (dmax + 4) + _ROWS_STAGES * sn * _ROWS_BK + bm * sn)
    elif mode == "deep_slab":
        bm, sn = FWD_TILES[dmax]
        smem = 4 * (_ROWS_STAGES * (sn + bm) * _ROWS_BK + bm * sn)
    else:
        bm, sn = FWD_TILES[dmax]
        smem = 4 * (bm * (dmax + 4) + _ROWS_STAGES * sn * _ROWS_BK)
    return _plan(dmax, r, c, d, sms, bm, sn, smem, (r,), mode, nz, clusters)


def rows_plan(r: int, c: int, d: int, sms: int, clusters: int | None = None,
              slab: bool = False) -> RowsPlan:
    """The launch plan of ``lse_bwd_rows`` for A (r, d), B (c, d) on a card
    with ``sms`` SMs (holding ``clusters`` clusters of the cluster path at
    once): blocks own 32 rows of A and stream B in 256-row tiles.
    ``slab`` takes the slab path past STREAM_DMAX."""
    return _bwd_plan("lse_bwd_rows", r, c, d, sms, 256, clusters, slab)


def cols_plan(r: int, c: int, d: int, sms: int, clusters: int | None = None,
              slab: bool = False) -> RowsPlan:
    """The launch plan of ``lse_bwd_cols`` for A (r, d), B (c, d) on a card
    with ``sms`` SMs (and ``clusters``, ``slab`` as in :func:`rows_plan`):
    blocks own 32 rows of B and stream A in 128-row tiles (a 256-row tile
    never pads A less, and pads the step's R = 128 launch by half)."""
    return _bwd_plan("lse_bwd_cols", c, r, d, sms, 128, clusters, slab)


H100_SMS = 132                     # an H100 80GB HBM3's SMs: meta's plan


def _sms(device) -> int:
    if torch.device(device).type == "meta":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_smem(name: str, query, need: int, device) -> None:
    """Raise unless the library's instance takes ``need`` bytes of shared
    memory, as the plan says (``query()``), and the card allows them
    (nothing to ask on meta)."""
    if torch.device(device).type == "meta":
        return
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
    """Whether the kernel may copy both operands four elements at a time:
    16-byte chunks of f32, 8-byte ones of bf16 (widened on the copy), so D
    a multiple of 4 and each base aligned to four elements' bytes."""
    if a.is_meta:
        return a.shape[1] % 4 == 0
    return (a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % (4 * b.element_size()) == 0)


def _lib_of(x: torch.Tensor):
    """The kernel library for a launch on ``x``'s device (None on meta:
    nothing is built or launched there)."""
    return None if x.is_meta else _lib()


def _count(name: str, plan: RowsPlan, a: torch.Tensor,
           b: torch.Tensor) -> None:
    if not a.is_meta:
        LAUNCHES[_key(name, plan.mode, b.dtype)] += 1


def lse_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel: lse_r = logsumexp_j a_r . b_j, (R,) f32; A f32, B f32 or
    bf16."""
    _check_operands("lse_fwd", a, b)
    out, plan = launch_fwd(_lib_of(a), a, b)
    _count("lse_fwd", plan, a, b)
    return out


def card_fwd_plan(lib, r: int, c: int, d: int, device) -> RowsPlan:
    """The plan :func:`launch_fwd` takes for A (r, d), B (c, d) on the card
    of ``device``: :func:`fwd_plan` on the cluster path with the card's
    resident clusters."""
    _, mode, nz = launch_mode("lse_fwd", d)
    clusters = (card_clusters(lib, "lse_fwd", nz, device)
                if mode == "deep" else None)
    return fwd_plan(r, c, d, _sms(device), clusters)


def _kw(plan: RowsPlan) -> int:
    """The deep paths' part width (every part's but the last), else 0."""
    return plan.parts[0][1] if plan.parts else 0


def launch_fwd(lib, a, b, _plan: RowsPlan | None = None
               ) -> tuple[torch.Tensor, RowsPlan]:
    """One launch of ``lib``'s forward kernel on checked operands, with
    the plan of :func:`card_fwd_plan`; then the combination of its partial
    (max, sum) pairs.  ``_plan`` replaces the plan (a timing of the slab
    path at a depth the cluster path takes).  Returns
    the lse and the plan."""
    (r, d), c = a.shape, b.shape[0]
    plan = _plan or card_fwd_plan(lib, r, c, d, a.device)
    code = _MODES[plan.mode]
    _check_smem("lse_fwd", lambda: lib.milnce_fwd_smem(
        plan.dmax, plan.bm, plan.bn, code), plan.smem_bytes, a.device)
    part_m, part_s = torch.empty((2, *plan.scratch), device=a.device)
    if a.is_meta:
        cuda_build.note_launch(_key("lse_fwd", plan.mode, b.dtype))
    else:
        err = lib.milnce_lse_fwd(
            a.data_ptr(), b.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
            r, c, d, plan.dmax, plan.bm, plan.bn, code, _kw(plan),
            plan.nsplit, plan.tps, int(_vec(a, b)),
            int(b.dtype == torch.bfloat16), cuda_build.current_stream(a))
        cuda_build.check_launch(_key("lse_fwd", plan.mode, b.dtype), err)
    m = part_m.amax(dim=0)
    return m + torch.log((part_s * torch.exp(part_m - m)).sum(dim=0)), plan


def lse_bwd_rows(a, b, lse, g) -> torch.Tensor:
    """Kernel: dA (R, D) = sum_j exp(a_r . b_j - lse_r) g_r b_j."""
    return _lse_bwd_rows_and_sums(a, b, lse, g)[0]


def _lse_bwd_rows_and_sums(a, b, lse, g):
    """:func:`lse_bwd_rows` and, on the cluster path, s_r = sum_j exp(a_r .
    b_j - lse_r) over the kernel's own logits (else None)."""
    _check_operands("lse_bwd_rows", a, b, lse, g)
    out, plan, sums = launch_bwd(_lib_of(a), a, b, lse, g, cols=False)
    _count("lse_bwd_rows", plan, a, b)
    return out, sums


def lse_bwd_cols(a, b, lse, g) -> torch.Tensor:
    """Kernel: dB (C, D) = sum_r exp(a_r . b_j - lse_r) g_r a_r, in B's
    dtype (bf16: each f32 sum rounded once)."""
    _check_operands("lse_bwd_cols", a, b, lse, g)
    out, plan, _ = launch_bwd(_lib_of(a), a, b, lse, g, cols=True)
    _count("lse_bwd_cols", plan, a, b)
    return out


_CLUSTERS: dict = {}


def card_clusters(lib, name: str, nz: int, device) -> int:
    """How many clusters of ``nz`` blocks of ``lib``'s cluster path of
    kernel ``name`` the card of ``device`` keeps resident at once
    (``cudaOccupancyMaxActiveClusters``); raises if it holds none.  On
    meta: an H100's (:data:`H100_CLUSTERS`)."""
    if torch.device(device).type == "meta":
        return H100_CLUSTERS[nz]
    with torch.cuda.device(device):
        key = (torch.cuda.current_device(), name, nz)
        if key not in _CLUSTERS:
            if name == "lse_fwd":
                n = lib.milnce_fwd_clusters(nz)
            else:
                n = lib.milnce_bwd_clusters(int(name == "lse_bwd_cols"), nz)
            if n <= 0:
                raise RuntimeError(
                    f"the card holds no cluster of {nz} blocks of "
                    f"{name}'s cluster path (query returned {n})")
            _CLUSTERS[key] = n
        return _CLUSTERS[key]


def card_bwd_plan(lib, cols: bool, r: int, c: int, d: int,
                  device) -> RowsPlan:
    """The plan :func:`launch_bwd` takes for A (r, d), B (c, d) on the card
    of ``device``: :func:`cols_plan` when ``cols``, else :func:`rows_plan`,
    on the cluster path with the card's resident clusters."""
    name = "lse_bwd_cols" if cols else "lse_bwd_rows"
    _, mode, nz = launch_mode(name, d)
    clusters = card_clusters(lib, name, nz, device) if mode == "deep" else None
    return (cols_plan if cols else rows_plan)(r, c, d, _sms(device), clusters)


def launch_bwd(lib, a, b, lse, g, cols: bool, _plan: RowsPlan | None = None
               ) -> tuple[torch.Tensor, RowsPlan, torch.Tensor | None]:
    """One launch of ``lib``'s backward kernel on checked operands: dA
    (R, D) with the plan of :func:`rows_plan`, or dB (C, D) with that of
    :func:`cols_plan` when ``cols``, on the cluster path sized by the
    card's resident clusters; then the sum of its partials.  ``_plan``
    replaces the plan (a timing of the slab path at a depth the cluster
    path takes).  Returns the gradient, the plan and, for dA on the
    cluster path, the sums (R,) of the weights before g over each row
    (else None).  dA is f32; dB is in B's dtype: with a bf16 B and one
    split the kernel writes it in bf16, with more the f32 sum of the
    splits is rounded once."""
    name = "lse_bwd_cols" if cols else "lse_bwd_rows"
    (r, d), c = a.shape, b.shape[0]
    plan = _plan or card_bwd_plan(lib, cols, r, c, d, a.device)
    code = _MODES[plan.mode]
    _check_smem(name, lambda: lib.milnce_bwd_rows_smem(plan.dmax, plan.bn,
                                                       code),
                plan.smem_bytes, a.device)
    bf16 = b.dtype == torch.bfloat16
    # the kernel writes dB in bf16 itself where B is bf16 and one split
    # covers the columns
    out16 = cols and bf16 and plan.nsplit == 1
    part = torch.empty(plan.scratch[1:] if out16 else plan.scratch,
                       dtype=b.dtype if out16 else torch.float32,
                       device=a.device)
    sums = (torch.empty(plan.scratch[:2], device=a.device)
            if plan.mode == "deep" and not cols else None)
    if a.is_meta:
        cuda_build.note_launch(_key(name, plan.mode, b.dtype))
    else:
        err = lib.milnce_lse_bwd(
            a.data_ptr(), b.data_ptr(), lse.data_ptr(), g.data_ptr(),
            part.data_ptr(), None if sums is None else sums.data_ptr(), r, c,
            d, int(cols), plan.dmax, plan.bn, code, _kw(plan), plan.nsplit,
            plan.tps, int(_vec(a, b)), int(bf16),
            cuda_build.current_stream(a))
        cuda_build.check_launch(_key(name, plan.mode, b.dtype), err)
    if out16:
        grad = part
    else:
        grad = part[0] if plan.nsplit == 1 else part.sum(dim=0)
        if cols:
            grad = grad.to(b.dtype)
    return grad, plan, None if sums is None else sums.sum(dim=0)


class _StreamCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, t, v_all, t_all):
        """The local v, t upcast to f32 (as the JAX kernels pad
        ``v.astype(f32)``); v_all, t_all in their own dtype, f32 or bf16."""
        ctx.dtypes = v.dtype, t.dtype
        v, t = v.float().contiguous(), t.float().contiguous()
        v_all, t_all = v_all.contiguous(), t_all.contiguous()
        row = lse_fwd(v, t_all)
        col = lse_fwd(t, v_all)
        ctx.save_for_backward(v, t, v_all, t_all, row, col)
        return row, col

    @staticmethod
    def backward(ctx, g_row, g_col):
        """On the cluster path the rows' gradient and the cols launch's g
        are divided by the row sum s of the weights (of the backward's own
        logits, which both modes compute bit for bit).  A guard: the
        forward's logits are the backward's bit for bit on every deep
        path, so the weights already cancel the forward's rounding and s
        is 1 up to the lse's own rounding; were they to part again, the
        division would keep the weights the exact softmax of the
        backward's logits."""
        v, t, v_all, t_all, row, col = ctx.saved_tensors
        g_row, g_col = g_row.contiguous(), g_col.contiguous()
        g_v, s_row = _lse_bwd_rows_and_sums(v, t_all, row, g_row)
        g_t, s_col = _lse_bwd_rows_and_sums(t, v_all, col, g_col)
        if s_row is not None:
            g_v, g_row = g_v / s_row[:, None], g_row / s_row
        if s_col is not None:
            g_t, g_col = g_t / s_col[:, None], g_col / s_col
        return (g_v.to(ctx.dtypes[0]), g_t.to(ctx.dtypes[1]),
                lse_bwd_cols(t, v_all, col, g_col),
                lse_bwd_cols(v, t_all, row, g_row))


def milnce_stream_cuda(v, t, v_all, t_all, chunk: int):
    """(row_lse (B,), col_lse (B*K,)) on the CUDA kernels, at any depth
    (past :data:`STREAM_DMAX` in the deep mode).  ``chunk`` is the plain
    stream's block size, kept for the same signature; the kernels tile
    columns their own way."""
    del chunk
    return _StreamCuda.apply(v, t, v_all, t_all)


def milnce_stream(v, t, v_all, t_all, chunk: int):
    """The plain stream for CPU tensors, the kernels for CUDA tensors (and
    their plan on meta)."""
    if v.is_cuda or v.is_meta:
        return milnce_stream_cuda(v, t, v_all, t_all, chunk)
    return milnce_stream_plain(v, t, v_all, t_all, chunk)
