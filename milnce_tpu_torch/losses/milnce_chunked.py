"""Memory-efficient MIL-NCE: the similarity cube streamed instead of
materialized (port of ``milnce_tpu/losses/milnce_chunked.py``).

The loss needs only per-row and per-column logsumexps of the cube.
``ops/milnce_stream.py`` computes them with running (max, sum) pairs and
a backward that recomputes the logits, so nothing O(B * Bg * K) is held.
``loss.milnce_backend`` picks the stream: ``scan`` the plain PyTorch
twin, ``cuda`` the hand kernels, ``auto`` the kernels for CUDA tensors
and the plain twin for CPU tensors.  The kernels take any D: up to
``STREAM_DMAX`` they hold a row of D on chip, past it they run their
deep mode (each kernel split over a thread-block cluster by depth).
Semantics are identical to
:func:`milnce_tpu_torch.losses.milnce.milnce_loss`, across ranks too:
the stream runs the local rows and columns against the gathered arrays.
A bf16 model's embeddings are gathered in bf16 and stay bf16 into the
stream (the kernels' bf16 mode), which upcasts the local ones; the
positive bag's dot products are taken in bf16, then cast to f32, as in
the JAX loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from milnce_tpu_torch.config import MILNCE_BACKENDS
from milnce_tpu_torch.losses.milnce import milnce_loss
from milnce_tpu_torch.ops.milnce_stream import (milnce_stream,
                                                milnce_stream_cuda,
                                                milnce_stream_plain)
from milnce_tpu_torch.parallel.dist import (all_gather_tiled,
                                            psum_identity_grad)

MILNCE_IMPLS = ("dense", "chunked", "auto")
_STREAMS = {"auto": milnce_stream, "scan": milnce_stream_plain,
            "cuda": milnce_stream_cuda}

# impl='auto' switches to the stream once two (B_local, Bg, K) f32 cubes
# plus their autograd-saved twins pass this budget.
DENSE_CUBE_BUDGET_BYTES = 64 * 2 ** 20

# chunk=0 targets this many row-logits elements per streamed block
_CHUNK_TARGET_ELEMS = 512 * 1024


def milnce_default_chunk(b_local: int, k: int, b_global: int) -> int:
    """The chunk=0 rule: global samples per streamed block, a multiple of
    8 and never larger than the gathered batch."""
    if b_global <= 8:
        return b_global
    c = max(8, min(b_global, _CHUNK_TARGET_ELEMS // max(1, b_local * k)))
    return max(8, c // 8 * 8)


def prefers_chunked(b_local: int, b_global: int, k: int) -> bool:
    """impl='auto' shape rule: stream once the dense cubes + autograd twins
    exceed :data:`DENSE_CUBE_BUDGET_BYTES`."""
    return 4 * b_local * b_global * k * 4 > DENSE_CUBE_BUDGET_BYTES


def resolve_impl(impl: str, b_local: int, b_global: int, k: int) -> str:
    """impl 'auto' -> 'chunked' or 'dense' by :func:`prefers_chunked` for
    ``b_local`` clips of ``k`` captions a rank scored against
    ``b_global`` gathered ones; any other impl as it is."""
    if impl == "auto":
        return ("chunked" if prefers_chunked(b_local, b_global, k)
                else "dense")
    return impl


def milnce_route(loss_cfg, b_local: int, b_global: int, k: int,
                 device_type: str) -> str:
    """Where MIL-NCE under ``loss_cfg`` runs for ``b_local`` clips of
    ``k`` captions against ``b_global`` gathered clips held on a
    ``device_type`` device: 'dense', or the stream it takes, 'cuda' (the
    kernels) or 'scan' (the plain twin).  Backend ``auto`` takes the
    kernels on a CUDA device, the plain twin elsewhere."""
    impl = getattr(loss_cfg, "milnce_impl", "dense") or "dense"
    backend = getattr(loss_cfg, "milnce_backend", "auto") or "auto"
    if resolve_impl(impl, b_local, b_global, k) == "dense":
        return "dense"
    if backend == "auto":
        return "cuda" if device_type == "cuda" else "scan"
    return backend


def milnce_loss_chunked(video_embd: torch.Tensor, text_embd: torch.Tensor,
                        group=None, chunk: int = 0,
                        backend: str = "auto") -> torch.Tensor:
    """MIL-NCE with the cube streamed.  video_embd (B, D), text_embd
    (B*K, D) sample-major; ``group`` the ranks to gather negatives over
    (None = this process alone); ``chunk`` global samples per block of
    the plain stream (0 = :func:`milnce_default_chunk`)."""
    if backend not in MILNCE_BACKENDS:
        raise ValueError(f"unknown milnce backend {backend!r} (expected "
                         f"one of {', '.join(MILNCE_BACKENDS)})")
    b, d = video_embd.shape
    if text_embd.shape[0] % b:
        raise ValueError(f"text rows {text_embd.shape[0]} are not a multiple "
                         f"of the video batch {b}")
    k = text_embd.shape[0] // b
    if group is None:
        v_all, t_all = video_embd, text_embd
    else:
        v_all = all_gather_tiled(video_embd, group)
        t_all = all_gather_tiled(text_embd, group)
    b_global = v_all.shape[0]
    if chunk <= 0:
        chunk = milnce_default_chunk(b, k, b_global)
    chunk = min(int(chunk), b_global)
    row_lse, col_flat = _STREAMS[backend](video_embd, text_embd, v_all,
                                          t_all, chunk)
    # positive bag: diag[i, k] = v_i . t_{i,k}, local by construction
    diag = torch.einsum("bd,bkd->bk", video_embd,
                        text_embd.reshape(b, k, d)).float()
    numerator = torch.logsumexp(diag, dim=1)
    # column half: lse over (Bg, K) = lse over K of the per-(i, k) lse
    col_lse = torch.logsumexp(col_flat.reshape(b, k), dim=1)
    denominator = torch.logaddexp(row_lse, col_lse)
    local_sum = (denominator - numerator).sum()
    if group is not None:
        local_sum = psum_identity_grad(local_sum, group)
    return local_sum / b_global


def build_milnce_loss(loss_cfg, group=None):
    """LossConfig -> ``fn(video_embd, text_embd)`` over the ranks of
    ``group`` (None = this process alone); bad knob values fail here,
    before any model runs."""
    impl = getattr(loss_cfg, "milnce_impl", "dense") or "dense"
    chunk = int(getattr(loss_cfg, "milnce_chunk", 0) or 0)
    backend = getattr(loss_cfg, "milnce_backend", "auto") or "auto"
    if impl not in MILNCE_IMPLS:
        raise ValueError(f"unknown loss.milnce_impl {impl!r} (expected "
                         f"one of {', '.join(MILNCE_IMPLS)})")
    if backend not in MILNCE_BACKENDS:
        raise ValueError(f"unknown loss.milnce_backend {backend!r} "
                         f"(expected one of {', '.join(MILNCE_BACKENDS)})")
    world = 1 if group is None else dist.get_world_size(group)

    def loss_fn(video_embd, text_embd):
        b = video_embd.shape[0]
        k = text_embd.shape[0] // b
        if resolve_impl(impl, b, b * world, k) == "dense":
            return milnce_loss(video_embd, text_embd, group)
        return milnce_loss_chunked(video_embd, text_embd, group, chunk=chunk,
                                   backend=backend)

    return loss_fn
