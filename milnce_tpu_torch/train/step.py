"""The train step and the embedding functions (port of
``milnce_tpu/train/step.py``, the 1-D data-parallel step).

A step takes the uint8 ``(B, T, H, W, 3)`` clip, the ``(B*K, W)`` token
ids and the ``(B,)`` f32 clip start times already on the device, divides
the clip by 255 there, runs both towers in train mode, the loss and the
backward, then the optimizer.  ``loss.name`` picks the loss: ``milnce``
scores pooled embeddings; the DTW family (``cdtw``, ``sdtw_cidm``,
``sdtw_negative``, ``sdtw_3``) runs the model with ``mode="sequence"``
and scores the (B, T', D) video sequences against the (B, K, D)
candidate-text sequences; only ``sdtw_cidm`` reads ``start``.

Across the ranks of a ``group`` each rank steps its shard of the global
batch, as the JAX step's ``shard_map`` body does:

- MIL-NCE gathers the embeddings and scores the local rows and columns;
  its value is the sum over the ranks with the gradient of the local
  term, so the gradients are SUMMED over the ranks (JAX ``psum``).  The
  DTW family gathers the sequences and start times and scores the whole
  gathered batch on every rank, a replicated loss whose gradient reaches
  each rank once from every rank's copy, so the gradients are AVERAGED
  (JAX ``pmean``).  Either is one all-reduce of the flattened gradients
  after the backward, the JAX 1-D step's single fused reduction.
- After the update every BatchNorm's running mean and variance are
  averaged over the ranks (JAX ``pmean`` of ``batch_stats``).
- The finite guard judges the reduced gradients, so every rank skips
  together.  The returned loss is the global value on every rank.

With no group, nothing of that runs: the gradients are autograd's.  With
the finite guard on, a non-finite gradient keeps the parameters, the
Adam moments and the BatchNorm statistics as they were and the schedule
does not advance; the caller's step count still does, as in the JAX
step.  FSDP, grad-cache and ``inner_steps`` are not ported yet.
"""

from __future__ import annotations

import torch

from milnce_tpu_torch.losses.dtw_losses import (cdtw_batch_loss, sdtw_3_loss,
                                                sdtw_cidm_loss,
                                                sdtw_negative_loss)
from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss
from milnce_tpu_torch.parallel.dist import all_gather_tiled, all_reduce_flat

KNOWN_LOSSES = ("milnce", "cdtw", "sdtw_cidm", "sdtw_negative", "sdtw_3")


def _check_loss_name(loss_cfg) -> str:
    """Reject a bad loss name when the step is built, before any model
    runs."""
    name = getattr(loss_cfg, "name", "milnce")
    if name not in KNOWN_LOSSES:
        raise ValueError(f"unknown loss {name!r} (expected one of "
                         f"{', '.join(KNOWN_LOSSES)})")
    return name


def _sequence_loss(loss_cfg, v_seq, t_seq, start, group=None):
    """DTW-family losses on the sequence embeddings: v_seq (B, T', D),
    t_seq (B, K, D), start (B,), gathered over the ranks of ``group``
    first (the fork's losses score the whole gathered batch)."""
    if group is not None:
        v_seq = all_gather_tiled(v_seq, group)
        t_seq = all_gather_tiled(t_seq, group)
        start = all_gather_tiled(start, group)
    common = dict(backend=loss_cfg.sdtw_backend, dist=loss_cfg.sdtw_dist,
                  bandwidth=loss_cfg.sdtw_bandwidth)
    if loss_cfg.sdtw_gamma is not None:
        # None = each loss function's own reference-default gamma
        # (cdtw 1e-5, sdtw_* 0.1 — encoded in their signatures)
        common["gamma"] = loss_cfg.sdtw_gamma
    dispatch = {
        "cdtw": lambda: cdtw_batch_loss(v_seq, t_seq, **common),
        "sdtw_cidm": lambda: sdtw_cidm_loss(
            v_seq, t_seq, start, sigma=loss_cfg.cidm_sigma,
            lam=loss_cfg.cidm_lambda, **common),
        "sdtw_negative": lambda: sdtw_negative_loss(v_seq, t_seq, **common),
        "sdtw_3": lambda: sum(sdtw_3_loss(
            v_seq, t_seq, pair_chunk=loss_cfg.sdtw_pair_chunk, **common)),
    }
    return dispatch[loss_cfg.name]()


def _normalize(video_u8: torch.Tensor, model) -> torch.Tensor:
    """uint8 clip -> [0, 1] in the model's dtype (float32 in training)."""
    dtype = next(model.parameters()).dtype
    return video_u8.to(dtype) / 255.0


def _running_stats(model) -> list:
    return [buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")]


def make_train_step(model, optimizer, loss_cfg=None,
                    finite_guard: bool = False, lr_scheduler=None,
                    group=None):
    """-> ``step(video_u8, text_ids, start)`` returning the loss (a 0-d
    tensor on the device), or ``(loss, skipped)`` with ``finite_guard``,
    where ``skipped`` is 1 when the update was dropped.  ``group``: the
    ranks stepping the global batch together (None = this process
    alone).  A bad loss name or MIL-NCE knob raises here."""
    loss_name = _check_loss_name(loss_cfg)
    milnce_fn = (build_milnce_loss(loss_cfg, group) if loss_name == "milnce"
                 else None)
    params = [p for group_ in optimizer.param_groups for p in group_["params"]]
    buffers = list(model.buffers())
    running = _running_stats(model)

    def compute_loss(video_u8, text_ids, start):
        video = _normalize(video_u8, model)
        if milnce_fn is not None:
            return milnce_fn(*model(video, text_ids))
        v_seq, t_embd = model(video, text_ids, mode="sequence")
        b = video.shape[0]
        t_seq = t_embd.reshape(b, -1, t_embd.shape[-1])      # (B, K, D)
        return _sequence_loss(loss_cfg, v_seq, t_seq, start, group)

    def step(video_u8: torch.Tensor, text_ids: torch.Tensor,
             start: torch.Tensor):
        model.train()
        saved = [b.clone() for b in buffers] if finite_guard else None
        optimizer.zero_grad(set_to_none=True)
        loss = compute_loss(video_u8, text_ids, start)
        loss.backward()
        if group is not None:
            all_reduce_flat([p.grad for p in params if p.grad is not None],
                            group, mean=milnce_fn is None)
        if finite_guard:
            finite = torch.stack([torch.isfinite(p.grad).all()
                                  for p in params if p.grad is not None])
            if not bool(finite.all()):
                with torch.no_grad():
                    for buf, old in zip(buffers, saved):
                        buf.copy_(old)
                return loss.detach(), 1
        optimizer.step()
        if lr_scheduler is not None:
            lr_scheduler.step()
        if group is not None:
            with torch.no_grad():
                all_reduce_flat(running, group, mean=True)
        return (loss.detach(), 0) if finite_guard else loss.detach()

    return step


def make_video_embed_fn(model, mixed5c: bool = False):
    """No-grad eval-mode video embeddings: ``fn(video_u8) -> (B, D)``, or
    the 1024-d mixed_5c features with ``mixed5c=True``."""

    @torch.no_grad()
    def embed(video_u8: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(_normalize(video_u8, model), None, mode="video",
                     mixed5c=mixed5c)

    return embed


def make_text_embed_fn(model):
    """No-grad text embeddings: ``fn(text_ids) -> (B', D)``."""

    @torch.no_grad()
    def embed(text_ids: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(None, text_ids, mode="text")

    return embed
