"""The train step and the embedding functions (port of
``milnce_tpu/train/step.py``, single device).

A step takes the uint8 ``(B, T, H, W, 3)`` clip and the ``(B*K, W)``
token ids already on the device, divides the clip by 255 there, runs
both towers in train mode, the MIL-NCE loss and the backward, then the
optimizer.  With the finite guard on, a non-finite gradient keeps the
parameters, the Adam moments and the BatchNorm statistics as they were
and the schedule does not advance; the caller's step count still does,
as in the JAX step.  Multi-device data parallelism, FSDP, grad-cache and
``inner_steps`` are not ported yet.
"""

from __future__ import annotations

import torch

from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss


def _normalize(video_u8: torch.Tensor, model) -> torch.Tensor:
    """uint8 clip -> [0, 1] in the model's dtype (float32 in training)."""
    dtype = next(model.parameters()).dtype
    return video_u8.to(dtype) / 255.0


def make_train_step(model, optimizer, loss_cfg=None,
                    finite_guard: bool = False, lr_scheduler=None):
    """-> ``step(video_u8, text_ids)`` returning the loss (a 0-d tensor
    on the device), or ``(loss, skipped)`` with ``finite_guard``, where
    ``skipped`` is 1 when the update was dropped."""
    name = getattr(loss_cfg, "name", "milnce")
    if name != "milnce":
        raise NotImplementedError(f"loss {name!r} is not ported yet (the "
                                  "torch port trains MIL-NCE)")
    loss_fn = build_milnce_loss(loss_cfg)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    buffers = list(model.buffers())

    def step(video_u8: torch.Tensor, text_ids: torch.Tensor):
        model.train()
        saved = [b.clone() for b in buffers] if finite_guard else None
        optimizer.zero_grad(set_to_none=True)
        v_embd, t_embd = model(_normalize(video_u8, model), text_ids)
        loss = loss_fn(v_embd, t_embd)
        loss.backward()
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
