"""MIL-NCE loss, dense form (port of ``milnce_tpu/losses/milnce.py``).

Similarity cube ``x[i, j, k] = v_i . t_{j,k}`` over the batch (B video
rows, B*K candidate text rows):

- numerator_i   = logsumexp_k x[i, i, k]          (positive candidate bag);
- denominator_i = logsumexp over row i AND column i of the cube (both
  retrieval directions, the reference's ``cat((x, x^T), dim=1)``), which
  counts the positives twice, as the reference does;
- loss = mean_i (denominator_i - numerator_i).

The two directions are two logsumexps of the cube combined with
``logaddexp``, so no (B, 2*B*K) concatenation is built.  Single device
only so far: gathering negatives across ranks (``torch.distributed``)
comes with a later part of the port, and ``group`` raises until then.
"""

from __future__ import annotations

import torch


def check_single_device(group) -> None:
    if group is not None:
        raise NotImplementedError(
            "MIL-NCE across ranks (group=...) is not ported yet; the torch "
            "port trains on one device")


def milnce_loss(video_embd: torch.Tensor, text_embd: torch.Tensor,
                group=None) -> torch.Tensor:
    """video_embd (B, D); text_embd (B*K, D), sample-major.  Returns the
    scalar loss."""
    check_single_device(group)
    b = video_embd.shape[0]
    if text_embd.shape[0] % b:
        raise ValueError(f"text rows {text_embd.shape[0]} are not a multiple "
                         f"of the video batch {b}")
    # one device: the local rows and the local columns are the same cube
    x = (video_embd @ text_embd.T).reshape(b, b, -1)          # (B, B, K)
    idx = torch.arange(b, device=video_embd.device)
    numerator = torch.logsumexp(x[idx, idx, :], dim=1)
    denominator = torch.logaddexp(
        torch.logsumexp(x.reshape(b, -1), dim=1),
        torch.logsumexp(x.transpose(0, 1).reshape(b, -1), dim=1))
    return (denominator - numerator).sum() / b
