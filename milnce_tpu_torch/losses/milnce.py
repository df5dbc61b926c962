"""MIL-NCE loss, dense form (port of ``milnce_tpu/losses/milnce.py``).

Similarity cube ``x[i, j, k] = v_i . t_{j,k}`` over the GLOBAL batch
(B video rows, B*K candidate text rows):

- numerator_i   = logsumexp_k x[i, i, k]          (positive candidate bag);
- denominator_i = logsumexp over row i AND column i of the cube (both
  retrieval directions, the reference's ``cat((x, x^T), dim=1)``), which
  counts the positives twice, as the reference does;
- loss = mean_i (denominator_i - numerator_i).

The two directions are two logsumexps of the cube combined with
``logaddexp``, so no (B, 2*B*K) concatenation is built.  Across ranks
(``group``) each rank gathers the embeddings of every rank but scores
only its LOCAL rows ``v_local @ t_all.T`` (B, Bg, K) and columns
``v_all @ t_local.T`` (Bg, B, K); the partial sums are added over the
ranks with the gradient of the local term (``psum_identity_grad``), and
the gather's backward carries the cross-rank terms back to their ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from milnce_tpu_torch.parallel.dist import (all_gather_tiled,
                                            psum_identity_grad)


def milnce_loss(video_embd: torch.Tensor, text_embd: torch.Tensor,
                group=None) -> torch.Tensor:
    """video_embd (B, D); text_embd (B*K, D), sample-major; ``group`` the
    ranks to gather negatives over (None = this process alone).  Returns
    the scalar loss, the same on every rank."""
    b = video_embd.shape[0]
    if text_embd.shape[0] % b:
        raise ValueError(f"text rows {text_embd.shape[0]} are not a multiple "
                         f"of the video batch {b}")
    if group is None:
        v_all, t_all, offset = video_embd, text_embd, 0
    else:
        v_all = all_gather_tiled(video_embd, group)
        t_all = all_gather_tiled(text_embd, group)
        offset = dist.get_rank(group) * b
    bg = v_all.shape[0]
    rows = (video_embd @ t_all.T).reshape(b, bg, -1)          # (B, Bg, K)
    # one process: the local columns are the rows' cube itself
    cols = rows if group is None else (
        (v_all @ text_embd.T).reshape(bg, b, -1))             # (Bg, B, K)
    idx = torch.arange(b, device=video_embd.device)
    numerator = torch.logsumexp(rows[idx, offset + idx, :], dim=1)
    denominator = torch.logaddexp(
        torch.logsumexp(rows.reshape(b, -1), dim=1),
        torch.logsumexp(cols.transpose(0, 1).reshape(b, -1), dim=1))
    local_sum = (denominator - numerator).sum()
    if group is not None:
        local_sum = psum_identity_grad(local_sum, group)
    return local_sum / bg
