"""Temporal-alignment loss family built on soft-DTW (port of
``milnce_tpu/losses/dtw_losses.py``; reference loss.py:20-134).

Pure, batch-size-generic functions of sequence embeddings ``(B, n, d)``.
The trainer runs on one device, so the "gathered" batch is the local one.
``backend`` is the ``SoftDTW`` backend: ``auto | scan | cuda``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from milnce_tpu_torch.ops.softdtw import BIG, SoftDTW, _cosine_sim


def cdtw_batch_loss(video_seq: torch.Tensor, text_seq: torch.Tensor,
                    gamma: float = 1e-5, backend: str = "auto",
                    dist: str = "", bandwidth: int = 0) -> torch.Tensor:
    """Batch-mean contrastive DTW: the reference's CDTW (loss.py:20-32)
    scores only the ``args.rank``-th anchor per step; averaging over every
    anchor is the batch-generic equivalent."""
    sdtw = SoftDTW(gamma=gamma, dist_func=dist or "cosine",
                   bandwidth=bandwidth, backend=backend)
    pairs = _all_pairs_sdtw(video_seq, text_seq, sdtw)     # pairs[i,j] =
    pos = torch.diagonal(pairs)                            #   sdtw(v_j, t_i)
    # reference anchor r scores its VIDEO against every text
    # (loss.py:29-30) -> lse over texts = column r = dim 0
    neg = torch.logsumexp(pairs, dim=0)
    return torch.mean(pos - neg)


def cdtw_loss(video_seq: torch.Tensor, text_seq: torch.Tensor, index: int,
              gamma: float = 1e-5, backend: str = "auto", dist: str = "",
              bandwidth: int = 0) -> torch.Tensor:
    """Contrastive DTW for one anchor row (reference CDTW, loss.py:20-32):
    soft-DTW(v_i, t_i) vs logsumexp over soft-DTW(v_i, t_j) for all j.
    ``index`` generalizes the reference's ``args.rank`` anchor choice."""
    sdtw = SoftDTW(gamma=gamma, dist_func=dist or "cosine",
                   bandwidth=bandwidth, backend=backend)
    b = video_seq.shape[0]
    index = int(index)
    v_i = video_seq[index:index + 1]
    t_i = text_seq[index:index + 1]
    pos = sdtw(v_i, t_i)
    neg = sdtw(v_i.expand((b,) + v_i.shape[1:]), text_seq)
    return pos - torch.logsumexp(neg, dim=0)


def sdtw_cidm_loss(video_seq: torch.Tensor, text_seq: torch.Tensor,
                   start: torch.Tensor, gamma: float = 0.1,
                   sigma: float = 10.0, lam: float = 1.0,
                   backend: str = "auto", dist: str = "", bandwidth: int = 0,
                   exact_broadcast: bool = False) -> torch.Tensor:
    """Soft-DTW + Clip-Interval-Distance-Metric regularizers (reference
    SDTW_CIDM, loss.py:34-68): clips whose start times differ by more than
    ``sigma`` are pushed apart (hinge on cosine distance), near clips are
    pulled together, with interval-dependent weights; plus the soft-DTW
    video-text alignment term.

    The clip-pair distance is the cosine distance between frame-mean
    embeddings.  ``exact_broadcast=True`` reproduces the reference's
    (B,B)x(B,n,n) broadcast at the only shape where it is defined
    (B == n == m): clip-pair weights applied to frame-pair distances."""
    sdtw = SoftDTW(gamma=gamma, dist_func=dist or "cosine",
                   bandwidth=bandwidth, backend=backend)
    interval = (start[:, None] - start[None, :]).abs()          # (B, B)
    far = torch.where(interval > sigma, 1.0, 0.0)
    w_ = interval + 1.0
    w = 1.0 / w_
    if exact_broadcast:
        b, n, m = video_seq.shape[0], video_seq.shape[1], text_seq.shape[1]
        if not b == n == m:
            raise ValueError(
                f"exact_broadcast reproduces the reference's (B,B)x(B,n,n) "
                f"broadcast, defined only when B == n (got B={b}, "
                f"video n={n}, text m={m}); use the default cleaned form "
                "for generic shapes")
        d_x = 1.0 - _cosine_sim(video_seq, video_seq, 1e-8)     # (B, n, n)
        d_y = 1.0 - _cosine_sim(text_seq, text_seq, 1e-8)

        def weight(d):
            return (far[None] * w_[None] * torch.relu(lam - d)
                    + (1 - far[None]) * w[None] * d)

        i_x = weight(d_x).sum(dim=(1, 2))
        i_y = weight(d_y).sum(dim=(1, 2))
    else:
        v_mean = video_seq.mean(dim=1)
        t_mean = text_seq.mean(dim=1)
        d_x = 1.0 - _cosine_sim(v_mean[None], v_mean[None], 1e-8)[0]
        d_y = 1.0 - _cosine_sim(t_mean[None], t_mean[None], 1e-8)[0]
        i_x = (far * w_ * torch.relu(lam - d_x)
               + (1 - far) * w * d_x).sum(dim=1)
        i_y = (far * w_ * torch.relu(lam - d_y)
               + (1 - far) * w * d_y).sum(dim=1)
    dtw = sdtw(video_seq, text_seq)
    return torch.mean(i_x + i_y + dtw)


def sdtw_negative_loss(video_seq: torch.Tensor, text_seq: torch.Tensor,
                       gamma: float = 0.1, backend: str = "auto",
                       dist: str = "", bandwidth: int = 0) -> torch.Tensor:
    """Soft-DTW positives + frame-level InfoNCE-style negatives (reference
    SDTW_negative, loss.py:70-91), with the within-clip n x m blocks of the
    (B*n, B*m) frame dot matrix masked directly."""
    sdtw = SoftDTW(gamma=gamma, dist_func=dist or "cosine",
                   bandwidth=bandwidth, backend=backend)
    b, n, d = video_seq.shape
    m = text_seq.shape[1]
    pos = sdtw(video_seq, text_seq)                          # (B,)
    pairwise = video_seq.reshape(b * n, d) @ text_seq.reshape(b * m, d).T
    clip = torch.arange(b, device=video_seq.device)
    same_clip = (clip.repeat_interleave(n)[:, None]
                 == clip.repeat_interleave(m)[None, :])
    # zero, not -inf: parity with loss.py:84 (zeros still contribute
    # exp(0) = 1 to the sum)
    pairwise = torch.where(same_clip, 0.0, pairwise)
    negative = torch.exp(pairwise).sum(dim=1).reshape(b, n).sum(dim=1)  # graftlint: disable=GL017(reference parity: loss.py:84 exponentiates raw frame dots; the cosine-normalized frames of the DTW family bound them to [-1, 1])
    return torch.mean(pos + negative / max(b - 1, 1))


def _all_pairs_sdtw(a: torch.Tensor, b_seq: torch.Tensor,
                    sdtw: SoftDTW) -> torch.Tensor:
    """(B, n, d) x (B, m, d) -> (B, B) soft-DTW of every pair,
    ``pairs[i, j] = sdtw(a_j, b_seq_i)`` (the reference's expand/reshape
    trick, loss.py:103-106)."""
    b = a.shape[0]
    rows = a[None].expand((b,) + a.shape).reshape((-1,) + a.shape[1:])
    cols = b_seq[:, None].expand((b, b) + b_seq.shape[1:])
    cols = cols.reshape((-1,) + b_seq.shape[1:])
    return sdtw(rows, cols).reshape(b, b)


def _chunk_lse(a_c, b_seq, start: int, b: int, sdtw: SoftDTW):
    """logsumexp over one chunk of anchor rows of ``-sdtw``, per row of
    ``b_seq``; pad rows past ``b`` are masked to -BIG."""
    pair_chunk = a_c.shape[0]
    rows = a_c[None].expand((b,) + a_c.shape).reshape((-1,) + a_c.shape[1:])
    cols = b_seq[:, None].expand((b, pair_chunk) + b_seq.shape[1:])
    cols = cols.reshape((-1,) + b_seq.shape[1:])
    vals = -sdtw(rows, cols).reshape(b, pair_chunk)
    ok = (start + torch.arange(pair_chunk, device=a_c.device)) < b
    vals = torch.where(ok[None, :], vals, -BIG)
    return torch.logsumexp(vals, dim=1)


def _all_pairs_sdtw_lse(a: torch.Tensor, b_seq: torch.Tensor, sdtw: SoftDTW,
                        pair_chunk: int) -> torch.Tensor:
    """``logsumexp_j(-sdtw(a_j, b_i))`` per row i of ``b_seq`` without the
    B x B pair batch: chunks of ``pair_chunk`` anchor rows are scored one
    at a time (a B * pair_chunk pair batch) into partial logsumexps,
    combined at the end.  Each chunk runs under ``torch.utils.checkpoint``,
    so the backward recomputes its DP instead of keeping B^2 saved tables
    (and, on the kernels, launches the forward kernel once more per chunk).
    """
    b = a.shape[0]
    nc = -(-b // pair_chunk)
    a_pad = F.pad(a, (0, 0, 0, 0, 0, nc * pair_chunk - b))
    parts = [checkpoint(_chunk_lse,
                        a_pad[c * pair_chunk:(c + 1) * pair_chunk], b_seq,
                        c * pair_chunk, b, sdtw, use_reentrant=False)
             for c in range(nc)]
    return torch.logsumexp(torch.stack(parts), dim=0)   # (nc, B) -> (B,)


def sdtw_3_loss(video_seq: torch.Tensor, text_seq: torch.Tensor,
                gamma: float = 0.1, backend: str = "auto", dist: str = "",
                bandwidth: int = 0, pair_chunk: int = 0) -> tuple:
    """Three NCE-over-soft-DTW terms — video<->video, video<->text,
    text<->text (reference SDTW_3, loss.py:93-134), negative-dot distance.

    ``pair_chunk > 0`` streams each term's negative logsumexp over chunks
    of that many anchor rows (:func:`_all_pairs_sdtw_lse`); 0 keeps the
    dense all-pairs form.  Each term runs the DP twice (positives, all
    pairs), so the dense loss launches 6 forward and 6 backward kernels."""
    sdtw = SoftDTW(gamma=gamma, dist_func=dist or "negative_dot",
                   bandwidth=bandwidth, backend=backend)

    def nce(x, y):
        pos = -sdtw(x, y)
        if 0 < pair_chunk < x.shape[0]:
            neg = _all_pairs_sdtw_lse(x, y, sdtw, pair_chunk)
        else:
            neg = torch.logsumexp(-_all_pairs_sdtw(x, y, sdtw), dim=1)
        return torch.mean(neg - pos)

    return (nce(video_seq, video_seq), nce(video_seq, text_seq),
            nce(text_seq, text_seq))
