"""Zero-shot text->video retrieval evaluation (port of
``milnce_tpu/eval/retrieval.py``).

Shape of the reference eval scripts (eval_msrvtt.py:57-76): batched
no-grad forward of both towers, mean-pool the ``num_windows_test`` clip
embeddings per video on the host (window ensembling, eval_msrvtt.py:
68-69), then the full T x V dot-product matrix -> R@k / MedR.  Clips
reach the device as uint8 and are divided by 255 there.  The JAX version
pads each batch to its mesh's size; on one device that is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from milnce_tpu_torch.eval.metrics import compute_retrieval_metrics
from milnce_tpu_torch.train.step import make_text_embed_fn, make_video_embed_fn


def extract_retrieval_embeddings(model, source, device, batch_size: int = 16):
    """Iterate an eval source ({'video': (C,T,H,W,3) u8, 'text': (1,W)}),
    return (text_embds (N,D), video_embds (N,D)) with window-mean pooling."""
    video_fn = make_video_embed_fn(model)
    text_fn = make_text_embed_fn(model)
    v_out, t_out = [], []
    buf_v, buf_t = [], []

    def flush():
        if not buf_v:
            return
        videos = torch.from_numpy(np.stack(buf_v)).to(device)  # (B,C,T,H,W,3)
        texts = torch.from_numpy(np.stack(buf_t)).to(device)   # (B,1,W)
        b, c = videos.shape[:2]
        clip_embd = video_fn(videos.reshape((-1,) + videos.shape[2:]))
        v_out.append(clip_embd.cpu().numpy().reshape(b, c, -1).mean(axis=1))
        t_embd = text_fn(texts.reshape(-1, texts.shape[-1]))
        t_out.append(t_embd.cpu().numpy().reshape(b, -1))
        buf_v.clear()
        buf_t.clear()

    for i in range(len(source)):
        s = source.sample(i)
        buf_v.append(s["video"])
        buf_t.append(s["text"])
        if len(buf_v) == batch_size:
            flush()
    flush()
    return np.concatenate(t_out), np.concatenate(v_out)


def evaluate_retrieval(model, source, device, batch_size: int = 16) -> dict:
    t, v = extract_retrieval_embeddings(model, source, device, batch_size)
    return compute_retrieval_metrics(t @ v.T)
