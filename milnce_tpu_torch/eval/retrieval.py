"""Zero-shot text->video retrieval evaluation (port of
``milnce_tpu/eval/retrieval.py``).

Shape of the reference eval scripts (eval_msrvtt.py:57-76): batched
no-grad forward of both towers, mean-pool the ``num_windows_test`` clip
embeddings per video on the host (window ensembling, eval_msrvtt.py:
68-69), then the full T x V dot-product matrix -> R@k / MedR.  Clips
reach the device as uint8 and are divided by 255 there.  As the JAX
version over its mesh, the batches run over a device group and a process
group (``eval/shards.py``): the batch size rounded to the shard count,
the last batch padded with its last sample, every rank ending with every
sample's embeddings.

A bf16 model's embeddings are bf16, and the JAX version takes its window
mean in bf16 too (numpy over ``ml_dtypes.bfloat16``: the windows added
one by one, each sum rounded to bf16, then divided in bf16); its
similarity of two bf16 arrays is f32.  The port does the same mean on
torch's bf16 and hands the embeddings back as float32 arrays of the bf16
values (numpy has no bf16), whose f32 product is that similarity.
"""

from __future__ import annotations

import numpy as np
import torch

from milnce_tpu_torch.eval.metrics import compute_retrieval_metrics
from milnce_tpu_torch.eval.shards import EvalShards
from milnce_tpu_torch.train.step import make_text_embed_fn, make_video_embed_fn


def extract_retrieval_embeddings(model, source, device, batch_size: int = 16,
                                 process_group=None):
    """Iterate an eval source ({'video': (C,T,H,W,3) u8, 'text': (1,W)}),
    return (text_embds (N,D), video_embds (N,D)) with window-mean pooling.
    ``device``: one device or a group; ``process_group``: the ranks that
    share the source (each returns every sample's embeddings)."""
    shards = EvalShards(model, device, process_group)
    video_fns = [make_video_embed_fn(m) for m in shards.models]
    text_fns = [make_text_embed_fn(m) for m in shards.models]

    def launch(j, samples):
        dev = shards.devices[j]
        videos = torch.from_numpy(np.stack([s["video"] for s in samples])
                                  ).to(dev)                 # (b,C,T,H,W,3)
        texts = torch.from_numpy(np.stack([s["text"] for s in samples])
                                 ).to(dev)                  # (b,1,W)
        b, c = videos.shape[:2]
        clip_embd = video_fns[j](videos.reshape((-1,) + videos.shape[2:]))
        t_embd = text_fns[j](texts.reshape(-1, texts.shape[-1]))
        return clip_embd.reshape(b, c, -1), t_embd.reshape(b, -1)

    def land(outs):
        clip_embd, t_embd = outs
        return t_embd.cpu().float().numpy(), _window_mean(clip_embd.cpu())

    t, v = shards.run(source, shards.round(batch_size), launch, land)
    return t, v


def _window_mean(clips: torch.Tensor) -> np.ndarray:
    """(b, c, D) clip embeddings on the host -> (b, D) float32: numpy's
    mean for f32; for bf16 the windows added one by one in bf16, then
    divided in bf16 (numpy's mean of a bf16 array, as the JAX version
    takes it)."""
    if clips.dtype == torch.float32:
        return clips.numpy().mean(axis=1)
    acc = clips[:, 0]
    for i in range(1, clips.shape[1]):
        acc = acc + clips[:, i]
    return (acc / clips.shape[1]).float().numpy()


def evaluate_retrieval(model, source, device, batch_size: int = 16,
                       process_group=None) -> dict:
    t, v = extract_retrieval_embeddings(model, source, device, batch_size,
                                        process_group)
    return compute_retrieval_metrics(t @ v.T)
