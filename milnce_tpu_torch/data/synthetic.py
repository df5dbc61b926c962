"""Hermetic in-memory video-text source and a minimal batching loader
(port of ``milnce_tpu/data/synthetic.py``; the loader stands in for
``milnce_tpu/data/pipeline.py`` until its threads and prefetch are
ported).

Samples are the JAX package's, value for value: pseudo-video (uint8) and
token ids seeded by the sample index.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from milnce_tpu_torch.config import DataConfig


class SyntheticVideoTextSource:
    """len() + sample(idx, rng) -> {'video': (T,H,W,3) u8, 'text': (K,W)
    i32, 'start': f32 start time}."""

    def __init__(self, cfg: DataConfig, vocab_size: int = 128,
                 num_samples: int | None = None):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.num_samples = num_samples or cfg.synthetic_num_samples

    def __len__(self) -> int:
        return self.num_samples

    def sample(self, idx: int, rng: np.random.RandomState) -> dict:
        c = self.cfg
        base = np.random.RandomState(idx % 1000)
        video = base.randint(0, 255, size=(c.num_frames, c.video_size,
                                           c.video_size, 3), dtype=np.uint8)
        text = base.randint(1, self.vocab_size,
                            size=(c.num_candidates, c.max_words)).astype(np.int32)
        # zero-pad tail like real captions
        text[:, c.max_words // 2:] = 0
        return {"video": video, "text": text,
                "start": np.float32(idx % 100)}


class BatchLoader:
    """One epoch of a source as device batches.

    The order is the JAX loader's (``RandomState(seed + epoch)`` shuffle,
    tail dropped).  Samples are stacked with numpy; each batch reaches the
    device in one host-to-device copy per array, from pinned memory when
    the device is a GPU.  Text comes flattened to (B*K, W)."""

    def __init__(self, source, batch_size: int, device, seed: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.seed = seed

    def steps_per_epoch(self) -> int:
        return len(self.source) // self.batch_size

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def epoch(self, epoch: int) -> Iterator[tuple]:
        """Yield ``(video_u8 (B,T,H,W,3), text_ids (B*K,W), start (B,)
        f32)`` on the device; ``start`` is each clip's start time, which
        the CIDM loss reads."""
        n = len(self.source)
        order = np.arange(n)
        np.random.RandomState(self.seed + epoch).shuffle(order)
        rng_base = self.seed * 100_003 + epoch
        for start in range(0, self.steps_per_epoch() * self.batch_size,
                           self.batch_size):
            samples = [self.source.sample(
                int(i), np.random.RandomState((rng_base + int(i)) % (2 ** 31)))
                for i in order[start:start + self.batch_size]]
            video = np.stack([s["video"] for s in samples])
            text = np.stack([s["text"] for s in samples])
            start = np.array([s["start"] for s in samples], np.float32)
            yield (self._to_device(video),
                   self._to_device(text.reshape(-1, text.shape[-1])),
                   self._to_device(start))
