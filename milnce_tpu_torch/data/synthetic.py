"""Hermetic in-memory video-text source (port of
``milnce_tpu/data/synthetic.py``; batches come through
``data/pipeline.py``).

Samples are the JAX package's, value for value: pseudo-video (uint8) and
token ids seeded by the sample index.
"""

from __future__ import annotations

import numpy as np

from milnce_tpu_torch.config import DataConfig
from milnce_tpu_torch.data.video import black_sample
from milnce_tpu_torch.resilience import faults


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

    def fallback_sample(self) -> dict:
        """The black-frame fallback, the loader watchdog's escalation
        target."""
        return black_sample(self.cfg)

    def sample(self, idx: int, rng: np.random.RandomState) -> dict:
        # the decode fault sites, as on the real decode path
        # (data/video.py sample_clip): ``train.faults`` decode clauses
        # drive the watchdog and the fallback on hermetic runs
        faults.maybe_raise("decode.raise")
        faults.maybe_hang("decode.hang")
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
