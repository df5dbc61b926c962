"""Dataset sources: HowTo100M training + YouCook2 / MSR-VTT / HMDB-51 eval
(port of ``milnce_tpu/data/datasets.py``; each sample is the JAX
source's, value for value, for the same ``(idx, RandomState)``).

Re-designs of the four reference loaders (video_loader.py,
youcook_loader.py, msrvtt_loader.py, hmdb_loader.py) as plain host-side
sources with an injectable decoder (:class:`FakeDecoder` for hermetic
runs).  Decode failures are counted per source (``decode_failures``) and
on the process-wide registry (``milnce_data_decode_failures_total``), as
in the JAX package.

Manifest schemas (identical to the reference csv/ files):
- train:   column ``video_path``, one caption JSON per video id under
  ``caption_root``;
- youcook: end,start,task,text,video_id, videos resolved as
  ``validation/<task>/<id>.{mp4,mkv,webm}``;
- msrvtt:  key,vid_key,video_id,sentence, windows over the whole
  container duration;
- hmdb:    video_id,label,split1..3 (1=train 2=test per official split),
  label from the id minus the ``_test`` suffix.

``HMDBSource(with_flip=True)`` returns both orientations (the
reference's flip branch computes the flipped copy and returns the
un-flipped tensor, hmdb_loader.py:81-83).
"""

from __future__ import annotations

import csv as csv_mod
import os
import sys
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from milnce_tpu_torch.config import DataConfig, ModelConfig
from milnce_tpu_torch.data.captions import CaptionTrack, sample_caption
from milnce_tpu_torch.data.tokenizer import Tokenizer, synthetic_vocab
from milnce_tpu_torch.data.video import (ClipDecoder, black_sample,
                                         build_decoder, eval_windows,
                                         sample_clip)
from milnce_tpu_torch.obs import metrics as obs_metrics

# Decode-failure telemetry on the process-wide registry (incremented from
# reader threads; the display keeps the per-source count).
_OBS_DECODE_FAILURES = obs_metrics.registry().counter(
    "milnce_data_decode_failures_total",
    "samples whose caption load or decode raised (before resample)")


def read_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv_mod.DictReader(f))


class DataHealthError(RuntimeError):
    """The decode-failure fraction exceeded ``data.max_failure_rate``:
    continuing would mean silently training on black-frame fallbacks.
    Deliberately NOT caught by the per-sample resampling — it must kill
    the run."""


def build_tokenizer(model_cfg: ModelConfig, max_words: int) -> Tokenizer:
    """Tokenizer from the configured dict.npy vocabulary
    (``model.token_dict_path``), or a synthetic vocab for hermetic runs."""
    if model_cfg.token_dict_path and os.path.exists(model_cfg.token_dict_path):
        return Tokenizer.from_npy(model_cfg.token_dict_path, max_words)
    return Tokenizer(synthetic_vocab(model_cfg.vocab_size - 1), max_words)


class HowTo100MSource:
    """Training source: one (video clip, MIL caption bag) per draw
    (video_loader.py:154-160).

    A failed caption load or decode resamples a different index (bounded
    retries), falling back to black frames so a step never stalls on a
    bad video; failures are counted in ``decode_failures`` and the first
    few are logged.  Past ``data.max_failure_rate`` the run stops with
    :class:`DataHealthError`."""

    CAPTION_CACHE_SIZE = 4096   # bounded LRU of parsed caption JSONs
    MAX_RETRIES = 3             # resample attempts before black-frame fallback
    LOGGED_FAILURES = 5         # log at most this many failure details
    FAILURE_RATE_MIN_ATTEMPTS = 20   # don't judge max_failure_rate on noise

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 decoder: Optional[ClipDecoder] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 log_fn=None):
        self.cfg = cfg
        self.rows = read_csv(cfg.train_csv)
        if not self.rows or "video_path" not in self.rows[0]:
            raise ValueError(f"{cfg.train_csv}: no rows with a video_path "
                             "column")
        if decoder is None:
            decoder = build_decoder(cfg.decoder_backend,
                                    use_native_reader=cfg.use_native_reader,
                                    workers=cfg.num_reader_threads)
        self.decoder = decoder
        self.tokenizer = tokenizer or build_tokenizer(model_cfg, cfg.max_words)
        self._caption_cache: "OrderedDict[str, CaptionTrack]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.decode_failures = 0
        self.decode_attempts = 0
        self._stats_lock = threading.Lock()
        self._log = log_fn or (lambda m: print(m, file=sys.stderr))

    def __len__(self) -> int:
        return len(self.rows)

    def _captions(self, video_id: str) -> CaptionTrack:
        with self._cache_lock:
            if video_id in self._caption_cache:
                self._caption_cache.move_to_end(video_id)
                return self._caption_cache[video_id]
        path = os.path.join(self.cfg.caption_root, video_id + ".json")
        track = CaptionTrack.from_json_file(path)
        with self._cache_lock:
            self._caption_cache[video_id] = track
            while len(self._caption_cache) > self.CAPTION_CACHE_SIZE:
                self._caption_cache.popitem(last=False)
        return track

    def _sample_one(self, idx: int, rng: np.random.RandomState) -> dict:
        c = self.cfg
        video_file = self.rows[idx]["video_path"]
        video_id = os.path.basename(video_file).split(".")[0]
        track = self._captions(video_id)
        tokens, start, end = sample_caption(
            track, rng, self.tokenizer, c.num_candidates, c.max_words,
            c.min_time)
        video = sample_clip(self.decoder,
                            os.path.join(c.video_root, video_file),
                            start, end, c.num_frames, c.fps, c.video_size,
                            rng, c.crop_only, c.center_crop, c.random_flip)
        return {"video": video, "text": tokens,
                "start": np.float32(start)}   # CIDM loss input (loss.py:56)

    def _record_failure(self, idx: int, exc: Exception) -> None:
        _OBS_DECODE_FAILURES.inc()
        with self._stats_lock:
            self.decode_failures += 1
            count = self.decode_failures
        if count <= self.LOGGED_FAILURES:
            self._log(f"[data] sample {idx} failed "
                      f"({type(exc).__name__}: {exc}); resampling "
                      f"(total failures: {count})")

    def _check_health(self, exc: Exception) -> None:
        limit = self.cfg.max_failure_rate
        if limit >= 1.0:
            return
        with self._stats_lock:
            attempts, failures = self.decode_attempts, self.decode_failures
        if attempts < self.FAILURE_RATE_MIN_ATTEMPTS:
            return
        rate = failures / attempts
        if rate > limit:
            raise DataHealthError(
                f"decode-failure rate {rate:.2f} ({failures}/{attempts} "
                f"attempts) exceeds data.max_failure_rate={limit} — the "
                "dataset/storage is broken, refusing to train on "
                "black-frame fallbacks") from exc

    def fallback_sample(self) -> dict:
        """The black-frame batch-contract fallback: the bounded-resample
        last resort below and the loader's decode-watchdog escalation."""
        return black_sample(self.cfg)

    def sample(self, idx: int, rng: np.random.RandomState) -> dict:
        for _ in range(self.MAX_RETRIES + 1):
            try:
                with self._stats_lock:
                    self.decode_attempts += 1
                return self._sample_one(idx, rng)
            except Exception as exc:
                self._record_failure(idx, exc)
                self._check_health(exc)
                idx = int(rng.randint(len(self.rows)))
        return self.fallback_sample()


class YouCookSource:
    """Zero-shot retrieval eval: per row, ``num_clip`` windows over the GT
    segment + the tokenized caption (youcook_loader.py:14-134)."""

    VIDEO_EXTS = (".mp4", ".mkv", ".webm")

    def __init__(self, csv_path: str, video_root: str, cfg: DataConfig,
                 tokenizer: Tokenizer, num_clip: int = 4,
                 decoder: Optional[ClipDecoder] = None,
                 max_words: int = 30):
        self.rows = read_csv(csv_path)
        self.video_root = video_root
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.num_clip = num_clip
        self.decoder = decoder or build_decoder(cfg.decoder_backend)
        self.max_words = max_words

    def __len__(self) -> int:
        return len(self.rows)

    def _resolve_video(self, row: dict) -> str:
        base = os.path.join(self.video_root, "validation", row["task"],
                            row["video_id"])
        for ext in self.VIDEO_EXTS:
            if os.path.exists(base + ext):
                return base + ext
        return base + self.VIDEO_EXTS[0]

    def sample(self, idx: int, rng=None) -> dict:
        row = self.rows[idx]
        c = self.cfg
        video = eval_windows(self.decoder, self._resolve_video(row),
                             float(row["start"]), float(row["end"]),
                             self.num_clip, c.num_frames, c.fps, c.video_size)
        tokens = self.tokenizer.encode(row["text"], self.max_words)
        return {"video": video, "text": tokens[None]}


class MSRVTTSource:
    """Zero-shot retrieval eval over full-video windows
    (msrvtt_loader.py:13-128); duration comes from the container probe."""

    def __init__(self, csv_path: str, video_root: str, cfg: DataConfig,
                 tokenizer: Tokenizer, num_clip: int = 4,
                 decoder: Optional[ClipDecoder] = None, max_words: int = 30):
        self.rows = read_csv(csv_path)
        self.video_root = video_root
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.num_clip = num_clip
        self.decoder = decoder or build_decoder(cfg.decoder_backend)
        self.max_words = max_words

    def __len__(self) -> int:
        return len(self.rows)

    def sample(self, idx: int, rng=None) -> dict:
        row = self.rows[idx]
        c = self.cfg
        path = os.path.join(self.video_root, row["video_id"] + ".mp4")
        duration = self.decoder.duration(path)
        video = eval_windows(self.decoder, path, 0.0, duration, self.num_clip,
                             c.num_frames, c.fps, c.video_size)
        tokens = self.tokenizer.encode(row["sentence"], self.max_words)
        return {"video": video, "text": tokens[None]}


class HMDBSource:
    """Linear-probe eval: windows over the whole video + class label +
    the three official split assignments (hmdb_loader.py:14-95)."""

    def __init__(self, csv_path: str, video_root: str, cfg: DataConfig,
                 num_clip: int = 10, decoder: Optional[ClipDecoder] = None,
                 with_flip: bool = False):
        self.rows = read_csv(csv_path)
        self.video_root = video_root
        self.cfg = cfg
        self.num_clip = num_clip
        self.decoder = decoder or build_decoder(cfg.decoder_backend)
        self.with_flip = with_flip

    def __len__(self) -> int:
        return len(self.rows)

    @staticmethod
    def label_of(label: str) -> str:
        # the csv label column carries a '_test' suffix (hmdb_loader.py:91-95)
        return label.rsplit("_test", 1)[0] if label.endswith("_test") else label

    def sample(self, idx: int, rng=None) -> dict:
        row = self.rows[idx]
        c = self.cfg
        # video_id already carries its extension (csv/hmdb51.csv)
        path = os.path.join(self.video_root, row["video_id"])
        duration = self.decoder.duration(path)
        video = eval_windows(self.decoder, path, 0.0, duration, self.num_clip,
                             c.num_frames, c.fps, c.video_size)
        if self.with_flip:
            video = np.concatenate([video, video[:, :, :, ::-1, :]], axis=0)
        return {"video": video,
                "label": self.label_of(row["label"]),
                "splits": np.array([int(row["split1"]), int(row["split2"]),
                                    int(row["split3"])], np.int32)}
