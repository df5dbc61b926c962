"""Caption sampling + MIL candidate-window selection (the port's own
copy of ``milnce_tpu/data/captions.py``).

Behavioral parity with the reference's text path
(video_loader.py:119-152), as pure host-side functions:

- a caption store is ``{'start': [...], 'end': [...], 'text': [...]}``
  parsed from the per-video JSON;
- :func:`nearest_candidate_window` greedily grows a window of
  ``num_candidates`` temporally-nearest captions around the sampled one
  (the MIL bag of positives, video_loader.py:119-133);
- :func:`widen_to_min_time` stretches short clips to ``min_time``
  seconds, clamping at 0 (video_loader.py:148-151).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


@dataclass
class CaptionTrack:
    start: np.ndarray   # (N,) float seconds
    end: np.ndarray     # (N,) float seconds
    text: list[str]

    def __len__(self) -> int:
        return len(self.text)

    @classmethod
    def from_json_file(cls, path: str) -> "CaptionTrack":
        with open(path) as f:
            raw = json.load(f)
        # timestamps stay f64 on the host: multi-hour videos at sub-frame
        # precision exceed f32's resolution; only clip-relative starts
        # reach the device, as f32
        return cls(start=np.asarray(raw["start"], dtype=np.float64),  # graftlint: disable=GL004(host timestamps: f32 cannot resolve sub-frame times in multi-hour videos; only clip-relative f32 starts reach the device)
                   end=np.asarray(raw["end"], dtype=np.float64),  # graftlint: disable=GL004(host timestamps, as the line above)
                   text=[str(t) for t in raw["text"]])


def nearest_candidate_window(track: CaptionTrack, ind: int,
                             num_candidates: int) -> int:
    """Return the start index of the ``num_candidates``-wide window of
    captions temporally nearest to caption ``ind``.

    Greedy growth: at each step extend to whichever side keeps the window's
    time span smaller; clamp at the track edges (video_loader.py:119-133,
    including its edge behaviors: hitting index 0 returns 0, hitting the
    last caption back-fills from the left)."""
    start = end = ind
    n_candidate = 1
    while n_candidate < num_candidates:
        if start == 0:
            return 0
        if end == len(track) - 1:
            return start - (num_candidates - n_candidate)
        if (track.end[end] - track.start[start - 1]
                < track.end[end + 1] - track.start[start]):
            start -= 1
        else:
            end += 1
        n_candidate += 1
    return start


def widen_to_min_time(start: float, end: float,
                      min_time: float) -> tuple[int, int]:
    """Stretch [start, end] to at least ``min_time`` seconds, shifting the
    start back by half the deficit but never below 0; returns ints like
    the reference (video_loader.py:148-152)."""
    if end - start < min_time:
        diff = min_time - end + start
        start = max(0.0, start - diff / 2)
        end = start + min_time
    return int(start), int(end)


def sample_caption(track: CaptionTrack, rng: np.random.RandomState,
                   tokenizer, num_candidates: int, max_words: int,
                   min_time: float) -> tuple[np.ndarray, int, int]:
    """One training text draw: random caption, candidate bag, tokenize,
    widen (video_loader.py:135-152).

    Returns (tokens (K, max_words) int32, start, end)."""
    ind = rng.randint(0, len(track))
    if num_candidates == 1:
        tokens = tokenizer.encode(track.text[ind], max_words)[None]
    else:
        tokens = np.zeros((num_candidates, max_words), np.int32)
        cap_start = nearest_candidate_window(track, ind, num_candidates)
        last = len(track) - 1
        for i in range(num_candidates):
            j = max(0, min(last, cap_start + i))
            tokens[i] = tokenizer.encode(track.text[j], max_words)
    start, end = widen_to_min_time(track.start[ind], track.end[ind], min_time)
    return tokens, start, end
