"""Port parity, data: the tokenizer, captions, clip windows, the HowTo100M
source and the threaded loader of ``milnce_tpu_torch/data/`` against the
JAX package's, on the same inputs made from numpy seeds.

Everything here is integer or uint8 data drawn from the same
``RandomState`` streams, so every comparison is exact.  ``FakeDecoder``
seeds its frames with ``hash(path)``, which is the same for both
packages within one process.
"""

import json
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from milnce_tpu.config import DataConfig as JaxDataConfig
from milnce_tpu.config import ModelConfig as JaxModelConfig
from milnce_tpu.data import captions as jax_captions
from milnce_tpu.data import video as jax_video
from milnce_tpu.data.datasets import HowTo100MSource as JaxHowTo100MSource
from milnce_tpu.data.pipeline import ShardedLoader as JaxShardedLoader
from milnce_tpu.data.pipeline import flatten_text as jax_flatten_text
from milnce_tpu.data.synthetic import (
    SyntheticVideoTextSource as JaxSyntheticSource)
from milnce_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from milnce_tpu_torch.config import DataConfig, ModelConfig
from milnce_tpu_torch.data import captions, video
from milnce_tpu_torch.data.datasets import HowTo100MSource
from milnce_tpu_torch.data.pipeline import (ShardedLoader, device_prefetch,
                                            flatten_text, stack_batch)
from milnce_tpu_torch.data.synthetic import SyntheticVideoTextSource
from milnce_tpu_torch.data.tokenizer import Tokenizer

torch.set_num_threads(1)         # six test workers share the cores

_VOCAB = [f"word{i}" for i in range(1, 8)] + ["it's", "a"]
_SENTENCES = ["word1 word2 it's", "nothing known here", "", "a " * 40,
              "word7, word3; WORD4 word5!", 42]


def _same_dicts(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g = np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------- tokenizer, captions
@pytest.mark.parametrize("max_words", [1, 6, 30])
def test_tokenizer_matches_jax(max_words):
    got = Tokenizer(_VOCAB, max_words)
    want = JaxTokenizer(_VOCAB, max_words)
    assert got.vocab_size == want.vocab_size
    np.testing.assert_array_equal(got.encode_batch(_SENTENCES),
                                  want.encode_batch(_SENTENCES))
    np.testing.assert_array_equal(got.encode_batch([]),
                                  want.encode_batch([]))
    for s in _SENTENCES:
        np.testing.assert_array_equal(got.encode(s, 3), want.encode(s, 3))


def _track(mod, seed):
    rng = np.random.RandomState(seed)
    start = np.sort(rng.uniform(0, 100, 9))
    end = start + rng.uniform(0.5, 12, 9)
    return mod.CaptionTrack(start=start, end=end,
                            text=[f"word{i % 7 + 1} a" for i in range(9)])


@pytest.mark.parametrize("k", [1, 2, 5, 9])
def test_captions_match_jax(k):
    for seed in range(4):
        track, jtrack = _track(captions, seed), _track(jax_captions, seed)
        for ind in range(len(track)):
            assert (captions.nearest_candidate_window(track, ind, k)
                    == jax_captions.nearest_candidate_window(jtrack, ind, k))
        for s, e in [(0.0, 1.0), (3.2, 4.0), (10.0, 30.0), (1.5, 1.5)]:
            assert (captions.widen_to_min_time(s, e, 5.0)
                    == jax_captions.widen_to_min_time(s, e, 5.0))
        got = captions.sample_caption(track, np.random.RandomState(seed),
                                      Tokenizer(_VOCAB), k, 6, 5.0)
        want = jax_captions.sample_caption(
            jtrack, np.random.RandomState(seed), JaxTokenizer(_VOCAB), k, 6,
            5.0)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_caption_track_reads_the_json_as_jax(tmp_path):
    path = tmp_path / "v.json"
    path.write_text(json.dumps({"start": [0, 1.5], "end": [2, 3.25],
                                "text": ["a", 7]}))
    got = captions.CaptionTrack.from_json_file(str(path))
    want = jax_captions.CaptionTrack.from_json_file(str(path))
    np.testing.assert_array_equal(got.start, want.start)
    np.testing.assert_array_equal(got.end, want.end)
    assert got.text == want.text and got.start.dtype == want.start.dtype


@pytest.mark.parametrize("t", [0, 3, 8, 11])
def test_pad_or_trim_matches_jax(t):
    frames = np.random.RandomState(t).randint(0, 255, (t, 4, 4, 3),
                                              dtype=np.uint8)
    np.testing.assert_array_equal(video.pad_or_trim(frames, 8),
                                  jax_video.pad_or_trim(frames, 8))


@pytest.mark.parametrize("start,end,num_clip", [(0.0, 30.0, 4),
                                                (47.0, 60.0, 3),
                                                (5.0, 5.2, 2)])
def test_eval_windows_match_jax(start, end, num_clip):
    args = ("videos/x.mp4", start, end, num_clip, 6, 10, 16)
    got = video.eval_windows(video.FakeDecoder(), *args)
    want = jax_video.eval_windows(jax_video.FakeDecoder(), *args)
    assert got.shape == (num_clip, 6, 16, 16, 3)
    np.testing.assert_array_equal(got, want)


def test_sample_clip_matches_jax():
    for seed in range(6):
        args = ("videos/y.mp4", 3.0, 11.0, 8, 10, 16)
        flags = (False, seed % 2 == 0, True)
        got = video.sample_clip(video.FakeDecoder(), *args,
                                np.random.RandomState(seed), *flags)
        want = jax_video.sample_clip(jax_video.FakeDecoder(), *args,
                                     np.random.RandomState(seed), *flags)
        np.testing.assert_array_equal(got, want)


def test_auto_decoder_refuses_without_ffmpeg_or_cv2(monkeypatch):
    """No ffmpeg binary and no cv2: 'auto' raises naming both, instead of
    a silent FakeDecoder."""
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no ffmpeg binary.*cv2"):
        video.build_decoder("auto")
    with pytest.raises(RuntimeError, match="cv2"):
        video.build_decoder("cv2")
    assert isinstance(video.build_decoder("fake"), video.FakeDecoder)
    assert isinstance(video.build_decoder("ffmpeg"), video.FFmpegDecoder)
    with pytest.raises(ValueError, match="unknown decoder backend"):
        video.build_decoder("native")


# ------------------------------------------------------- the HowTo100M source
@pytest.fixture
def howto_dir(tmp_path):
    """Tiny on-disk HowTo100M layout: manifest csv + caption JSONs (the
    layout of tests/test_data.py::howto_dir)."""
    (tmp_path / "videos").mkdir()
    (tmp_path / "captions").mkdir()
    rows = ["video_path"]
    for i in range(4):
        vid = f"vid{i}"
        rows.append(f"{vid}.mp4")
        caps = {"start": [0, 6, 12], "end": [6, 12, 18],
                "text": [f"word{i} word2", "word3 word4", "word5"]}
        (tmp_path / "captions" / f"{vid}.json").write_text(json.dumps(caps))
    (tmp_path / "train.csv").write_text("\n".join(rows))
    return tmp_path


def _data_cfg(cls, root, **kw):
    return cls(train_csv=str(root / "train.csv"),
               video_root=str(root / "videos"),
               caption_root=str(root / "captions"), num_frames=4,
               video_size=16, max_words=6, num_candidates=3, **kw)


class _Flaky:
    """Mixin: decode raises for the paths of ``bad`` video numbers."""

    bad = ()

    def decode(self, path, *args, **kwargs):
        if any(f"vid{i}." in path for i in self.bad):
            raise RuntimeError(f"corrupt {path}")
        return super().decode(path, *args, **kwargs)


class _FlakyFake(_Flaky, video.FakeDecoder):
    pass


class _JaxFlakyFake(_Flaky, jax_video.FakeDecoder):
    pass


@pytest.mark.parametrize("bad", [(), (1,), (0, 1, 2, 3)],
                         ids=["clean", "resample", "black-fallback"])
def test_howto100m_source_matches_jax(howto_dir, bad):
    """Same (idx, RandomState) -> the same sample, through the bounded
    resample of a failing decode and the black-frame last resort."""
    tok, jtok = Tokenizer(_VOCAB, 6), JaxTokenizer(_VOCAB, 6)
    dec, jdec = _FlakyFake(), _JaxFlakyFake()
    dec.bad = jdec.bad = bad
    # the health check is off: it would stop the all-failing case
    src = HowTo100MSource(_data_cfg(DataConfig, howto_dir,
                                    max_failure_rate=1.0), ModelConfig(),
                          decoder=dec, tokenizer=tok, log_fn=lambda _m: None)
    jsrc = JaxHowTo100MSource(_data_cfg(JaxDataConfig, howto_dir,
                                        max_failure_rate=1.0),
                              JaxModelConfig(), decoder=jdec, tokenizer=jtok,
                              log_fn=lambda _m: None)
    assert len(src) == len(jsrc) == 4
    for idx in range(4):
        for seed in range(3):
            _same_dicts(src.sample(idx, np.random.RandomState(seed)),
                        jsrc.sample(idx, np.random.RandomState(seed)))
    assert src.decode_failures == jsrc.decode_failures
    assert (src.decode_failures > 0) == bool(bad)
    if len(bad) == 4:
        black = src.sample(0, np.random.RandomState(0))
        assert not black["video"].any() and not black["text"].any()


def test_howto100m_source_health_error(howto_dir):
    """A dataset whose decodes all fail stops the run past
    data.max_failure_rate, as the JAX source does."""
    from milnce_tpu.data.datasets import DataHealthError as JaxDataHealthError

    from milnce_tpu_torch.data.datasets import DataHealthError

    for cls, dcls, dec, err in [
            (HowTo100MSource, DataConfig, _FlakyFake(), DataHealthError),
            (JaxHowTo100MSource, JaxDataConfig, _JaxFlakyFake(),
             JaxDataHealthError)]:
        dec.bad = (0, 1, 2, 3)
        mcfg = ModelConfig() if cls is HowTo100MSource else JaxModelConfig()
        src = cls(_data_cfg(dcls, howto_dir, max_failure_rate=0.5), mcfg,
                  decoder=dec, tokenizer=Tokenizer(_VOCAB, 6),
                  log_fn=lambda _m: None)
        with pytest.raises(err, match="decode-failure rate"):
            for i in range(30):
                src.sample(i % 4, np.random.RandomState(i))


# ------------------------------------------------------------- the loader
_SYN = dict(num_frames=2, video_size=8, max_words=4, num_candidates=2,
            synthetic_num_samples=42)


def _loaders(batch, pi, pc, lookahead, threads):
    src = SyntheticVideoTextSource(DataConfig(**_SYN), vocab_size=16)
    jsrc = JaxSyntheticSource(JaxDataConfig(**_SYN), vocab_size=16)
    kw = dict(seed=3, process_index=pi, process_count=pc,
              lookahead_batches=lookahead)
    return (ShardedLoader(src, batch, num_threads=threads, **kw),
            JaxShardedLoader(jsrc, batch, num_threads=threads, **kw))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("lookahead", [0, 2])
@pytest.mark.parametrize("skip", [0, 3])
@pytest.mark.parametrize("pi,pc", [(0, 1), (0, 2), (1, 2)],
                         ids=["1proc", "2proc-0", "2proc-1"])
def test_sharded_loader_matches_jax(pi, pc, skip, lookahead, threads):
    """Every batch of both loaders, exactly, over epochs 0-1."""
    loader, jloader = _loaders(8, pi, pc, lookahead, threads)
    assert loader.steps_per_epoch() == jloader.steps_per_epoch() == 5
    for epoch in (0, 1):
        got = [stack_batch(b) for b in loader.epoch(epoch, skip)]
        want = list(jloader.epoch(epoch, skip))
        assert len(got) == len(want) == 5 - skip
        for g, w in zip(got, want):
            assert g["video"].shape[0] == 8 // pc
            _same_dicts(g, w)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_device_prefetch_on_the_cpu_keeps_order(depth):
    loader, jloader = _loaders(4, 0, 1, 2, 2)
    got = list(device_prefetch(loader.epoch(1), "cpu", depth=depth))
    want = list(jloader.epoch(1))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in g.values())
        _same_dicts({k: t.numpy() for k, t in g.items()}, w)
        tv, tt = flatten_text(g)
        jv, jt = jax_flatten_text(w)
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(tt.numpy(), jt)
        assert tt.shape == (4 * 2, 4)


def test_device_prefetch_closes_the_loader_early():
    """Leaving an epoch mid-way closes the loader's generator (its pool
    shut down) at once, not when it is collected."""
    loader, _ = _loaders(4, 0, 1, 2, 2)
    epoch = loader.epoch(0)
    prefetch = device_prefetch(epoch, "cpu", depth=2)
    next(prefetch)
    prefetch.close()
    assert epoch.gi_frame is None


class _Hangs:
    """A source whose sample 5 never finishes in time."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def fallback_sample(self):
        return self.inner.fallback_sample()

    def sample(self, idx, rng):
        if idx == 5:
            time.sleep(0.5)
        return self.inner.sample(idx, rng)


def test_decode_watchdog_falls_back_to_black_frames():
    src = _Hangs(SyntheticVideoTextSource(DataConfig(**_SYN), vocab_size=16))
    loader = ShardedLoader(src, 42, num_threads=4, shuffle=False,
                           sample_timeout=0.05, timeout_retries=1,
                           log_fn=lambda _m: None)
    (batch,) = list(loader.epoch(0))
    assert not batch[5]["video"].any() and batch[4]["video"].any()
    assert loader.decode_timeouts >= 1


def test_manifest_tool_matches_jax(tmp_path):
    """build + validate on a tree with a video lacking captions, a caption
    file that does not parse and one without its keys."""
    from milnce_tpu.data import manifest as jax_manifest

    from milnce_tpu_torch.data import manifest

    videos, caps = tmp_path / "videos", tmp_path / "caps"
    (videos / "sub").mkdir(parents=True)
    caps.mkdir()
    for name in ("a.mp4", "sub/b.mkv", "c.webm", "d.avi", "notes.txt"):
        (videos / name).write_text("")
    (caps / "a.json").write_text('{"start": [0], "end": [1], "text": ["x"]}')
    (caps / "b.json").write_text("{not json")
    (caps / "c.json").write_text('{"start": [0]}')
    for with_caps in ("", str(caps)):
        got = manifest.build(str(videos), str(tmp_path / "g.csv"), with_caps)
        want = jax_manifest.build(str(videos), str(tmp_path / "w.csv"),
                                  with_caps)
        assert got == want
        assert ((tmp_path / "g.csv").read_text()
                == (tmp_path / "w.csv").read_text())
        args = (str(tmp_path / "g.csv"), str(videos), str(caps))
        assert manifest.validate(*args) == jax_manifest.validate(*args)
    assert manifest.validate(*args)["bad_captions"] == 2
