"""HMDB-51 linear probe: frozen 1024-d mixed_5c features + LinearSVC
(port of ``milnce_tpu/eval/linear_probe.py``).

Behavior of the reference probe (eval_hmdb.py:60-104): extract
per-window features with ``mixed5c=True``, per official split fit
``LinearSVC(C=100)`` on training videos (each window a sample, labels
repeated), sum the decision scores over a test video's windows, argmax
-> top-1 accuracy.  sklearn runs on the host and is imported only where
the probe is fitted.
"""

from __future__ import annotations

import numpy as np
import torch

from milnce_tpu_torch.train.step import make_video_embed_fn


def extract_probe_features(model, source, device, batch_videos: int = 8):
    """Returns (features (N, num_clip, 1024), labels (N,), splits (N, 3))."""
    video_fn = make_video_embed_fn(model, mixed5c=True)
    feats, labels, splits = [], [], []
    buf, buf_meta = [], []

    def flush():
        if not buf:
            return
        videos = torch.from_numpy(np.stack(buf)).to(device)  # (B,C,T,H,W,3)
        b, c = videos.shape[:2]
        out = video_fn(videos.reshape((-1,) + videos.shape[2:]))
        feats.append(out.cpu().float().numpy().reshape(b, c, -1))
        for label, spl in buf_meta:
            labels.append(label)
            splits.append(spl)
        buf.clear()
        buf_meta.clear()

    for i in range(len(source)):
        s = source.sample(i)
        buf.append(s["video"])
        buf_meta.append((s["label"], s["splits"]))
        if len(buf) == batch_videos:
            flush()
    flush()
    return (np.concatenate(feats), np.asarray(labels), np.stack(splits))


def linear_probe_accuracy(features: np.ndarray, labels: np.ndarray,
                          splits: np.ndarray, C: float = 100.0,
                          splits_to_run=(0, 1, 2)) -> dict:
    """Fit/eval the SVM per split (eval_hmdb.py:86-104).

    features: (N, W, D) per-window; splits: (N, 3) with 1=train, 2=test.
    """
    from sklearn import preprocessing
    from sklearn.svm import LinearSVC

    le = preprocessing.LabelEncoder()
    y = le.fit_transform(labels)
    n, w, d = features.shape
    accs = {}
    for s in splits_to_run:
        tr = np.where(splits[:, s] == 1)[0]
        te = np.where(splits[:, s] == 2)[0]
        x_train = features[tr].reshape(-1, d)
        y_train = np.repeat(y[tr], w)
        x_test = features[te].reshape(-1, d)
        clf = LinearSVC(C=C)
        clf.fit(x_train, y_train)
        scores = clf.decision_function(x_test)
        if scores.ndim == 1:          # binary: sklearn returns one margin
            scores = np.stack([-scores, scores], axis=1)
        scores = scores.reshape(len(te), w, -1)
        pred = scores.sum(axis=1).argmax(axis=1)
        accs[f"split{s + 1}"] = float(np.mean(pred == y[te]))
    accs["mean"] = float(np.mean(list(accs.values())))
    return accs


def evaluate_linear_probe(model, source, device, C: float = 100.0) -> dict:
    feats, labels, splits = extract_probe_features(model, source, device)
    return linear_probe_accuracy(feats, labels, splits, C)
