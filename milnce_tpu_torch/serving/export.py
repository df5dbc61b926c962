"""Params-only frozen export: training checkpoint -> inference artifact
(port of ``milnce_tpu/serving/export.py``; the same files, keys and
metadata, so an artifact written by either package boots in the other).

A training checkpoint (``train/checkpoint.py``) carries the model, the
BatchNorm statistics AND the optimizer's moments, which for Adam are 2x
the params and pure dead weight at serve time.  This module writes the
inference subset in a deliberately boring format: one ``arrays.npz``
(flattened ``params`` + ``batch_stats`` leaves, '/'-joined Flax tree
paths as keys) plus one ``metadata.json`` (model config, tokenizer
contract, per-clip video shape) — loadable on any host with numpy, no
torch checkpoint, no model code at read time.

The keys are the JAX package's: the port's ``state_dict`` (which keeps
the reference PyTorch names and layouts) is mapped to Flax paths by
``utils/torch_convert.py::torch_state_dict_to_flax`` and back by
``flax_to_torch_state_dict``.  Float leaves are stored float32; casting
to bf16 is a LOAD-time decision (``InferenceEngine.from_export(dtype=
'bfloat16')``), so one artifact serves both precisions, as in JAX.  The
metadata's model config keeps the run's ``dtype``: an export of a bf16
run (``--model.dtype bfloat16``) computes in bf16 over its f32 arrays.

Besides the f32 format (v1) this module writes and reads the quantized
edge-tier artifact (v2: int8 params, their f32 scales under the
``quant_scales/`` prefix, a dtype manifest) and the live index's corpus
snapshot (``corpus.npz`` + ``index_meta.json``).

CLI (console script ``milnce-export-torch`` /
``python -m milnce_tpu_torch.serving.export``), the flags of
``milnce-export``::

    milnce-export-torch --checkpoint_dir checkpoint/run1 --out export/run1 \\
        --preset small [--epoch 7] [--model.embedding_dim 512 ...]

The checkpoint stores only arrays, so the exporter must be told the
same model config the run was trained with (preset + overrides), and
bakes it into the artifact — the serving host never guesses shapes
again.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Mapping, Optional

import numpy as np

ARRAYS_FILE = "arrays.npz"
METADATA_FILE = "metadata.json"
FORMAT_VERSION = 1
GENERATOR = "milnce-export-torch (milnce_tpu_torch/serving/export.py)"

# Quantized edge-tier artifact: SAME two files, but quantized params ship
# int8 with their f32 scales under the 'quant_scales/' key prefix, the
# array_dtypes manifest records 'int8' entries, and metadata carries a
# 'quant' block (scheme + calibration summary).  A separate format
# version so the v1 loader rejects it LOUDLY instead of serving int8
# bits as weights.
QUANT_FORMAT_VERSION = 2
SCALES_PREFIX = "quant_scales"

# Live-index corpus snapshot: the SAME boring two-file shape as the
# params export — one npz (the corpus under the 'emb' key) plus one
# versioned metadata json — so an ingesting service can checkpoint its
# grown corpus and a restore (or a cold boot off the npz alone) is
# bit-exact.
INDEX_ARRAYS_FILE = "corpus.npz"
INDEX_METADATA_FILE = "index_meta.json"
INDEX_FORMAT_VERSION = 1


def export_corpus_snapshot(out_dir: str, embeddings: np.ndarray, *,
                           generation: int, k: int,
                           source: str = "") -> str:
    """Write a live-index corpus snapshot; returns ``out_dir``.

    ``embeddings`` is the LIVE generation's (N, D) float32 host corpus
    (pending ingest rows are the caller's business — flush first)."""
    emb = np.ascontiguousarray(embeddings, dtype=np.float32)
    if emb.ndim != 2:
        raise ValueError(f"expected (N, D) embeddings, got {emb.shape}")
    os.makedirs(out_dir, exist_ok=True)
    meta = {
        "format_version": INDEX_FORMAT_VERSION,
        "generator": GENERATOR + " (corpus snapshot)",
        "generation": int(generation),
        "k": int(k),
        "size": int(emb.shape[0]),
        "dim": int(emb.shape[1]),
        "source": source,
    }
    # tmp-write + atomic rename, corpus first: an ingesting service
    # snapshots into the SAME directory every shutdown, so an in-place
    # write killed mid-stream would destroy the previous good snapshot.
    # Worst case after a crash between the two renames is a NEW corpus
    # beside the OLD metadata — load_corpus_snapshot's shape-vs-metadata
    # check turns a size-changing tear into a loud boot error instead of
    # silently serving a mixed snapshot.
    arrays_path = os.path.join(out_dir, INDEX_ARRAYS_FILE)
    meta_path = os.path.join(out_dir, INDEX_METADATA_FILE)
    # np.savez force-appends '.npz' to names missing it — keep the tmp
    # name's suffix so the path savez writes IS the path we rename
    tmp_arrays = os.path.join(out_dir, f".tmp-{os.getpid()}-corpus.npz")
    tmp_meta = meta_path + f".tmp-{os.getpid()}"
    try:
        np.savez(tmp_arrays, emb=emb)
        with open(tmp_meta, "w") as fh:
            json.dump(meta, fh, indent=2, sort_keys=True)
        os.replace(tmp_arrays, arrays_path)
        os.replace(tmp_meta, meta_path)
    finally:
        for leftover in (tmp_arrays, tmp_meta):
            if os.path.exists(leftover):
                os.unlink(leftover)
    return out_dir


def load_corpus_snapshot(snap_dir: str) -> tuple[dict, np.ndarray]:
    """Read a corpus snapshot -> (metadata dict, (N, D) f32 corpus)."""
    with open(os.path.join(snap_dir, INDEX_METADATA_FILE)) as fh:
        meta = json.load(fh)
    if meta.get("format_version") != INDEX_FORMAT_VERSION:
        raise ValueError(
            f"corpus snapshot format {meta.get('format_version')!r} "
            f"unsupported (this build reads {INDEX_FORMAT_VERSION})")
    with np.load(os.path.join(snap_dir, INDEX_ARRAYS_FILE)) as z:
        emb = np.ascontiguousarray(z["emb"], dtype=np.float32)
    if emb.shape != (meta["size"], meta["dim"]):
        raise ValueError(f"snapshot corpus shape {emb.shape} disagrees "
                         f"with its metadata ({meta['size']}, "
                         f"{meta['dim']}) — truncated or mixed artifact")
    return meta, emb


def _flatten(tree: Mapping, prefix: str) -> dict[str, np.ndarray]:
    """Nested string-keyed dict -> {'prefix/path/to/leaf': np.ndarray}."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(value, path + [str(key)])
        else:
            out["/".join(path)] = np.asarray(node)

    walk(tree, [prefix])
    return out


def _unflatten(arrays: Mapping[str, np.ndarray], prefix: str) -> dict:
    """Inverse of :func:`_flatten` (Flax params / batch_stats are nested
    string-keyed dicts)."""
    root: dict = {}
    for key, value in arrays.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = root
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _f32_floats(arrays: dict) -> dict:
    """Float leaves as float32 (f64 never ships); everything else (the
    quantized format's int8 leaves) as stored."""
    return {k: (v.astype(np.float32)
                if np.issubdtype(v.dtype, np.floating) else v)
            for k, v in arrays.items()}


def _artifact_metadata(model_cfg, *, max_words: int, video_shape,
                       step: int, source: str, arrays: dict,
                       format_version: int) -> dict:
    """Shared metadata assembly for the f32 and quantized formats:
    sanitized model config, tokenizer contract, video shape and the
    per-array dtype manifest (the JAX package's keys, field for field)."""
    from milnce_tpu_torch.config import parse_conv_impl_map

    model_meta = dataclasses.asdict(model_cfg)
    model_meta["word2vec_path"] = ""        # table already lives in params
    impl_map = parse_conv_impl_map(model_meta.get("conv_impl_map", ""))
    model_meta["conv_impl_map"] = ",".join(  # resolve file specs inline
        f"{s}={i}" for s, i in sorted(impl_map.items()))
    token_dict = model_meta.pop("token_dict_path", "")
    return {
        "format_version": int(format_version),
        "generator": GENERATOR,
        "step": int(step),
        "source_checkpoint": source,
        "model": model_meta,
        "tokenizer": {"max_words": int(max_words),
                      "vocab_size": int(model_meta["vocab_size"]),
                      "token_dict_path": token_dict},
        "video_shape": [int(d) for d in video_shape],
        "param_bytes": int(sum(v.nbytes for v in arrays.values())),
        # per-array dtype manifest: the on-disk precision contract a
        # loader can audit without opening the npz — float leaves are
        # f32 (or int8, in the quantized format) by construction,
        # everything else ships as stored
        "array_dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }


def _write_meta(out_dir: str, meta: dict) -> None:
    with open(os.path.join(out_dir, METADATA_FILE), "w") as fh:
        json.dump(meta, fh, indent=2, sort_keys=True)


def export_inference_checkpoint(out_dir: str, params, batch_stats,
                                model_cfg, *, max_words: int,
                                video_shape, step: int = 0,
                                source: str = "") -> str:
    """Write the frozen artifact from Flax-shaped ``params`` and
    ``batch_stats`` (nested dicts of arrays); returns ``out_dir``.

    ``model_cfg`` is a ``milnce_tpu_torch.config.ModelConfig``;
    host-specific fields (word2vec/token-dict paths, impl-map file paths)
    are sanitized so the artifact is self-contained."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = _flatten(params, "params")
    arrays.update(_flatten(batch_stats, "batch_stats"))
    arrays = _f32_floats(arrays)
    np.savez(os.path.join(out_dir, ARRAYS_FILE), **arrays)
    _write_meta(out_dir, _artifact_metadata(
        model_cfg, max_words=max_words, video_shape=video_shape, step=step,
        source=source, arrays=arrays, format_version=FORMAT_VERSION))
    return out_dir


def export_quantized_checkpoint(out_dir: str, qvariables, model_cfg, *,
                                max_words: int, video_shape,
                                step: int = 0, source: str = "",
                                calibration: dict | None = None) -> str:
    """Write a quantized edge-tier artifact; returns ``out_dir``.

    ``qvariables``: ``{'params': <int8 where quantized>, 'batch_stats':
    <f32>, 'quant_scales': {'params/<path>': f32 scale}}``.  int8 leaves
    ship bit-exact; float leaves coerce to f32 exactly like the v1
    format.  ``calibration`` is a JSON-safe summary block."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = _flatten(qvariables["params"], "params")
    arrays.update(_flatten(qvariables["batch_stats"], "batch_stats"))
    arrays = _f32_floats(arrays)
    scales = qvariables.get("quant_scales", {})
    for key, scale in scales.items():
        arrays[f"{SCALES_PREFIX}/{key}"] = np.asarray(scale, np.float32)
    np.savez(os.path.join(out_dir, ARRAYS_FILE), **arrays)
    meta = _artifact_metadata(model_cfg, max_words=max_words,
                              video_shape=video_shape, step=step,
                              source=source, arrays=arrays,
                              format_version=QUANT_FORMAT_VERSION)
    meta["quant"] = {
        "scheme": "symmetric-int8",
        "n_quantized": len(scales),
        "per_channel": sorted(
            k for k, s in scales.items() if np.asarray(s).ndim),
        "calibration": calibration or {},
    }
    _write_meta(out_dir, meta)
    return out_dir


def read_export_metadata(export_dir: str) -> dict:
    """Metadata alone (no arrays): how a loader decides which format
    family an artifact is before touching the npz."""
    with open(os.path.join(export_dir, METADATA_FILE)) as fh:
        return json.load(fh)


def _read_arrays(export_dir: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(export_dir, ARRAYS_FILE)) as z:
        return {k: z[k] for k in z.files}


def load_quantized_checkpoint(export_dir: str) -> tuple[dict, dict]:
    """Read a quantized export -> (metadata, ``{'params',
    'batch_stats', 'quant_scales'}`` variables tree).  Every array is
    checked against the on-disk ``array_dtypes`` manifest — the
    bit-exactness contract is only as good as the dtype it round-trips
    at."""
    meta = read_export_metadata(export_dir)
    if meta.get("format_version") != QUANT_FORMAT_VERSION:
        raise ValueError(
            f"quantized export format {meta.get('format_version')!r} "
            f"unsupported (this build reads {QUANT_FORMAT_VERSION})")
    meta["model"].pop("token_dict_path", None)
    arrays = _read_arrays(export_dir)
    manifest = meta.get("array_dtypes", {})
    for key, value in arrays.items():
        want = manifest.get(key)
        if want is not None and str(value.dtype) != want:
            raise ValueError(f"array {key!r} is {value.dtype}, manifest "
                             f"says {want} — corrupt or rewritten npz")
    prefix = SCALES_PREFIX + "/"
    scales = {k[len(prefix):]: v for k, v in arrays.items()
              if k.startswith(prefix)}
    return meta, {"params": _unflatten(arrays, "params"),
                  "batch_stats": _unflatten(arrays, "batch_stats"),
                  "quant_scales": scales}


def load_inference_checkpoint(export_dir: str) -> tuple[dict, dict]:
    """Read an export -> (metadata dict, ``{'params', 'batch_stats'}``
    Flax variables tree of host numpy arrays)."""
    meta = read_export_metadata(export_dir)
    if meta.get("format_version") != FORMAT_VERSION:
        hint = (" — a quantized artifact; load with "
                "load_quantized_checkpoint"
                if meta.get("format_version") == QUANT_FORMAT_VERSION
                else "")
        raise ValueError(f"export format {meta.get('format_version')!r} "
                         f"unsupported (this build reads {FORMAT_VERSION}"
                         f"){hint}")
    # ModelConfig round-trips through JSON minus the serve-sanitized field
    meta["model"].pop("token_dict_path", None)
    arrays = _read_arrays(export_dir)
    return meta, {"params": _unflatten(arrays, "params"),
                  "batch_stats": _unflatten(arrays, "batch_stats")}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    from milnce_tpu_torch.config import PRESETS, _add_dataclass_args
    from milnce_tpu_torch.train.checkpoint import CheckpointManager
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    ap = argparse.ArgumentParser(
        description="Export a params-only inference checkpoint "
                    "(milnce_tpu_torch/serving/export.py)")
    ap.add_argument("--checkpoint_dir", required=True,
                    help="training run directory (train/checkpoint.py)")
    ap.add_argument("--out", required=True, help="export directory to write")
    ap.add_argument("--epoch", type=int, default=None,
                    help="checkpoint label to export (default: latest)")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="full",
                    help="model/data config the run was trained with")
    base = PRESETS["full"]()
    _add_dataclass_args(ap, "model.", base.model)
    _add_dataclass_args(ap, "data.", base.data)
    ns = ap.parse_args(argv)

    cfg = PRESETS[ns.preset]()
    for key, val in vars(ns).items():
        if "." in key and val is not None:
            section, _, fname = key.partition(".")
            setattr(getattr(cfg, section), fname, val)

    # params and BatchNorm statistics only; the Adam moments stay unread
    _, step, state_dict = CheckpointManager(
        ns.checkpoint_dir, create=False).restore_model(ns.epoch)
    # Flax paths; BatchNorm update counters have no Flax leaf and stay
    tree = torch_state_dict_to_flax({k: v.numpy()
                                     for k, v in state_dict.items()})
    video_shape = (cfg.data.num_frames, cfg.data.video_size,
                   cfg.data.video_size, 3)
    out = export_inference_checkpoint(
        ns.out, tree["params"], tree["batch_stats"], cfg.model,
        max_words=cfg.data.max_words, video_shape=video_shape, step=step,
        source=os.path.abspath(ns.checkpoint_dir))
    meta_path = os.path.join(out, METADATA_FILE)
    print(f"exported step {step} -> {out} ({meta_path})")


if __name__ == "__main__":
    main()
