"""Post-training calibration pass for the int8 edge tier (port of
``milnce_tpu/quant/calibrate.py``).

``calibrate_and_quantize`` is the offline entry: it quantizes a Flax
``{'params', 'batch_stats'}`` f32 tree with per-channel scales seeded
from the COMMITTED NUMERICS.md readiness verdicts, runs held-out
clips/captions through both towers to record per-layer activation absmax
ranges, and measures the embedding-space damage (cosine to the f32
teacher, top-k rank agreement) that the export's ``quant.calibration``
metadata block then carries.

Activation ranges: the JAX package reads them with Flax
``capture_intermediates``, one range per module ``__call__``, keyed
``'<tower>/<Flax module path>/__call__/0'``.  The port registers a
forward hook on every module and names it by the same Flax path (the
STConv3D renames of ``utils/torch_convert.py::flax_location``), so the
top-16 ranges in the metadata carry the JAX keys.  Every module the JAX
S3D calls has a port counterpart and the other way round.

The model here is the port's S3D holding the teacher's weights; the
video batches are float frames as the JAX pass takes them (fed to the
model as they are, without the serving entry's division by 255).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from milnce_tpu_torch.quant.quantize import (QUANT_SCHEME, QuantizedModel,
                                             per_channel_keys_from_weights,
                                             quantizable_keys,
                                             quantize_variables)

# NUMERICS.md readiness-table row: | `params/...` | ... | <verdict> |
_VERDICT_ROW = re.compile(r"^\|\s*`(params/[^`]+)`\s*\|.*\|\s*"
                          r"(\*{0,2}per-channel\*{0,2}|per-tensor ok)"
                          r"\s*\|\s*$")


def read_numerics_verdicts(report_path: str) -> dict[str, bool]:
    """Parse the committed NUMERICS.md quantization-readiness table ->
    {'params/<layer>': needs_per_channel}.  Empty dict when the file has
    no readiness section."""
    verdicts: dict[str, bool] = {}
    with open(report_path) as fh:
        for line in fh:
            m = _VERDICT_ROW.match(line.strip())
            if m:
                verdicts[m.group(1)] = "per-channel" in m.group(2)
    return verdicts


def _flax_module_path(name: str, state) -> str:
    """A torch module name -> the Flax module path of its counterpart
    ('' for the root); ``state`` is the model's ``state_dict``."""
    from milnce_tpu_torch.utils.torch_convert import flax_location

    weight = state.get(f"{name}.weight")
    if weight is None:
        return name.replace(".", "/")
    return "/".join(flax_location(f"{name}.weight", weight.ndim,
                                  state)[1][:-1])


def _run_towers(model, video_batches, text_batches, device):
    with torch.no_grad():
        for video in video_batches:
            yield "video", model(torch.as_tensor(
                np.asarray(video, np.float32), device=device), None,
                mode="video")
        for tokens in text_batches:
            yield "text", model(None, torch.as_tensor(
                np.asarray(tokens, np.int32), device=device), mode="text")


def collect_activation_ranges(model, *, video_batches=(),
                              text_batches=()) -> dict[str, float]:
    """Per-module activation absmax over the calibration batches ->
    {'<tower>/<Flax module path>/__call__/0': absmax}, max-reduced
    across batches (calibration wants the envelope)."""
    state = model.state_dict()
    device = next(model.parameters()).device
    ranges: dict[str, float] = {}
    tower = {"name": ""}

    def hook_for(path):
        def hook(_mod, _inp, out):
            if not isinstance(out, torch.Tensor):
                return
            key = "/".join(p for p in (tower["name"], path, "__call__", "0")
                           if p)
            absmax = float(out.detach().abs().max())
            ranges[key] = max(ranges.get(key, 0.0), absmax)
        return hook

    handles = [mod.register_forward_hook(hook_for(_flax_module_path(n, state)))
               for n, mod in model.named_modules()]
    was_training = model.training
    model.eval()
    try:
        for video in video_batches:
            tower["name"] = "video"
            list(_run_towers(model, [video], (), device))
        for tokens in text_batches:
            tower["name"] = "text"
            list(_run_towers(model, (), [tokens], device))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return ranges


def _rank_agreement(ref: np.ndarray, test: np.ndarray, k: int) -> float:
    """Mean top-k overlap between two (Q, N) similarity matrices."""
    k = min(k, ref.shape[1])
    ref_top = np.argsort(-ref, axis=1)[:, :k]
    test_top = np.argsort(-test, axis=1)[:, :k]
    hits = [len(set(r) & set(t)) / k
            for r, t in zip(ref_top, test_top)]
    return float(np.mean(hits))


def _embed(model, video_batches, text_batches):
    device = next(model.parameters()).device
    model.eval()
    out = {"video": [], "text": []}
    for tower, emb in _run_towers(model, video_batches, text_batches,
                                  device):
        out[tower].append(emb.cpu().numpy())
    return {t: np.concatenate(v) if v else None for t, v in out.items()}


def quantization_quality(model, qvariables, *, video_batches=(),
                         text_batches=(), k: int = 10) -> dict:
    """Embedding-space damage report: per-row cosine between the f32
    ``model``'s and the int8 model's embeddings for each tower, plus
    text->video top-k rank agreement when both modalities were given.
    The int8 model is a :class:`QuantizedModel` over a copy of
    ``model``'s architecture, on its device."""
    import copy

    device = next(model.parameters()).device
    qmodel = QuantizedModel(copy.deepcopy(model), qvariables).to(device)

    def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        num = (a * b).sum(axis=-1)
        den = (np.linalg.norm(a, axis=-1)
               * np.linalg.norm(b, axis=-1) + 1e-12)
        return num / den

    video = ([np.concatenate([np.asarray(b, np.float32)
                              for b in video_batches])]
             if video_batches else [])
    text = ([np.concatenate([np.asarray(b, np.int32)
                             for b in text_batches])]
            if text_batches else [])
    ref = _embed(model, video, text)
    got = _embed(qmodel, video, text)
    out: dict = {"scheme": QUANT_SCHEME}
    for tower in ("video", "text"):
        if ref[tower] is not None:
            cos = _cos(ref[tower], got[tower])
            out[f"{tower}_cosine_mean"] = float(cos.mean())
            out[f"{tower}_cosine_min"] = float(cos.min())
    if ref["video"] is not None and ref["text"] is not None:
        out[f"rank_agreement_top{k}"] = _rank_agreement(
            ref["text"] @ ref["video"].T, got["text"] @ got["video"].T, k)
    return out


def calibrate_and_quantize(model, variables, *, video_batches=(),
                           text_batches=(), per_channel_keys=None,
                           numerics_report: str = "",
                           k: int = 10) -> tuple[dict, dict]:
    """The full offline pass -> (quantized variables tree, JSON-safe
    calibration metadata block for the quantized export).

    ``model`` is the port's S3D holding the teacher's weights (on the
    device the pass runs on); ``variables`` the same weights as a Flax
    ``{'params', 'batch_stats'}`` tree (an export's, or
    ``torch_state_dict_to_flax`` of the model's state).
    ``per_channel_keys=None`` reads the committed NUMERICS.md verdicts
    when ``numerics_report`` names one, else derives them from the
    weights with the same rule."""
    if per_channel_keys is None:
        verdicts = (read_numerics_verdicts(numerics_report)
                    if numerics_report and os.path.exists(numerics_report)
                    else {})
        if verdicts:
            # the report is a default, not a command: keep the keys this
            # model can quantize (another preset's layers drop out)
            quantizable = quantizable_keys(variables["params"])
            per_channel_keys = tuple(sorted(
                key for key, pc in verdicts.items()
                if pc and key in quantizable))
            verdict_source = numerics_report
        else:
            per_channel_keys = per_channel_keys_from_weights(
                variables["params"])
            verdict_source = "weights (readiness rule, no report)"
    else:
        per_channel_keys = tuple(sorted(per_channel_keys))
        verdict_source = "caller"

    qvariables = quantize_variables(variables,
                                    per_channel_keys=per_channel_keys)
    calibration = {
        "scheme": QUANT_SCHEME,
        "per_channel": list(per_channel_keys),
        "verdict_source": verdict_source,
        "n_video_batches": len(video_batches),
        "n_text_batches": len(text_batches),
    }
    if video_batches or text_batches:
        ranges = collect_activation_ranges(
            model, video_batches=video_batches, text_batches=text_batches)
        calibration["activation_absmax_max"] = (
            max(ranges.values()) if ranges else 0.0)
        calibration["activation_ranges"] = {
            key: round(val, 6) for key, val in sorted(
                ranges.items(), key=lambda kv: -kv[1])[:16]}
        calibration["quality"] = quantization_quality(
            model, qvariables, video_batches=video_batches,
            text_batches=text_batches, k=k)
    return qvariables, calibration
