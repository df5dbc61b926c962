"""Weight-only symmetric int8 quantization for the embed towers (port of
``milnce_tpu/quant/quantize.py``).

The scheme is the JAX package's, host numpy, copied: every float param
with ndim >= 2 (conv/dense kernels and the word-embedding table) is
stored as int8 with a float32 scale — scalar for per-tensor, one per
output channel (the LAST axis of the Flax layout, matching the
NUMERICS.md readiness table) when the readiness rule says a single
scale would waste bits.  Biases, BatchNorm affine params and all
``batch_stats`` stay f32.

It works on the **Flax layout and keys**: the Flax-shaped variables
``utils/torch_convert.py::torch_state_dict_to_flax`` makes of the port's
``state_dict``, keyed ``'params/<path>'`` as the JAX ``_path_key`` keys
them.  So the port's quantization of a model equals
``milnce_tpu.quant.quantize_variables`` on the same weights bit for bit,
and a v2 artifact written by either package is the same artifact.

Only when the weights go into the port's modules do the int8 arrays and
their scales move to the torch layout (conv ``(O, I, t, h, w)``, Linear
``(O, I)``): a per-channel scale on the Flax last axis then broadcasts
along torch axis 0 (the embedding table keeps its layout and its last
axis).  :class:`QuantizedModel` keeps them as int8 buffers and float32
scales on the device and dequantizes INSIDE every call (``q.float() *
scale``, the numpy arithmetic of :func:`dequantize_array`, then the
ordinary f32 towers through ``torch.func.functional_call``): int8 is what
stays resident; no f32 copy of a quantized weight outlives a call.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

QUANT_SCHEME = "symmetric-int8"

# Readiness thresholds (the JAX package's, which scripts/precision_audit.py
# renders into NUMERICS.md).  A layer whose per-output-channel absmax
# spread exceeds the ratio needs per-channel scales; a layer with heavy
# >6-sigma outliers wants per-channel treatment for the same reason.
PER_CHANNEL_RATIO = 4.0
OUTLIER_FRACTION = 1e-3

_QMAX = 127.0     # symmetric: int8 range [-127, 127], zero-point 0


def weight_readiness_row(key: str, arr: np.ndarray) -> dict:
    """One quantization-readiness row for a (Flax-layout) weight array:
    dynamic range, >6-sigma outlier ratio, per-channel absmax spread and
    the per-channel verdict."""
    arr = np.asarray(arr)
    absmax = float(np.abs(arr).max()) if arr.size else 0.0
    std = float(arr.std()) if arr.size else 0.0
    outliers = (float((np.abs(arr) > 6 * std).mean())
                if std > 0 else 0.0)
    if arr.ndim >= 2:
        ch = np.abs(arr.reshape(-1, arr.shape[-1])).max(axis=0)
        med = float(np.median(ch))
        ratio = float(ch.max() / med) if med > 0 else float("inf")
    else:
        ratio = 1.0
    return dict(
        key=key, shape=list(arr.shape), absmax=absmax, std=std,
        outlier_ratio=outliers, channel_range_ratio=ratio,
        per_channel=(ratio > PER_CHANNEL_RATIO
                     or outliers > OUTLIER_FRACTION))


def quantize_array(arr: np.ndarray,
                   per_channel: bool = False) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """f32 array -> (int8 array, f32 scale).  Per-channel scales are one
    per LAST-axis slice (the output channel of every Flax kernel layout),
    shape (C,), broadcastable against the weight."""
    arr = np.asarray(arr, dtype=np.float32)
    if per_channel:
        if arr.ndim < 2:
            raise ValueError("per-channel quantization needs ndim >= 2, "
                             f"got shape {arr.shape}")
        absmax = np.abs(arr.reshape(-1, arr.shape[-1])).max(axis=0)
    else:
        absmax = np.abs(arr).max()
    scale = np.asarray(absmax, np.float32) / _QMAX
    # all-zero tensors/channels: scale 1 keeps the round-trip exact
    scale = np.where(scale == 0, np.float32(1.0), scale).astype(np.float32)
    q = np.clip(np.rint(arr / scale), -_QMAX, _QMAX).astype(np.int8)
    return q, scale


def dequantize_array(q, scale):
    """Inverse of :func:`quantize_array`, on numpy arrays or tensors
    alike (per-channel (C,) scales broadcast over the (..., C) weight)."""
    if isinstance(q, torch.Tensor):
        return q.to(torch.float32) * scale
    return np.asarray(q).astype(np.float32) * scale


def _flat_leaves(tree: Mapping, prefix: str = "params"):
    """Nested string-keyed dict -> [('prefix/a/b/leaf', leaf)], keys
    sorted at every level as ``jax.tree_util`` flattens a dict."""
    out = []

    def walk(node, path):
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(node[key], path + [str(key)])
        else:
            out.append(("/".join(path), node))

    walk(tree, [prefix])
    return out


def _map_leaves(tree: Mapping, fn, path=("params",)):
    """Same nesting, each leaf replaced by ``fn('params/...', leaf)``."""
    return {k: (_map_leaves(v, fn, path + (str(k),))
                if isinstance(v, Mapping) else fn("/".join(path + (str(k),)),
                                                  v))
            for k, v in tree.items()}


def _should_quantize(leaf) -> bool:
    leaf = np.asarray(leaf)
    return leaf.dtype.kind == "f" and leaf.ndim >= 2 and leaf.size > 0


def quantizable_keys(params) -> set:
    """The 'params/...' keys :func:`quantize_variables` quantizes."""
    return {key for key, leaf in _flat_leaves(params)
            if _should_quantize(leaf)}


def per_channel_keys_from_weights(params) -> tuple[str, ...]:
    """Apply the readiness rule directly to a Flax params tree -> the
    sorted 'params/...' keys that need per-channel scales (the fallback
    when no NUMERICS.md report is on disk)."""
    return tuple(sorted(
        key for key, leaf in _flat_leaves(params)
        if _should_quantize(leaf)
        and weight_readiness_row(key, np.asarray(leaf))["per_channel"]))


def quantize_variables(variables, *, per_channel_keys=()) -> dict:
    """Flax ``{'params', 'batch_stats'}`` f32 tree -> ``{'params': <int8
    where quantized>, 'batch_stats': <f32>, 'quant_scales':
    {'params/<path>': f32 scale}}``, equal to the JAX package's bit for
    bit.  ``per_channel_keys`` are 'params/...' keys; every other
    quantized leaf gets one per-tensor scale."""
    per_channel = frozenset(per_channel_keys)
    scales: dict[str, np.ndarray] = {}

    def quant(key, leaf):
        if not _should_quantize(leaf):
            return np.asarray(leaf)
        q, scale = quantize_array(np.asarray(leaf),
                                  per_channel=key in per_channel)
        scales[key] = scale
        return q

    params = _map_leaves(variables["params"], quant)
    unknown = per_channel - set(scales)
    if unknown:
        raise ValueError("per_channel_keys name layers that are not "
                         f"quantizable params: {sorted(unknown)}")
    return {"params": params,
            "batch_stats": _map_leaves(variables["batch_stats"],
                                       lambda _k, v: np.asarray(v),
                                       ("batch_stats",)),
            "quant_scales": scales}


def dequantize_params(params, scales):
    """Quantized Flax params tree + flat scales dict -> f32 params tree,
    on the host (the weights an f32 model equal to a
    :class:`QuantizedModel` holds)."""
    return _map_leaves(params, lambda key, leaf: (
        np.asarray(leaf) if key not in scales
        else dequantize_array(np.asarray(leaf), scales[key])))


class QuantizedModel(nn.Module):
    """The port's S3D serving a quantized variables tree, int8 resident.

    ``model`` is an S3D of the artifact's config (its weights are
    replaced); ``qvariables`` the ``{'params', 'batch_stats',
    'quant_scales'}`` tree of :func:`quantize_variables` or a v2 export.
    Every leaf without a scale loads into ``model`` as f32; every
    quantized one leaves ``model`` (its Parameter is deleted) and lives
    here as an int8 buffer in the torch layout plus its f32 scale shaped
    to broadcast over it.  ``forward`` takes the model's arguments: it
    dequantizes the quantized weights of the tower the call runs and runs
    ``model`` on them through ``torch.func.functional_call``, so the
    engine's embed entries, ladder and warm-up run it unchanged.

    functional_call swaps the weights into ``model`` for the call, so one
    instance serves one call at a time (the engine's dispatch lock; a
    pool gives each replica its own instance)."""

    def __init__(self, model: nn.Module, qvariables: Mapping):
        super().__init__()
        from milnce_tpu_torch.utils.torch_convert import (flax_location,
                                                          load_jax_variables)

        scales = dict(qvariables.get("quant_scales", {}))
        flat = dict(_flat_leaves(qvariables["params"]))
        state = model.state_dict()
        names, places = [], {}
        for tkey, ref in state.items():
            where = flax_location(tkey, ref.ndim, state)
            if where is None:
                continue
            collection, path, perm = where
            fkey = "/".join([collection] + list(path))
            if fkey in scales:
                places[fkey] = (tkey, perm)
        missing = set(scales) - set(places)
        if missing:
            raise ValueError("quant_scales name leaves the model does not "
                             f"have: {sorted(missing)[:5]}")
        # every f32 leaf through the strict bridge: the quantized ones go
        # in as zeros of their shape (their Parameters are deleted below)
        f32 = {"params": _map_leaves(qvariables["params"], lambda key, v: (
            np.zeros(np.shape(v), np.float32) if key in scales
            else np.asarray(v))),
            "batch_stats": qvariables["batch_stats"]}
        load_jax_variables(model, f32)
        for i, fkey in enumerate(sorted(places)):
            tkey, perm = places[fkey]
            inv = tuple(int(a) for a in np.argsort(perm))
            q = np.ascontiguousarray(np.asarray(flat[fkey]).transpose(inv))
            if q.dtype != np.int8:
                raise ValueError(f"{fkey} is {q.dtype}, not int8")
            s = np.asarray(scales[fkey], np.float32)
            if s.ndim:          # (C,) on the Flax last axis
                s = s.reshape((1,) * (q.ndim - 1) + (-1,)).transpose(inv)
            owner, _, leaf = tkey.rpartition(".")
            mod = model.get_submodule(owner)
            del mod._parameters[leaf]
            self.register_buffer(f"q{i}", torch.from_numpy(q))
            self.register_buffer(f"s{i}", torch.from_numpy(
                np.ascontiguousarray(s)))
            names.append(tkey)
        self.model = model
        self.quantized_names = tuple(names)

    def dequantized(self, mode: str = "all") -> dict:
        """{torch name: f32 weight} for one call (freed after it): the
        weights of the tower ``mode`` runs — the text tower's alone for
        'text', all but it for 'video' (what XLA keeps of the JAX
        program, which dequantizes every leaf and drops the unused)."""
        def wanted(name):
            text = name.startswith("text_module.")
            return {"text": text, "video": not text}.get(mode, True)

        return {name: dequantize_array(getattr(self, f"q{i}"),
                                       getattr(self, f"s{i}"))
                for i, name in enumerate(self.quantized_names)
                if wanted(name)}

    def forward(self, video=None, text=None, mode: str = "all", **kwargs):
        return torch.func.functional_call(
            self.model, self.dequantized(mode), (video, text),
            dict(kwargs, mode=mode))


def resident_bytes(module: nn.Module) -> int:
    """Bytes of model state a module keeps: its parameters and buffers."""
    return int(sum(t.numel() * t.element_size()
                   for t in list(module.parameters()) + list(module.buffers())))
