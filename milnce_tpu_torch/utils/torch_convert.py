"""Convert between torch S3D state dicts and Flax S3D variables (the
port's own copy of ``milnce_tpu/utils/torch_convert.py``), plus
:func:`load_jax_variables`, which carries the JAX package's weights into
the port's model, and :func:`load_reference_checkpoint`, which loads a
reference ``.pth`` straight into it.

Handles both checkpoint flavors the reference eval scripts accept
(eval_msrvtt.py:21-32):

- this-repo DDP format: ``{'state_dict': {'module.<name>': tensor}}``
- upstream flat S3D_HowTo100M format: ``{'<name>': tensor}`` (used with
  ``space_to_depth=True``).

The converters work on ``Mapping[str, np.ndarray]``; only the loaders
touch torch.

Layout rules:
- Conv3d  ``(O, I, t, h, w)`` -> flax Conv ``(t, h, w, I, O)``
- Linear  ``(O, I)``          -> flax Dense ``(I, O)``
- Embedding row-major         -> unchanged
- BatchNorm weight/bias -> params scale/bias; running_mean/var -> batch_stats.
"""

from __future__ import annotations

from typing import Mapping, MutableMapping

import numpy as np


def _set(tree: MutableMapping, path: list[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def strip_ddp_prefix(state_dict: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {k.removeprefix("module."): v for k, v in state_dict.items()}


def flax_location(key: str, ndim: int, keys) -> tuple | None:
    """Where :func:`torch_state_dict_to_flax` puts the torch entry
    ``key`` (of rank ``ndim``) of a state dict whose keys are ``keys``
    (without the DDP prefix): ``(collection, path, perm)``, ``collection``
    'params' or 'batch_stats', ``path`` the Flax tree path (a list of
    names) and ``perm`` the torch dimension of each Flax dimension (the
    Flax value is ``value.transpose(perm)``).  None for an entry Flax has
    no leaf for (``num_batches_tracked``)."""
    if key.endswith("num_batches_tracked"):
        return None
    parts = key.split(".")
    leaf = parts[-1]
    mods = parts[:-1]
    # Rename the STConv3D internals: conv1/bn1 (+conv2/bn2 when separable)
    # -> conv/bn or conv_spatial/bn_spatial + conv_temporal/bn_temporal.
    renamed: list[str] = []
    for i, m in enumerate(mods):
        if m in ("conv1", "bn1", "conv2", "bn2") and i == len(mods) - 1:
            prefix = ".".join(mods[:i])
            separable = f"{prefix}.conv2.weight" in keys
            if separable:
                m = {"conv1": "conv_spatial", "bn1": "bn_spatial",
                     "conv2": "conv_temporal", "bn2": "bn_temporal"}[m]
            else:
                m = {"conv1": "conv", "bn1": "bn"}[m]
        renamed.append(m)
    mods = renamed
    same = tuple(range(ndim))

    is_bn = mods and mods[-1].startswith("bn")
    if is_bn and leaf in ("running_mean", "running_var"):
        return ("batch_stats", mods + [{"running_mean": "mean",
                                        "running_var": "var"}[leaf]], same)
    if is_bn:
        return "params", mods + [{"weight": "scale", "bias": "bias"}[leaf]], same
    if leaf == "weight":
        if ndim == 5:            # Conv3d (O, I, t, h, w) -> (t, h, w, I, O)
            return "params", mods + ["kernel"], (2, 3, 4, 1, 0)
        if ndim == 2:
            if mods and mods[-1] == "word_embd":   # Embedding
                return "params", mods + ["embedding"], same
            return "params", mods + ["kernel"], (1, 0)   # Linear
        raise ValueError(f"unexpected weight rank for {key}: {ndim}")
    if leaf == "bias":
        return "params", mods + ["bias"], same
    raise ValueError(f"unrecognized checkpoint entry: {key}")


def torch_state_dict_to_flax(state_dict: Mapping[str, np.ndarray]) -> dict:
    """Return ``{'params': ..., 'batch_stats': ...}`` nested dicts matching
    ``milnce_tpu.models.S3D``."""
    sd = strip_ddp_prefix(state_dict)
    params: dict = {}
    stats: dict = {}
    for key, raw in sd.items():
        val = np.asarray(raw)
        where = flax_location(key, val.ndim, sd)
        if where is None:
            continue
        collection, path, perm = where
        _set(params if collection == "params" else stats, path,
             val.transpose(perm))
    return {"params": params, "batch_stats": stats}


def flax_to_torch_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """Inverse of ``torch_state_dict_to_flax``: Flax S3D variables ->
    a flat torch-style state dict the reference's scripts can load
    (eval_msrvtt.py:21-32 flat flavor; wrap under ``{'state_dict':
    {'module.'+k: v}}`` for the DDP flavor).

    Completes the interop loop: train here, evaluate there.  Inversion
    is pinned by a roundtrip test (tests/test_reference_parity.py)."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path, in_stats):
        if not isinstance(node, Mapping):
            _emit_leaf(out, path, np.asarray(node), in_stats)
            return
        for k, v in node.items():
            walk(v, path + [k], in_stats)

    walk(variables.get("params", {}), [], False)
    walk(variables.get("batch_stats", {}), [], True)
    # torch BN modules track an update count; emit one per running_mean so
    # a strict load_state_dict finds every expected key
    for key in [k for k in out if k.endswith("running_mean")]:
        out[key.removesuffix("running_mean") + "num_batches_tracked"] = (
            np.asarray(0, np.int64))
    return out


_INV_CONV = {"conv_spatial": "conv1", "bn_spatial": "bn1",
             "conv_temporal": "conv2", "bn_temporal": "bn2",
             "conv": "conv1", "bn": "bn1"}


def _emit_leaf(out: dict, path: list[str], val: np.ndarray,
               in_stats: bool) -> None:
    mods = [_INV_CONV.get(m, m) for m in path[:-1]]
    leaf = path[-1]
    prefix = ".".join(mods)
    if in_stats:
        out[f"{prefix}.{ {'mean': 'running_mean', 'var': 'running_var'}[leaf] }"] = val
    elif leaf == "scale":
        out[f"{prefix}.weight"] = val
    elif leaf == "bias":
        out[f"{prefix}.bias"] = val
    elif leaf == "embedding":
        out[f"{prefix}.weight"] = val
    elif leaf == "kernel":
        if val.ndim == 5:            # flax (t,h,w,I,O) -> torch (O,I,t,h,w)
            out[f"{prefix}.weight"] = val.transpose(4, 3, 0, 1, 2)
        elif val.ndim == 2:          # flax (I,O) -> torch (O,I)
            out[f"{prefix}.weight"] = val.transpose(1, 0)
        else:
            raise ValueError(f"unexpected kernel rank at {prefix}: {val.shape}")
    else:
        raise ValueError(f"unrecognized flax leaf: {'.'.join(path)}")


def load_jax_variables(model, variables: Mapping):
    """Load Flax S3D variables (``{'params': ..., 'batch_stats': ...}``
    with numpy leaves) into the port's ``model`` with a strict
    ``load_state_dict`` and return the model.  The BatchNorm update
    counters keep their current values (Flax has none)."""
    import torch

    sd = flax_to_torch_state_dict(variables)
    own = model.state_dict()
    tensors = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked") and key in own:
            tensors[key] = own[key]
            continue
        ref = own.get(key)
        dtype = ref.dtype if ref is not None else torch.float32
        tensors[key] = torch.as_tensor(np.array(val), dtype=dtype)
    model.load_state_dict(tensors, strict=True)
    return model


def load_torch_checkpoint_as_flax(path: str) -> dict:
    """torch.load a reference checkpoint file — either flavor
    (eval_msrvtt.py:21-32): the DDP ``{'state_dict': ...}`` wrapper or the
    upstream flat table — and convert to Flax variables.  The one place
    the library imports torch (train resume, eval CLI and the assets
    converter all route through here)."""
    sd = _read_reference_state_dict(path)
    return torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()})


def _read_reference_state_dict(path: str) -> dict:
    """torch.load a reference checkpoint file — either flavor
    (eval_msrvtt.py:21-32): the DDP ``{'state_dict': ...}`` wrapper or the
    upstream flat table — as a flat dict of tensors without the DDP
    ``module.`` prefix."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return strip_ddp_prefix({k: v for k, v in sd.items()
                             if isinstance(v, torch.Tensor)})


def load_reference_checkpoint(model, path: str):
    """Load a reference ``.pth``/``.pth.tar`` into the port's ``model``,
    whose parameters keep the reference's names and layouts, with a
    strict ``load_state_dict``; returns the model.  BatchNorm update
    counters the file lacks (the upstream flat flavor) keep their
    values."""
    sd = _read_reference_state_dict(path)
    for key, val in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd.setdefault(key, val)
    model.load_state_dict(sd, strict=True)
    return model
