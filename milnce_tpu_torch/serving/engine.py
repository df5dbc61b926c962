"""Frozen-param inference engine: a bucket ladder swept at start-up,
explicit transfers (port of ``milnce_tpu/serving/engine.py``).

The engine packages the port's embed towers (``train/step.py``
``make_text_embed_fn`` / ``make_video_embed_fn`` — the same no-grad
eval-mode entries offline eval uses, so served numbers ARE eval
numbers) behind the JAX engine's discipline:

- **a group of devices**: the engine serves on an ordered list of
  devices in one process, as the JAX engine serves over its mesh's data
  axis: one copy of the model on each, every bucket's rows split into
  ``len(group)`` equal contiguous shards in order.  One device is the
  group of one.  The list may name one card more than once.
- **bucket ladder**: batch entries exist only at a power-of-two ladder
  of batch sizes, each divisible by the group's size, so every bucket
  shards evenly.  Requests are padded UP to the smallest bucket that
  fits, so the towers only ever see ``len(buckets) x 2`` input shapes.
- **warm-up at start-up**: every (entry, bucket) pair runs once in
  ``__init__`` (cuDNN's kernels chosen, the caching allocator's blocks
  carved), so first-request latency is steady-state latency.
- **explicit transfers**: each shard of a request's rows goes to its
  device with one explicit copy and its embeddings come back with one,
  all under the dispatch lock; nothing else crosses.
- **recompile accounting**: :meth:`recompiles` counts the (entry, input
  shape) pairs that reached the device after the warm-up sweep and were
  not part of it — 0 for the life of a healthy process.

Frozen params: the engine takes the model (and optionally Flax-shaped
``{'params', 'batch_stats'}`` variables, loaded into it with a strict
``load_state_dict``), moves a copy to each device of its group once and
keeps them in eval mode; no optimizer state exists here (see
``serving/export.py``).
``dtype="bfloat16"`` (``serve.dtype``) serves a bf16 model as the JAX
engine does: the model computes in bf16 and every float leaf, parameters
and BatchNorm statistics, is cast to bf16 on the device; the embeddings
come back as float32 arrays of the bf16 values.  An export whose model
config says bfloat16 computes in bf16 over its f32 arrays without it.
The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
a ``cuda`` request without a card, or naming a card that is not there,
raises, and nothing falls back to the CPU or narrows a group.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from milnce_tpu_torch.analysis.lockrt import make_lock
from milnce_tpu_torch.models.precision import torch_dtype
from milnce_tpu_torch.obs import spans as obs_spans
from milnce_tpu_torch.resilience import faults
from milnce_tpu_torch.serving.batcher import pad_rows
from milnce_tpu_torch.train.step import make_text_embed_fn, make_video_embed_fn


class ReplicaDead(RuntimeError):
    """The engine has been force-killed (``serve.replica_dead`` fault or
    :meth:`InferenceEngine.kill`) — every dispatch fails instantly until
    the process restarts."""


# One device-dispatch queue per process, shared by every serving
# component that executes on the device (engine entries AND
# index.topk): a device executes one stream of work anyway, so
# serialized dispatch is the semantics the hardware gives, made explicit
# (and each request's copies stay next to its own compute).
# Request-level concurrency belongs ABOVE this lock, in the batcher.
# Created through make_lock so MILNCE_LOCK_SANITIZE=1 (set before
# import) swaps in the order-checking SanitizedLock.
DEVICE_DISPATCH_LOCK = make_lock("serving.device_dispatch")


def serving_group(devices) -> list:
    """One device, or an ordered list of them (a group; it may name one
    card more than once), as a list of torch devices of one type.  Checked
    before anything loads: ``cuda`` without a card raises instead of
    falling back to the CPU, and so does a card that is not there; nothing
    narrows the group."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    group = [torch.device(d) for d in devices]
    if not group:
        raise ValueError("an empty device group")
    cards = [d for d in group if d.type == "cuda"]
    if cards and not torch.cuda.is_available():
        raise RuntimeError(f"serving device {cards[0]} requested but no "
                           "CUDA device is visible (pass device='cpu')")
    count = torch.cuda.device_count() if cards else 0
    missing = [str(d) for d in cards
               if d.index is not None and d.index >= count]
    if missing:
        raise RuntimeError(f"serving devices {missing} requested but only "
                           f"{count} CUDA devices are visible")
    if len({d.type for d in group}) > 1:
        raise ValueError(f"a device group mixes device types: {group}")
    return group


def refuse_two_groups(group: list, process_group) -> None:
    """A process group of ranks AND a device group in each rank is
    multi-host serving, which the port does not serve."""
    if process_group is not None and len(group) > 1:
        raise ValueError(
            f"a device group of {len(group)} devices together with a "
            "process group (group=) is multi-host serving, which is not "
            "ported: pass one of the two")


def bucket_ladder(n_dev: int, min_bucket: int, max_batch: int) -> tuple:
    """Power-of-two batch buckets, each divisible by the data axis.

    Starts at the smallest power of two >= max(min_bucket, n_dev) and
    doubles up to ``max_batch`` inclusive.  On a power-of-two axis every
    rung then shards evenly."""
    start = max(int(min_bucket) or n_dev, n_dev)
    b = 1
    while b < start:
        b *= 2
    if b % n_dev:
        raise ValueError(
            f"bucket {b} is not divisible by the {n_dev}-way data axis — "
            "pick min_bucket as a multiple of the mesh size")
    if b > max_batch:
        raise ValueError(f"max_batch={max_batch} is below the smallest "
                         f"shardable bucket {b} on a {n_dev}-device mesh")
    out = []
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


def cast_floats(tree, dtype):
    """Cast floating leaves of a nested dict of arrays or tensors
    (params/batch_stats) to ``dtype``; integer leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.to(getattr(torch, dtype)) if tree.is_floating_point()
                else tree)
    x = np.asarray(tree)
    return x.astype(dtype) if np.issubdtype(x.dtype, np.floating) else x


def load_serving_model(export_dir: str, dtype: str = ""):
    """Load a ``milnce-export``-family artifact -> ``(model, variables,
    metadata)`` ready for an :class:`InferenceEngine`: the port's S3D
    built from the artifact's model config (on the CPU) and its Flax
    variables — ``{'params', 'batch_stats'}`` for the f32 format (v1),
    plus ``'quant_scales'`` for the quantized one (v2), which the engine
    serves through :class:`~milnce_tpu_torch.quant.quantize.QuantizedModel`
    (int8 resident, dequantized inside every call).

    ``dtype`` overrides the exported model's compute dtype (the engine's
    ``cast_dtype`` then casts the variables, as the JAX engine's does).
    Refused, each with its reason: a ``dtype`` override on a v2 artifact
    (its int8 weights and f32 scales are its precision contract, as in
    JAX); a model config the port's ``build_model`` refuses (a dtype
    other than float32 or bfloat16, ``conv_impl_map``)."""
    from milnce_tpu_torch.config import ModelConfig
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.serving.export import (QUANT_FORMAT_VERSION,
                                                 load_inference_checkpoint,
                                                 load_quantized_checkpoint,
                                                 read_export_metadata)

    quantized = (read_export_metadata(export_dir).get("format_version")
                 == QUANT_FORMAT_VERSION)
    if quantized:
        if dtype:
            raise ValueError(
                "dtype override is not supported for quantized exports "
                "— int8 weights + f32 scales are the artifact's "
                "precision contract")
        meta, variables = load_quantized_checkpoint(export_dir)
    else:
        meta, variables = load_inference_checkpoint(export_dir)
    model_cfg = ModelConfig(**meta["model"])
    if dtype:
        model_cfg.dtype = dtype
    model = build_model(model_cfg)
    return model, variables, meta


class InferenceEngine:
    """Bucketed embed entries over frozen params, warmed at start-up.

    - ``model``: the port's S3D; the engine owns it from here (moves it
      to the group's first device and a copy to each other one, keeps
      them in eval mode).
    - ``device``: one device or an ordered group of them (see the module
      docstring); ``self.device`` is the group's first.
    - ``variables``: optional Flax-shaped ``{'params': ..., 'batch_stats':
      ...}`` (an export's arrays, or the JAX package's variables), loaded
      into ``model``; with ``'quant_scales'`` (a v2 artifact) the engine
      serves ``QuantizedModel(model, variables)``: int8 on the device,
      dequantized inside every call.  None serves the model's own
      weights.
    - ``cast_dtype``: optional float dtype ('bfloat16') the frozen
      parameters and BatchNorm statistics are cast to at load (the JAX
      engine's ``cast_dtype``); the model must be built with the matching
      compute dtype (:meth:`from_export` wires both).
    - ``text_words`` / ``video_shape``: the fixed per-row input shapes
      ((W,) token ids / (T, H, W, 3) uint8 frames); requests with any
      other trailing shape are rejected.
    - ``dispatch_lock``: the lock serializing this engine's device work
      and copies; default the process-wide :data:`DEVICE_DISPATCH_LOCK`.
    """

    def __init__(self, model, variables=None, *, device="cuda",
                 text_words: int, video_shape: Sequence[int],
                 max_batch: int = 64, min_bucket: int = 0,
                 cast_dtype: Optional[str] = None, precompile: bool = True,
                 dispatch_lock=None):
        self.group = serving_group(device)
        self.device = self.group[0]
        self._dispatch_lock = (dispatch_lock if dispatch_lock is not None
                               else DEVICE_DISPATCH_LOCK)
        self.buckets = bucket_ladder(len(self.group), min_bucket, max_batch)
        self.max_batch = self.buckets[-1]
        self.text_words = int(text_words)
        self.video_shape = tuple(int(d) for d in video_shape)
        if variables is not None and "quant_scales" in variables:
            from milnce_tpu_torch.quant.quantize import QuantizedModel

            model = QuantizedModel(model, variables)
        elif variables is not None:
            from milnce_tpu_torch.utils.torch_convert import load_jax_variables

            load_jax_variables(model, variables)
        if cast_dtype:
            model = model.to(torch_dtype(cast_dtype))
        # one explicit move at boot, a copy a shard; steady state never
        # moves params
        copies = [model] + [copy.deepcopy(model) for _ in self.group[1:]]
        self.models = [m.to(dev).eval() for m, dev in zip(copies,
                                                          self.group)]
        self.model = self.models[0]
        self._fns = {"text": [make_text_embed_fn(m) for m in self.models],
                     "video": [make_video_embed_fn(m) for m in self.models]}
        # Bookkeeping shared by the batcher worker, request threads and
        # health readers — guarded by its own tiny lock, NEVER the
        # dispatch lock (stats reads must not contend with device work).
        self._stats_lock = make_lock("serving.engine.stats")
        self._calls: dict[tuple, int] = {}     # (entry, bucket) -> calls
        self._shapes: set = set()              # (entry, shape) dispatched
        self._baseline: Optional[frozenset] = None
        self.embed_dim: Optional[int] = None   # known after the first call
        self._dead = False                     # guarded-by: _stats_lock
        if precompile:
            self.warmup()

    # ---- bucket ladder ---------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` rows."""
        if n < 1:
            raise ValueError(f"batch of {n} rows")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} rows exceeds max_batch={self.max_batch} "
                         "(split upstream, or rebuild with a taller ladder)")

    # ---- entries ---------------------------------------------------------

    def embed_text(self, token_ids: np.ndarray) -> np.ndarray:
        """(n, W) int32 token ids -> (n, D) float32 embeddings (a bf16
        model's values, widened); n is padded to the bucket internally and
        unpadded on return."""
        rows = np.ascontiguousarray(token_ids, dtype=np.int32)
        if rows.ndim != 2 or rows.shape[1] != self.text_words:
            raise ValueError(f"expected (n, {self.text_words}) token ids, "
                             f"got {rows.shape}")
        return self._run("text", rows)

    def embed_video(self, video_u8: np.ndarray) -> np.ndarray:
        """(n, T, H, W, 3) uint8 frames -> (n, D) float32 embeddings."""
        clips = np.ascontiguousarray(video_u8, dtype=np.uint8)
        if clips.shape[1:] != self.video_shape:
            raise ValueError(f"expected (n,) + {self.video_shape} uint8 "
                             f"video, got {clips.shape}")
        return self._run("video", clips)

    def _run(self, entry: str, rows: np.ndarray) -> np.ndarray:
        n = rows.shape[0]
        bucket = self.bucket_for(n)
        rows = pad_rows(rows, bucket)
        # Serving-path fault sites (resilience/faults.py).  Checked
        # BEFORE the dispatch lock: a dead replica fails instantly and a
        # hang wedges only this engine's callers, never the lock queue.
        if self.dead:
            raise ReplicaDead("replica is dead (serve.replica_dead / "
                              "kill()) — restart the process to revive it")
        faults.maybe_raise("serve.dispatch_raise")
        faults.maybe_hang("serve.dispatch_hang")
        if faults.fire_site("serve.replica_dead"):
            self.kill()
            raise ReplicaDead("injected fault at serve.replica_dead — "
                              "this replica is now permanently dead")
        # both legs of the request are explicit copies, next to its work:
        # every shard goes up and every card's forward is launched before
        # anything is read back, so the cards run side by side; the one
        # sync of the call is the first read back below (reading shard i
        # before shard i+1 is launched would run the cards one by one)
        shards = np.split(rows, len(self.group))
        with self._dispatch_lock:
            outs = [fn(torch.from_numpy(x).to(dev)) for fn, x, dev in
                    zip(self._fns[entry], shards, self.group)]
            out = np.concatenate([o.to("cpu").float().numpy()
                                  for o in outs])
        with self._stats_lock:
            self._calls[(entry, bucket)] = \
                self._calls.get((entry, bucket), 0) + 1
            self._shapes.add((entry, rows.shape))
            self.embed_dim = int(out.shape[-1])
        return out[:n]

    # ---- warmup + recompile accounting -----------------------------------

    def warmup(self) -> None:
        """Sweep BOTH entries over the full bucket ladder so every input
        shape the engine will ever run has run before the first request,
        then snapshot the shapes seen — any later new shape is a
        recompile (:meth:`recompiles`)."""
        with obs_spans.get_recorder().span("ladder.warmup",
                                           buckets=list(self.buckets)):
            for b in self.buckets:
                self.embed_text(np.zeros((b, self.text_words), np.int32))
                self.embed_video(np.zeros((b,) + self.video_shape, np.uint8))
        with self._stats_lock:
            self._baseline = frozenset(self._shapes)

    def recompiles(self) -> int:
        """(entry, input shape) pairs dispatched SINCE the warmup sweep
        that the sweep did not run; -1 before the warmup.  In the port it
        is 0 by construction, not a health signal: eager PyTorch compiles
        nothing, and ``_run`` pads every request to a bucket the sweep
        ran and rejects any other trailing shape.  It keeps the JAX
        engine's key so the two ``stats()`` agree."""
        with self._stats_lock:
            if self._baseline is None:
                return -1
            return len(self._shapes - self._baseline)

    # ---- liveness (pool failure isolation) -------------------------------

    @property
    def dead(self) -> bool:
        with self._stats_lock:
            return self._dead

    def kill(self) -> None:
        """Force-kill this engine: every subsequent dispatch raises
        :class:`ReplicaDead` instantly; there is no un-kill — recovery
        is a process restart."""
        with self._stats_lock:
            self._dead = True

    def stats(self) -> dict:
        with self._stats_lock:
            calls = dict(self._calls)
            dead = self._dead
        return {
            "buckets": list(self.buckets),
            "max_batch": self.max_batch,
            "recompiles": self.recompiles(),
            "dead": dead,
            "calls": {f"{entry}@{bucket}": n
                      for (entry, bucket), n in sorted(calls.items())},
        }

    # ---- construction from a frozen export -------------------------------

    @classmethod
    def from_export(cls, export_dir: str, *, device="cuda", dtype: str = "",
                    max_batch: int = 64, min_bucket: int = 0,
                    precompile: bool = True) -> "InferenceEngine":
        """Build model + engine from a ``milnce-export`` directory (either
        package's) on ``device``, one device or a group.  ``dtype``
        overrides the exported compute dtype ('bfloat16' builds the model
        at bf16 AND casts the frozen parameters and statistics; '' keeps
        the exported dtype); refusals as :func:`load_serving_model`, and a
        missing card before anything loads."""
        group = serving_group(device)
        model, variables, meta = load_serving_model(export_dir, dtype)
        return cls(model, variables, device=group,
                   text_words=meta["tokenizer"]["max_words"],
                   video_shape=meta["video_shape"],
                   max_batch=max_batch, min_bucket=min_bucket,
                   cast_dtype=(dtype or None), precompile=precompile)
