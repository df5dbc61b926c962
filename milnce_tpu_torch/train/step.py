"""The train step and the embedding functions (port of
``milnce_tpu/train/step.py``, the 1-D data-parallel step).

A step takes the uint8 ``(B, T, H, W, 3)`` clip, the ``(B*K, W)`` token
ids and the ``(B,)`` f32 clip start times already on the device, divides
the clip by 255 there in the model's compute dtype, runs both towers in
train mode, the loss and the backward, then the optimizer.  ``loss.name``
picks the loss: ``milnce`` scores pooled embeddings; the DTW family
(``cdtw``, ``sdtw_cidm``, ``sdtw_negative``, ``sdtw_3``) runs the model
with ``mode="sequence"`` and scores the (B, T', D) video sequences
against the (B, K, D) candidate-text sequences; only ``sdtw_cidm`` reads
``start``.  A bf16
model (``model.dtype = bfloat16``) hands the losses bf16 embeddings and
gets f32 parameter gradients back through its casts, so the reduction,
the finite guard and the fused optimizer run in f32 as for an f32
model.

Across the ranks of a ``group`` each rank steps its shard of the global
batch, as the JAX step's ``shard_map`` body does:

- MIL-NCE gathers the embeddings and scores the local rows and columns;
  its value is the sum over the ranks with the gradient of the local
  term, so the gradients are SUMMED over the ranks (JAX ``psum``).  The
  DTW family gathers the sequences and start times and scores the whole
  gathered batch on every rank, a replicated loss whose gradient reaches
  each rank once from every rank's copy, so the gradients are AVERAGED
  (JAX ``pmean``).  Either is one all-reduce of the flattened gradients
  after the backward, the JAX 1-D step's single fused reduction.
- After the update every BatchNorm's running mean and variance are
  averaged over the ranks (JAX ``pmean`` of ``batch_stats``).
- The finite guard judges the reduced gradients, so every rank skips
  together.  The returned loss is the global value on every rank.

With no group, nothing of that runs: the gradients are autograd's.  With
the finite guard on, a non-finite gradient keeps the parameters, the
Adam moments and step counts and the BatchNorm statistics as they were
and the schedule does not advance; the caller's step count still does,
as in the JAX step.  The guard reads nothing on the host: ``skipped``
comes back as a 0-d int32 on the device (:class:`_Update`).  An armed ``grad.nonfinite`` fault (``resilience/faults.py``, read
when the step is built) multiplies the reduced gradients by NaN on its
scheduled optimizer steps, numbered ``first_step + 1, first_step + 2,
...`` by the step itself, skipped steps included (the JAX
``state.step + 1``): the loop hands a resumed run's restored count in.

:func:`make_grad_cache_step` is the JAX two-pass embedding-cache step
(``train.grad_accum`` microbatches, exact full-batch negatives).

The 2-D ``(data, model)`` layout (JAX ``state_specs``/``model_axis``):
both steps take a ``placement`` (``parallel/sharding_map.py``), and the
step goes FSDP.  ``group`` stays the whole group: the batch shards over
both axes, every rank a data shard, so the gathers of the losses, the
global-batch semantics and local BatchNorm are the 1-D layout's.  The
sharded parameters are gathered before the forward (the grad-cache
step: once, before pass 1); after the backward their gradients are
reduce-scattered over the model axis then summed over data, and the
replicated ones summed over both axes (SUM for MIL-NCE, MEAN for the DTW
family, as in 1-D); the optimizer then steps the local slices only.
Each model column's guard sees only its slices, so the finite verdict is
agreed over the model axis (JAX ``_uniform_finite_verdict``): a NaN in
one column's slice makes every rank skip.  ``inner_steps`` is not
ported (a benchmark knob of the JAX step).
"""

from __future__ import annotations

import torch

from milnce_tpu_torch.losses.dtw_losses import (cdtw_batch_loss, sdtw_3_loss,
                                                sdtw_cidm_loss,
                                                sdtw_negative_loss)
from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss
from milnce_tpu_torch.models.s3dg import BatchNorm3d, frozen_running_stats
from milnce_tpu_torch.parallel.dist import (all_gather_tiled, all_reduce_flat,
                                            reduce_flag_device)
from milnce_tpu_torch.resilience import faults

KNOWN_LOSSES = ("milnce", "cdtw", "sdtw_cidm", "sdtw_negative", "sdtw_3")


def _check_loss_name(loss_cfg) -> str:
    """Reject a bad loss name when the step is built, before any model
    runs."""
    name = getattr(loss_cfg, "name", "milnce")
    if name not in KNOWN_LOSSES:
        raise ValueError(f"unknown loss {name!r} (expected one of "
                         f"{', '.join(KNOWN_LOSSES)})")
    return name


def _sequence_loss(loss_cfg, v_seq, t_seq, start, group=None):
    """DTW-family losses on the sequence embeddings: v_seq (B, T', D),
    t_seq (B, K, D), start (B,), gathered over the ranks of ``group``
    first (the fork's losses score the whole gathered batch)."""
    if group is not None:
        v_seq = all_gather_tiled(v_seq, group)
        t_seq = all_gather_tiled(t_seq, group)
        start = all_gather_tiled(start, group)
    common = dict(backend=loss_cfg.sdtw_backend, dist=loss_cfg.sdtw_dist,
                  bandwidth=loss_cfg.sdtw_bandwidth)
    if loss_cfg.sdtw_gamma is not None:
        # None = each loss function's own reference-default gamma
        # (cdtw 1e-5, sdtw_* 0.1 — encoded in their signatures)
        common["gamma"] = loss_cfg.sdtw_gamma
    dispatch = {
        "cdtw": lambda: cdtw_batch_loss(v_seq, t_seq, **common),
        "sdtw_cidm": lambda: sdtw_cidm_loss(
            v_seq, t_seq, start, sigma=loss_cfg.cidm_sigma,
            lam=loss_cfg.cidm_lambda, **common),
        "sdtw_negative": lambda: sdtw_negative_loss(v_seq, t_seq, **common),
        "sdtw_3": lambda: sum(sdtw_3_loss(
            v_seq, t_seq, pair_chunk=loss_cfg.sdtw_pair_chunk, **common)),
    }
    return dispatch[loss_cfg.name]()


def _normalize(video_u8: torch.Tensor, model) -> torch.Tensor:
    """uint8 clip -> [0, 1] in the model's compute dtype (else its
    parameters'), divided in it (a bf16 model: ``u8.astype(bf16) / 255``
    in bf16, as the JAX step normalizes straight into the compute
    dtype)."""
    dtype = (getattr(model, "compute_dtype", None)
             or next(model.parameters()).dtype)
    return video_u8.to(dtype) / 255.0


def _running_stats(model) -> list:
    return [buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("running_mean", "running_var")]


class _Update:
    """What follows the backward in both steps, as the JAX step orders
    it: the one all-reduce of the gradients over the group (SUM for
    MIL-NCE, MEAN for the DTW family), the ``grad.nonfinite`` poison, the
    finite guard, the optimizer and the schedule, then the BatchNorm
    statistics averaged over the group.  It counts the optimizer steps
    (skipped ones too) from ``first_step``.

    The guard is the JAX ``_all_finite``/``_select_tree`` with no host
    sync: one fused multi-tensor check of the reduced gradients writes a
    0-d device verdict (1.0 = a non-finite value), agreed over the model
    axis on the 2-D layout (one flag all-reduce, the JAX
    ``_uniform_finite_verdict``).  The fused optimizer takes it as
    ``found_inf`` and then moves no parameter, moment or step count; the
    schedule's count advances by ``1 - verdict``; the buffers are
    selected back to their pre-step values on the device.  The collectives
    are the plain step's, whatever the verdict."""

    def __init__(self, model, optimizer, finite_guard, lr_scheduler, group,
                 mean, first_step, placement=None):
        self.placement = placement
        self.optimizer, self.lr_scheduler = optimizer, lr_scheduler
        self.finite_guard, self.group, self.mean = finite_guard, group, mean
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.running = _running_stats(model)
        self.poison = faults.device_schedule("grad.nonfinite")
        self.count = int(first_step)
        self.by_dtype = {}          # the buffers the guard restores
        for buf in model.buffers():
            self.by_dtype.setdefault(buf.dtype, []).append(buf)
        if finite_guard and not optimizer.defaults.get("fused"):
            raise ValueError("the finite guard needs a fused optimizer "
                             "(train/state.py::build_optimizer): it hands "
                             "its verdict in as found_inf")
        self._one = None

    def save(self):
        """The buffers the guard restores on a skip, one flat copy a
        dtype (None: guard off)."""
        if not self.finite_guard:
            return None
        return {dt: torch.cat([b.reshape(-1) for b in bufs])
                for dt, bufs in self.by_dtype.items()}

    def _nonfinite(self, grads):
        """1.0 when any gradient holds a NaN or an infinity, else 0.0: a
        0-d float32 on the gradients' device, from one fused check."""
        found = torch.zeros((), device=grads[0].device)
        if self._one is None or self._one.device != found.device:
            self._one = torch.ones((), device=found.device)
        torch._amp_foreach_non_finite_check_and_unscale_(grads, found,
                                                         self._one)
        return found

    def _restore(self, saved, skip) -> None:
        """Each buffer back to its saved value where ``skip`` holds."""
        for dt, bufs in self.by_dtype.items():
            now = torch.cat([b.reshape(-1) for b in bufs])
            keep = torch.where(skip, saved[dt], now)
            torch._foreach_copy_(bufs, [part.view_as(b) for part, b in zip(
                keep.split([b.numel() for b in bufs]), bufs)])

    def __call__(self, loss, saved):
        self.count += 1
        if self.placement is not None:
            self.placement.reduce_grads_2d(self.mean)
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.placement is None and self.group is not None:
            all_reduce_flat(grads, self.group, mean=self.mean)
        if self.poison is not None and self.poison.scheduled(self.count):
            torch._foreach_mul_(grads, float("nan"))
        found = None
        if self.finite_guard:
            found = self._nonfinite(grads)
            if self.placement is not None:
                reduce_flag_device(found, self.placement.grid.model_group)
        # set either way: an unguarded step must not read a verdict that a
        # guarded one left on the same optimizer
        self.optimizer.found_inf = found
        self.optimizer.step()
        if self.lr_scheduler is not None:
            self.lr_scheduler.advance(None if found is None else 1.0 - found)
        if self.group is not None:
            with torch.no_grad():
                all_reduce_flat(self.running, self.group, mean=True)
        if found is None:
            return loss.detach()
        with torch.no_grad():
            self._restore(saved, found > 0)
        return loss.detach(), found.to(torch.int32)


def make_train_step(model, optimizer, loss_cfg=None,
                    finite_guard: bool = False, lr_scheduler=None,
                    group=None, first_step: int = 0, placement=None):
    """-> ``step(video_u8, text_ids, start)`` returning the loss (a 0-d
    tensor on the device), or ``(loss, skipped)`` with ``finite_guard``,
    where ``skipped`` (a 0-d int32 on the device) is 1 when the update was
    dropped.  ``optimizer``/``lr_scheduler``: ``train/state.py::
    build_optimizer``'s (fused, and a :class:`DeviceLR`).  ``group``: the
    ranks stepping the global batch together (None = this process
    alone).  ``first_step``: optimizer steps already taken (a resumed
    run's), from which the ``grad.nonfinite`` fault counts.  A bad loss
    name or MIL-NCE knob raises here.  ``step.fwd_bwd(video_u8, text_ids,
    start)`` is the step's forward and backward alone (no reduction, no
    update), for the curriculum's memory pre-flight.  ``placement``: the
    2-D layout (module docstring; ``group`` must be its whole group)."""
    loss_name = _check_loss_name(loss_cfg)
    milnce_fn = (build_milnce_loss(loss_cfg, group) if loss_name == "milnce"
                 else None)
    update = _Update(model, optimizer, finite_guard, lr_scheduler, group,
                     milnce_fn is None, first_step, placement)

    def compute_loss(video_u8, text_ids, start):
        video = _normalize(video_u8, model)
        if milnce_fn is not None:
            return milnce_fn(*model(video, text_ids))
        v_seq, t_embd = model(video, text_ids, mode="sequence")
        b = video.shape[0]
        t_seq = t_embd.reshape(b, -1, t_embd.shape[-1])      # (B, K, D)
        return _sequence_loss(loss_cfg, v_seq, t_seq, start, group)

    def fwd_bwd(video_u8, text_ids, start):
        model.train()
        loss = compute_loss(video_u8, text_ids, start)
        loss.backward()
        return loss

    return _assemble(fwd_bwd, update, optimizer, placement)


def make_grad_cache_step(model, optimizer, micro_batches: int, loss_cfg=None,
                         finite_guard: bool = False, lr_scheduler=None,
                         group=None, first_step: int = 0, placement=None):
    """The two-pass embedding-cache step (GradCache; JAX
    ``make_grad_cache_step``) for MIL-NCE and the DTW family: the same
    ``step(video_u8, text_ids, start)`` as :func:`make_train_step`, over
    ``micro_batches`` microbatches of the batch it is given.

    A contrastive loss does not split over plain gradient-accumulation
    microbatches: every clip scores against every other clip of the
    batch.  So:

    1. under ``no_grad``, embed each microbatch (``B/M`` clips and their
       ``B/M·K`` captions; sequences for the DTW family) and keep only the
       embeddings;
    2. run the loss once on the concatenated cache, leaf tensors that
       require grad, and take its gradient with respect to them: the
       MIL-NCE stream runs once a step at ``B_local = B``, over the group
       as in :func:`make_train_step`;
    3. re-forward each microbatch with grad and seed its backward with
       its slice of the cache's gradient; the parameter gradients
       accumulate in ``.grad``.

    The gradients are reduced over the group once, after pass 2, never a
    microbatch at a time (the JAX ``scan-reduction-free`` invariant).

    Each microbatch normalizes with its own BatchNorm statistics, a
    virtual data-parallel shard with local BN.  Its running statistics:
    each microbatch of pass 1 folds its statistics into the *same* old
    running statistics and the new ones are the mean of those M folds
    (then averaged over the group after the update), as the JAX step's
    ``mean(stats_mb)``; pass 2 folds nothing (:func:`frozen_running_stats`).
    ``num_batches_tracked`` advances by one an optimizer step.  Under sync
    BatchNorm each microbatch's forward syncs over the ranks in both
    passes.  The cost is pass 2's repeated forward; the activations of
    one microbatch live at a time."""
    if micro_batches < 2:
        raise ValueError(f"micro_batches={micro_batches}: use "
                         "make_train_step for one microbatch")
    loss_name = _check_loss_name(loss_cfg)
    milnce_fn = (build_milnce_loss(loss_cfg, group) if loss_name == "milnce"
                 else None)
    update = _Update(model, optimizer, finite_guard, lr_scheduler, group,
                     milnce_fn is None, first_step, placement)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm3d)]
    mode = {} if milnce_fn is not None else {"mode": "sequence"}

    def embed(video_u8, text_ids):
        return model(_normalize(video_u8, model), text_ids, **mode)

    def loss_of(v, t, start):
        if milnce_fn is not None:
            return milnce_fn(v, t)
        t_seq = t.reshape(v.shape[0], -1, t.shape[-1])       # (B, K, D)
        return _sequence_loss(loss_cfg, v, t_seq, start, group)

    def fwd_bwd(video_u8, text_ids, start):
        b = video_u8.shape[0]
        if b % micro_batches:
            raise ValueError(f"batch {b} does not split into "
                             f"{micro_batches} microbatches")
        bm = b // micro_batches
        rows = text_ids.shape[0] // b * bm
        vids, txts = video_u8.split(bm), text_ids.split(rows)
        model.train()
        # pass 1: the embeddings alone; every microbatch folds into the
        # old running statistics, which end as the mean of the M folds
        old = [r.clone() for r in update.running]
        folds = [torch.zeros_like(r) for r in update.running]
        tracked = [m.num_batches_tracked.clone() for m in norms]
        v_mb, t_mb = [], []
        with torch.no_grad():
            for vu8, tids in zip(vids, txts):
                torch._foreach_copy_(update.running, old)
                v, t = embed(vu8, tids)
                v_mb.append(v)
                t_mb.append(t)
                torch._foreach_add_(folds, update.running)
            torch._foreach_div_(folds, micro_batches)
            torch._foreach_copy_(update.running, folds)
            for m, n in zip(norms, tracked):
                m.num_batches_tracked.copy_(n + 1)
        # the loss once, on the whole cache
        v_all = torch.cat(v_mb).requires_grad_()
        t_all = torch.cat(t_mb).requires_grad_()
        loss = loss_of(v_all, t_all, start)
        g_v, g_t = torch.autograd.grad(loss, (v_all, t_all))
        # pass 2: each microbatch again, its backward seeded by its slice
        with frozen_running_stats(model):
            for vu8, tids, gv, gt in zip(vids, txts, g_v.split(bm),
                                         g_t.split(rows)):
                torch.autograd.backward(embed(vu8, tids), (gv, gt))
        return loss

    return _assemble(fwd_bwd, update, optimizer, placement)


def _assemble(fwd_bwd, update: _Update, optimizer, placement):
    """The step of a forward-and-backward: zero the gradients, gather the
    sharded parameters (2-D layout), forward and backward, then the
    update, which reduces.  Its ``fwd_bwd`` attribute is the forward and
    backward alone, leaving a 2-D layout's parameters as their slices
    with no gradient."""

    def step(video_u8: torch.Tensor, text_ids: torch.Tensor,
             start: torch.Tensor):
        saved = update.save()
        optimizer.zero_grad(set_to_none=True)
        if placement is not None:
            placement.gather_params()
        return update(fwd_bwd(video_u8, text_ids, start), saved)

    def fwd_bwd_alone(video_u8, text_ids, start):
        if placement is None:
            return fwd_bwd(video_u8, text_ids, start)
        with placement.full_params():
            return fwd_bwd(video_u8, text_ids, start)

    step.fwd_bwd = fwd_bwd_alone
    return step


def make_video_embed_fn(model, mixed5c: bool = False):
    """No-grad eval-mode video embeddings: ``fn(video_u8) -> (B, D)``, or
    the 1024-d mixed_5c features with ``mixed5c=True``."""

    @torch.no_grad()
    def embed(video_u8: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(_normalize(video_u8, model), None, mode="video",
                     mixed5c=mixed5c)

    return embed


def make_text_embed_fn(model):
    """No-grad text embeddings: ``fn(text_ids) -> (B', D)``."""

    @torch.no_grad()
    def embed(text_ids: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(None, text_ids, mode="text")

    return embed
