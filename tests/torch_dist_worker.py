"""Rank processes for ``tests/test_torch_dist.py``: imports torch and the
port only, never jax, so that each rank starts light.

:func:`spawn` starts ``world`` processes (``spawn`` start method), each
running ``fn(rank, world, group, *args)`` inside a gloo group that meets
at a ``FileStore`` under the test's directory (no port to collide with
other test workers), with a 60 s collective timeout; the parent joins
them against its own deadline and kills what is left, so a hung rank
fails its test instead of the suite's clock.  The arguments go to the
ranks through one pickle file: passed in the ``Process`` they would sit
in each child's pipe behind the import of this module (torch), and the
parent, blocked writing them, would start the ranks one import at a
time (8 ranks: ~20 s instead of ~5).  Each rank's result comes back
through a ``torch.save`` file; a rank that raises leaves its traceback
beside it.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
import traceback
import uuid
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from milnce_tpu_torch.config import LossConfig, OptimConfig
from milnce_tpu_torch.losses.milnce import milnce_loss
from milnce_tpu_torch.losses.milnce_chunked import milnce_loss_chunked
from milnce_tpu_torch.models.build import sync_batchnorm
from milnce_tpu_torch.models.s3dg import S3D
from milnce_tpu_torch.parallel.dist import all_gather_tiled
from milnce_tpu_torch.train.schedule import build_schedule
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train import step as step_module
from milnce_tpu_torch.train.step import (_sequence_loss, make_grad_cache_step,
                                         make_train_step)
from milnce_tpu_torch.utils.torch_convert import load_jax_variables

COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def _entry(fn, rank, world, store, workdir, tag, join_group):
    torch.set_num_threads(1)
    out = os.path.join(workdir, f"{tag}-rank{rank}")
    try:
        with open(os.path.join(workdir, f"{tag}-args.pkl"), "rb") as fh:
            args = pickle.load(fh)
        if join_group:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store, world), rank=rank,
                world_size=world, timeout=COLLECTIVE_TIMEOUT)
            try:
                result = fn(rank, world, dist.group.WORLD, *args)
            finally:
                dist.destroy_process_group()
        else:
            result = fn(rank, world, None, *args)
        torch.save(result, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn(fn, world: int, workdir, *args, join_group: bool = True,
          timeout: float = 300.0) -> list:
    """Run ``fn`` on ``world`` ranks; returns their results in rank
    order.  ``join_group=False`` hands ``fn`` no group (it joins its
    own, as ``run_training`` does)."""
    workdir = str(workdir)
    tag = uuid.uuid4().hex[:8]
    store = os.path.join(workdir, f"store-{tag}")
    with open(os.path.join(workdir, f"{tag}-args.pkl"), "wb") as fh:
        pickle.dump(args, fh)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, rank, world, store,
                                              workdir, tag, join_group))
             for rank in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still ran after "
                           f"{timeout} s")
    errors = []
    for rank, proc in enumerate(procs):
        if proc.exitcode != 0:
            path = os.path.join(workdir, f"{tag}-rank{rank}.err")
            text = open(path).read() if os.path.exists(path) else ""
            errors.append(f"rank {rank} exited {proc.exitcode}:\n{text}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(os.path.join(workdir, f"{tag}-rank{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def _shard(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rows ``rank * B .. (rank + 1) * B`` of a global array."""
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def _value_and_grads(fn, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = fn(*leaves)
    loss.backward()
    return (float(loss.detach()),) + tuple(x.grad.numpy() for x in leaves)


# ------------------------------------------------------------ loss ranks
def loss_cases(rank, world, group, gather, milnce, dtw):
    """Every loss-level case of one world size on this rank:

    - ``gather`` (x (W*B, D), cotangents (W, W*B, D)): the gathered value
      and this rank's gradient under its own cotangent;
    - ``milnce`` {name: (v, t, chunk)} global arrays: dense and chunked
      (plain stream) value and local gradients;
    - ``dtw`` {name: (v_seq, t_seq, start)} global arrays: the DTW loss
      named on the gathered batch, value and local gradients."""
    out = {}
    x, cots = gather
    local = torch.tensor(_shard(x, rank, world), requires_grad=True)
    gathered = all_gather_tiled(local, group)
    gathered.backward(torch.from_numpy(cots[rank]))
    out["gather"] = (gathered.detach().numpy(), local.grad.numpy())
    for name, (v, t, chunk) in milnce.items():
        vl, tl = _shard(v, rank, world), _shard(t, rank, world)
        out["dense", name] = _value_and_grads(
            lambda a, b: milnce_loss(a, b, group), vl, tl)
        out["chunked", name] = _value_and_grads(
            lambda a, b: milnce_loss_chunked(a, b, group, chunk=chunk,
                                             backend="scan"), vl, tl)
    for name, (v, t, start) in dtw.items():
        start_l = torch.from_numpy(_shard(start, rank, world))
        out["dtw", name] = _value_and_grads(
            lambda a, b: _sequence_loss(LossConfig(name=name), a, b, start_l,
                                        group),
            _shard(v, rank, world), _shard(t, rank, world))
    return out


# ------------------------------------------------------------ step ranks
def _state(model) -> dict:
    return {k: v.detach().clone().numpy()
            for k, v in model.state_dict().items()}


def step_run(rank, world, group, dims, variables, batches, sync_bn=False,
             poison=None, loss="milnce"):
    """Steps of the float64 port trainer from the JAX ``variables``, the
    loss named (MIL-NCE dense) with the finite guard, warmup 2 over 10
    steps.  ``batches``:
    global (video, text) pairs, of which this rank steps its rows (all of
    them without a group).  ``poison`` (rank, step index) NaNs that
    rank's gradients at that step.  Returns the losses, the skips, the
    state after each step and the last step's reduced gradients."""
    model = load_jax_variables(S3D(**dims).to(torch.float64), variables)
    if sync_bn:
        sync_batchnorm(model, group)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    step = make_train_step(model, optimizer,
                           LossConfig(name=loss, milnce_impl="dense"),
                           finite_guard=True, lr_scheduler=sched, group=group)
    losses, skips, states = [], [], []
    for i, (video, text) in enumerate(batches):
        if group is not None:
            video, text = _shard(video, rank, world), _shard(text, rank, world)
        hooks = []
        if poison == (rank, i):
            hooks = [p.register_hook(lambda g: g * float("nan"))
                     for p in model.parameters() if p.requires_grad]
        loss, skipped = step(torch.from_numpy(video), torch.from_numpy(text),
                             torch.zeros(video.shape[0]))
        for hook in hooks:
            hook.remove()
        losses.append(float(loss))
        skips.append(int(skipped))
        states.append(_state(model))
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None}
    return losses, skips, states, grads


# ------------------------------------------------------------ grad-cache ranks
def moments(model, optimizer) -> dict:
    """Adam's ``exp_avg`` / ``exp_avg_sq`` by parameter name."""
    out = {}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p)
        if state:
            out[name] = (state["exp_avg"].detach().clone().numpy(),
                         state["exp_avg_sq"].detach().clone().numpy())
    return out


def grad_cache_run(rank, world, group, dims, variables, batches, loss,
                   micro_batches, sync_bn=False, remat=False):
    """Steps of the float64 port trainer from the JAX ``variables``:
    ``make_grad_cache_step`` at ``micro_batches`` (``make_train_step`` at
    1) with the loss named (MIL-NCE on the chunked plain stream, chunk
    3), the finite guard, warmup 2 over 10 steps; this rank's rows of
    each global (video, text, start) batch.  Every ``all_reduce_flat``
    call the step makes is counted.  Returns the losses, the skips, the
    final state, Adam's moments and each step's all-reduce calls (the
    element count of each)."""
    model = load_jax_variables(S3D(**dims).to(torch.float64), variables)
    model.remat = remat
    if sync_bn:
        sync_batchnorm(model, group)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    cfg = LossConfig(name=loss, milnce_impl="chunked", milnce_chunk=3,
                     milnce_backend="scan", sdtw_backend="scan")
    kwargs = dict(finite_guard=True, lr_scheduler=sched, group=group)
    step = (make_grad_cache_step(model, optimizer, micro_batches, cfg,
                                 **kwargs)
            if micro_batches > 1 else
            make_train_step(model, optimizer, cfg, **kwargs))
    calls = []
    real = step_module.all_reduce_flat

    def counted(tensors, *args, **kw):
        calls[-1].append(sum(t.numel() for t in tensors))
        return real(tensors, *args, **kw)

    step_module.all_reduce_flat = counted
    losses, skips = [], []
    try:
        for video, text, start in batches:
            if group is not None:
                video, text, start = (_shard(x, rank, world)
                                      for x in (video, text, start))
            calls.append([])
            loss_, skipped = step(torch.from_numpy(video),
                                  torch.from_numpy(text),
                                  torch.from_numpy(start))
            losses.append(float(loss_))
            skips.append(int(skipped))
    finally:
        step_module.all_reduce_flat = real
    return losses, skips, _state(model), moments(model, optimizer), calls


def grad_cache_runs(rank, world, group, dims, variables, batches, cases):
    """:func:`grad_cache_run` for each ``{label: (loss, micro_batches,
    sync_bn, remat)}`` of ``cases`` in turn, in one group; returns
    ``{label: result}``."""
    return {label: grad_cache_run(rank, world, group, dims, variables,
                                  batches, *case)
            for label, case in cases.items()}


# ------------------------------------------------------------ trainer ranks
def train_runs(rank, world, _group, runs):
    """``run_training`` for each (label, cfg) of ``runs`` in turn, every
    run joining its own group through ``parallel.coordinator_address``
    (already set in ``cfg``) at this rank.  Returns per run: the
    {step: loss} the run reported, the lines its ``log`` got, its
    ``TrainResult`` fields and its final state."""
    from milnce_tpu_torch.train.loop import run_training

    out = {}
    for label, cfg in runs:
        cfg.parallel.process_id = rank
        losses, lines = {}, []
        res = run_training(cfg, log=lines.append,
                           on_step=lambda s, _t, loss, _w:
                           losses.__setitem__(s, loss))
        out[label] = dict(losses=losses, lines=lines, steps=res.steps,
                          rank=res.rank, state=_state(res.model),
                          drained=res.drained, stage=res.stage)
    return out


def rank_fault_runs(rank, world, group, runs):
    """:func:`train_runs` for each (label, cfg, {rank: spec}) of ``runs``,
    each rank arming the ``train.faults`` spec given for it ('' for a
    rank not named)."""
    out = {}
    for label, cfg, specs in runs:
        cfg.train.faults = specs.get(rank, "")
        out.update(train_runs(rank, world, group, [(label, cfg)]))
    return out


# ------------------------------------------------------------ 2-D layout ranks
def _grid(model_size, group):
    from milnce_tpu_torch.config import ParallelConfig
    from milnce_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(ParallelConfig(model_axis="model",
                                     model_parallel_size=model_size), group)


def _census(placement, events):
    """Record into ``events``, while the returned context is open, each
    backward's start and end (``("backward",)``, ``("backward_end",)``),
    each leaf the placement issues (``("issue", name)``) and each
    all-reduce or reduce-scatter, tagged ``"reduction"`` when the
    placement's reduction issued it (inside its issue of a leaf or its
    ``reduce_grads_2d``), else ``"other"`` (sync BatchNorm, the loss, the
    guard's flag)."""
    names = {id(p): n for n, p in placement.model.named_parameters()}
    depth = [0]
    real = (torch.autograd.backward, dist.all_reduce,
            dist.reduce_scatter_tensor, placement._issue,
            placement.reduce_grads_2d)

    def tag():
        return "reduction" if depth[0] else "other"

    def backward(*args, **kw):
        events.append(("backward",))
        out = real[0](*args, **kw)
        events.append(("backward_end",))
        return out

    def all_reduce(*args, **kw):
        events.append(("all_reduce", tag()))
        return real[1](*args, **kw)

    def reduce_scatter(*args, **kw):
        events.append(("reduce_scatter", tag()))
        return real[2](*args, **kw)

    def inside(fn):
        def run(*args):
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return run

    def issue(i):
        events.append(("issue", names[id(placement._order[i])]))
        return inside(real[3])(i)

    @contextlib.contextmanager
    def recording():
        torch.autograd.backward, dist.all_reduce = backward, all_reduce
        dist.reduce_scatter_tensor = reduce_scatter
        placement._queue.issue = issue
        placement.reduce_grads_2d = inside(real[4])
        try:
            yield
        finally:
            torch.autograd.backward, dist.all_reduce = real[:2]
            dist.reduce_scatter_tensor = real[2]
            placement._queue.issue = real[3]
            del placement.reduce_grads_2d

    return recording()


def layout_run(rank, world, group, dims, variables, batches, loss,
               model_size, micro_batches=1, min_size=256, nan_at=None,
               overlap=True, census=False):
    """Steps of the float64 port trainer from the JAX ``variables`` with
    sync BatchNorm over the whole group (so every layout computes the
    one-process step), warmup 2 over 10 steps, the finite guard; the 1-D
    layout (``model_size`` 0) or the (world / model_size, model_size)
    grid at the FSDP threshold ``min_size``, its gradients reduced a leaf
    at a time during the backward (``overlap``) or fused after it;
    MIL-NCE dense or sdtw_3 on the scan; ``make_grad_cache_step`` at
    ``micro_batches`` > 1.  ``nan_at`` (step index): rank 0 plants a NaN
    in the last element of the first sharded parameter's full gradient
    as it reaches the parameter (a tensor hook, before the reduction),
    which lands in the last model column's slice alone.  ``census``: the
    last step's events (:func:`_census`).  Returns the losses, the skips,
    the full state and moments after the steps, the bytes of the sharded
    parameters plus their optimizer state on this rank, the map's
    summary and hash, and the census."""
    import hashlib

    from milnce_tpu_torch.parallel.sharding_map import ShardedPlacement
    from milnce_tpu_torch.train.state import local_state_bytes

    model = load_jax_variables(S3D(**dims).to(torch.float64), variables)
    if group is not None:
        sync_batchnorm(model, group)
    placement = None
    if model_size:
        placement = ShardedPlacement(model, _grid(model_size, group), group,
                                     min_size=min_size, overlap=overlap)
    opt_cfg = OptimConfig(warmup_steps=2)
    optimizer, sched = build_optimizer(model, opt_cfg,
                                       build_schedule(opt_cfg, 10))
    cfg = LossConfig(name=loss, milnce_impl="dense", sdtw_backend="scan")
    kwargs = dict(finite_guard=True, lr_scheduler=sched, group=group,
                  placement=placement)
    step = (make_grad_cache_step(model, optimizer, micro_batches, cfg,
                                 **kwargs)
            if micro_batches > 1 else
            make_train_step(model, optimizer, cfg, **kwargs))
    losses, skips, events = [], [], []
    for i, (video, text, start) in enumerate(batches):
        if group is not None:
            video, text, start = (_shard(x, rank, world)
                                  for x in (video, text, start))
        hook = None
        if placement is not None and nan_at == i and rank == 0:
            def planted(g):
                g = g.clone()
                g.view(-1)[-1] = float("nan")
                return g

            hook = placement.sharded[0][0].register_hook(planted)
        recording = (_census(placement, events)
                     if census and i == len(batches) - 1 else
                     contextlib.nullcontext())
        with recording:
            loss_, skipped = step(torch.from_numpy(video),
                                  torch.from_numpy(text),
                                  torch.from_numpy(start))
        if hook is not None:
            hook.remove()
        losses.append(float(loss_))
        skips.append(int(skipped))
    if placement is not None:
        model_sd, opt_sd = placement.full_state(model, optimizer)
        sharded = [p for p, _ in placement.sharded]
        summary, digest = placement.summary, placement.hash
    else:
        model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
        summary = digest = None
        from milnce_tpu_torch.parallel.sharding_map import build_param_map

        names = {e.name for e in build_param_map(model, 2, min_size)
                 if e.torch_dim is not None}
        sharded = [p for n, p in model.named_parameters() if n in names]
    state = {k: v.detach().clone().numpy() for k, v in model_sd.items()}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    moments_ = {names[i]: (st["exp_avg"].numpy().copy(),
                           st["exp_avg_sq"].numpy().copy())
                for i, st in opt_sd["state"].items()}
    blob = hashlib.sha256()
    for key in sorted(state):
        blob.update(key.encode() + state[key].tobytes())
    out = dict(losses=losses, skips=skips, state_digest=blob.hexdigest(),
               sharded_bytes=local_state_bytes(model, optimizer, sharded),
               summary=summary, hash=digest, census=events)
    if rank == 0:       # the others' states are held equal by their digest
        out.update(state=state, moments=moments_)
    return out


def layout_runs(rank, world, group, dims, variables, batches, cases):
    """:func:`layout_run` for each ``{label: kwargs}`` of ``cases`` in
    turn, in one group; returns ``{label: result}``."""
    return {label: layout_run(rank, world, group, dims, variables, batches,
                              **case)
            for label, case in cases.items()}


def train_runs_2d(rank, world, group, runs):
    """:func:`train_runs`, plus for each run the shapes of the final
    model's parameters as this rank holds them and the map's hash."""
    from milnce_tpu_torch.train.loop import run_training

    out = {}
    for label, cfg in runs:
        cfg.parallel.process_id = rank
        losses, lines = {}, []
        res = run_training(cfg, log=lines.append,
                           on_step=lambda s, _t, loss, _w:
                           losses.__setitem__(s, loss))
        out[label] = dict(
            losses=losses, lines=lines, steps=res.steps,
            shapes={n: tuple(p.shape) for n, p in res.model.named_parameters()},
            hash=res.placement.hash if res.placement else None)
    return out


# ------------------------------------------------ sequence-parallel soft-DTW
def softdtw_sp_cases(rank, world, group, cases):
    """``softdtw_seq_parallel`` over the group for each ``{label: (D,
    gamma, bandwidth, g)}``: the values and the gradient of ``sum(g *
    value)`` with respect to D, on this rank; and under ``("rows",
    label)`` the same through ``softdtw_seq_parallel_rows`` on this
    rank's rows alone (k = ceil(N / W), the last rank's padding NaN,
    which must not reach the values): the values, the gradient of the
    rank's rows and the shape of every tensor saved for the backward."""
    from milnce_tpu_torch.ops import (softdtw_seq_parallel,
                                      softdtw_seq_parallel_rows)

    out = {}
    for label, (D, gamma, band, g) in cases.items():
        x = torch.from_numpy(D).requires_grad_()
        value = softdtw_seq_parallel(x, gamma, group, band)
        (value * torch.from_numpy(g)).sum().backward()
        out[label] = (value.detach().numpy(), x.grad.numpy())

        b, n, m = D.shape
        k = -(-n // world)
        own = np.full((b, k, m), np.nan, np.float32)
        block = D[:, rank * k:(rank + 1) * k]
        own[:, :block.shape[1]] = block
        rows = torch.from_numpy(own).requires_grad_()
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            value = softdtw_seq_parallel_rows(rows, n, gamma, group, band)
        (value * torch.from_numpy(g)).sum().backward()
        out[("rows", label)] = (value.detach().numpy(), rows.grad.numpy(),
                                saved)
    return out


# ------------------------------------------------------------ sharded index
def index_topk_cases(rank, world, group, emb, queries, k, buckets):
    """``serving/index.py::DeviceRetrievalIndex`` over the group (each
    rank keeping its row shard) on the full corpus ``emb``: the top-k
    scores and rows of ``queries``, and the rank's valid rows."""
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex

    index = DeviceRetrievalIndex(emb, k=k, query_buckets=buckets,
                                 device="cpu", group=group)
    scores, idx = index.topk(queries)
    (corpus, valid, _), = index._shards          # the rank's one shard
    return dict(scores=scores, idx=idx, valid=int(valid[0]),
                rows=int(corpus.shape[0]),
                recompiles=index.recompiles())


# ------------------------------------------------------------- live index
def live_index_group_cases(rank, world, group, full, chunks, queries, k):
    """``serving/live_index.py::LiveRetrievalIndex`` over the group: boot
    on ``full``'s first chunk, ingest the next chunks one generation at a
    time (every rank the same rows); per generation the ranking, the
    generation and the shard's rung."""
    from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex

    index = LiveRetrievalIndex(full[:chunks[0]], k=k, query_buckets=(8,),
                               device="cpu", group=group)
    out, size = [], chunks[0]
    try:
        for n in [0] + list(chunks[1:]):
            if n:
                index.add(full[size:size + n])
                assert index.flush(30.0)
                size += n
            _, idx, gen = index.topk_with_gen(queries)
            out.append((idx, gen, index.stats()["shard_rows"]))
    finally:
        index.close()
    return out


# ------------------------------------------------------------ serving grid
def serving_grid_cases(rank, world, group, dims, variables, engine_kw,
                       ladders, engine_rows, index_cases, live, lockstep_live):
    """Serving over the grid of this rank's ``["cpu", "cpu"]`` and the
    group (W x 2 shards), the model of ``ModelConfig(**dims)``:

    - ``ladders`` [(min_bucket, max_batch)]: each engine's ladder;
    - ``engine_rows`` {n: (token ids, clips)}: both entries of an engine
      from the JAX ``variables`` (``engine_kw``);
    - ``index_cases`` [(emb, queries, k)]: ``DeviceRetrievalIndex``'s
      top-k and this rank's shard rows and valid rows;
    - ``live`` (full, chunks, queries, k): a ``LiveRetrievalIndex`` fed
      the same chunks on every rank, each flushed before a query: per
      generation the ranking, the generation and the rung;
    - ``lockstep_live`` (full, chunks, queries, k, timeout): the same
      under ``serving/lockstep.py``, rank 0 ingesting alone and the
      other ranks replaying: rank 0's ranking and generation per chunk,
      every rank's last generation, rung and replayed calls;

    and a grid of unequal device groups (rank 0 two devices, the others
    one): its refusal."""
    from milnce_tpu_torch.config import ModelConfig
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.parallel.devices import serving_grid
    from milnce_tpu_torch.serving import lockstep
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex

    devices = ["cpu", "cpu"]
    out = {"ladders": [InferenceEngine(
        build_model(ModelConfig(**dims)), device=devices, process_group=group,
        precompile=False, **dict(engine_kw, min_bucket=mb, max_batch=top)
    ).buckets for mb, top in ladders]}
    engine = InferenceEngine(build_model(ModelConfig(**dims)), variables,
                             device=devices, process_group=group,
                             **engine_kw)
    out["engine"] = {n: (engine.embed_text(ids), engine.embed_video(clips))
                     for n, (ids, clips) in engine_rows.items()}
    out["index"] = []
    for emb, queries, k in index_cases:
        index = DeviceRetrievalIndex(emb, k=k, query_buckets=(8,),
                                     device=devices, group=group)
        scores, idx = index.topk(queries)
        out["index"].append(dict(
            scores=scores, idx=idx, shards=index.grid.shards,
            rows=[int(c.shape[0]) for c, _, _ in index._shards],
            valid=[int(v[0]) for _, v, _ in index._shards],
            recompiles=index.recompiles()))
    full, chunks, queries, k = live
    index = LiveRetrievalIndex(full[:chunks[0]], k=k, query_buckets=(8,),
                               device=devices, group=group)
    out["live"], size = [], chunks[0]
    try:
        for n in [0] + list(chunks[1:]):
            if n:
                index.add(full[size:size + n])
                assert index.flush(30.0)
                size += n
            _, idx, gen = index.topk_with_gen(queries)
            out["live"].append((idx, gen, index.stats()["shard_rows"]))
    finally:
        index.close()
    full, chunks, queries, k, timeout = lockstep_live
    index = LiveRetrievalIndex(full[:chunks[0]], k=k, query_buckets=(8,),
                               device=devices, group=group)
    try:
        if rank == 0:
            leader = lockstep.Leader(group, timeout)
            index.announce = leader.announce
            answers, size = [], chunks[0]
            for n in [0] + list(chunks[1:]):
                if n:
                    index.add(full[size:size + n])
                    assert index.flush(30.0)
                    size += n
                _, idx, gen = index.topk_with_gen(queries)
                answers.append((idx, gen))
            closed = leader.close()
            out["lockstep"] = dict(answers=answers, closed=closed,
                                   sent=leader.sent)
        else:
            out["lockstep"] = dict(replayed=lockstep.follow(
                group, timeout, None, index))
        st = index.stats()
        out["lockstep"].update(generation=st["generation"],
                               shard_rows=st["shard_rows"])
    finally:
        index.close()
    try:
        serving_grid(devices[:1] if rank else devices, group)
    except ValueError as exc:
        out["unequal"] = str(exc)
    return out


def live_index_hammer() -> int:
    """16 threads — 12 querying, 4 ingesting — against one live index
    under ``MILNCE_LOCK_SANITIZE=1`` (set by the caller before this
    process starts).  Pins: the final size is boot + every added row;
    every ranking equals the exact ranking over SOME published corpus
    prefix (a torn generation matches none), and one generation never
    answers for two sizes; >= 3 swaps; 0 recompiles; the builder
    survived.  Both serving locks on the path (the state lock and the
    dispatch lock) are sanitized, and the sanitizer records no order
    edge: neither is ever taken while the other is held (the JAX index
    nests obs locks that are not sanitized in the port, so its hammer
    sees edges).  Prints ``HAMMER_OK ...``."""
    import sys
    import threading

    from milnce_tpu_torch.analysis import lockrt
    from milnce_tpu_torch.serving.engine import DEVICE_DISPATCH_LOCK
    from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex

    assert lockrt.sanitizing_enabled(), "export MILNCE_LOCK_SANITIZE=1"
    torch.set_num_threads(1)
    dim, boot_n, k = 16, 12, 5
    n_query, n_ingest, per_query, per_add, rows_per_add = 12, 4, 8, 3, 4
    rng = np.random.default_rng(0)
    boot = rng.standard_normal((boot_n, dim)).astype(np.float32)
    index = LiveRetrievalIndex(boot, k=k, query_buckets=(8,), device="cpu")
    assert isinstance(index._state_lock, lockrt.SanitizedLock)
    assert isinstance(DEVICE_DISPATCH_LOCK, lockrt.SanitizedLock)
    total_adds = n_ingest * per_add
    pool = rng.standard_normal((total_adds * rows_per_add,
                                dim)).astype(np.float32)
    add_lock = threading.Lock()
    appended, errors, observed = [], [], []
    obs_lock = threading.Lock()

    def ingester(tid):
        try:
            for j in range(per_add):
                base = (tid * per_add + j) * rows_per_add
                rows = pool[base:base + rows_per_add]
                with add_lock:          # serialize add + order record
                    index.add(rows)
                    appended.append(rows)
                assert index.flush(60.0), "mid-hammer flush timed out"
        except Exception as exc:  # noqa: BLE001 - the child reports
            errors.append(f"ingest {tid}: {type(exc).__name__}: {exc}")

    def querier(tid):
        try:
            qrng = np.random.default_rng(1000 + tid)
            for _ in range(per_query):
                q = qrng.standard_normal((2, dim)).astype(np.float32)
                scores, idx, gen = index.topk_with_gen(q)
                assert scores.shape == (2, k) and idx.shape == (2, k)
                with obs_lock:
                    observed.append((gen, q, idx.copy()))
        except Exception as exc:  # noqa: BLE001 - the child reports
            errors.append(f"query {tid}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=ingester, args=(t,))
               for t in range(n_ingest)]
    threads += [threading.Thread(target=querier, args=(t,))
                for t in range(n_query)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    try:
        if errors:
            raise AssertionError("\n".join(errors))
        assert index.flush(30.0), "final flush timed out"
        st = index.stats()
        expect = boot_n + total_adds * rows_per_add
        assert st["size"] == expect and \
            st["ingested_rows"] == expect - boot_n, st
        assert st["swaps"] >= 3, st
        assert index.recompiles() == 0 and st["builder_alive"], st
        full = np.concatenate([boot] + appended)
        sizes = [boot_n + sum(a.shape[0] for a in appended[:m])
                 for m in range(len(appended) + 1)]
        gen_sets: dict = {}
        for gen, q, idx in observed:
            matches = {size for size in sizes if np.array_equal(
                idx, np.argsort(-(q @ full[:size].T), axis=1)[:, :k])}
            assert matches, f"TORN GENERATION {gen}"
            gen_sets[gen] = gen_sets.get(gen, matches) & matches
            assert gen_sets[gen], f"generation {gen} answered two sizes"
        edges = lockrt.GLOBAL_GRAPH.snapshot()["edges"]
        assert not edges, f"nested serving locks: {edges}"
    except AssertionError as exc:
        print(f"hammer failed: {exc}", file=sys.stderr)
        return 1
    finally:
        index.close()
    print(f"HAMMER_OK threads={len(threads)} queries={len(observed)} "
          f"swaps={st['swaps']} size={st['size']} edges={len(edges)}")
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit({"live_index_hammer": live_index_hammer}[sys.argv[1]]())


# ------------------------------------------------------------ eval ranks
class SeededEvalSource:
    """An eval source of ``n`` samples made from their index alone (the
    same in every process, unlike ``FakeDecoder``'s ``hash`` of a path):
    ``windows`` uint8 clips of ``frames`` x ``size``^2, a caption of
    ``words`` ids under ``vocab``, a class label and three split flags (1
    train, 2 test).  ``decoded`` lists the indices it was asked for."""

    def __init__(self, n, windows=2, frames=4, size=32, words=5, vocab=64):
        self.n, self.windows, self.frames = n, windows, frames
        self.size, self.words, self.vocab = size, words, vocab
        self.decoded = []

    def __len__(self):
        return self.n

    def sample(self, idx, rng=None):
        self.decoded.append(idx)
        gen = np.random.default_rng(1000 + idx)
        return {"video": gen.integers(0, 255, (self.windows, self.frames,
                                               self.size, self.size, 3),
                                      dtype=np.uint8),
                "text": gen.integers(1, self.vocab, (1, self.words)
                                     ).astype(np.int32),
                "label": f"class{idx % 3}",
                "splits": np.array([1 if (idx + s) % 3 else 2
                                    for s in range(3)], np.int32)}


def eval_group_runs(rank, world, group, dims, variables, n, batch,
                    devices):
    """Retrieval and the linear probe of a float32 port model from the JAX
    ``variables`` over this rank's ``devices`` and the ``group``, on a
    :class:`SeededEvalSource` of ``n`` samples at retrieval batch
    ``batch``.  Returns the embeddings, features, labels, splits, the
    metrics (the probe's SVM seeded by ``np.random.seed(0)``) and the
    indices each extraction decoded."""
    from milnce_tpu_torch.eval.linear_probe import (evaluate_linear_probe,
                                                    extract_probe_features)
    from milnce_tpu_torch.eval.metrics import compute_retrieval_metrics
    from milnce_tpu_torch.eval.retrieval import extract_retrieval_embeddings

    model = load_jax_variables(S3D(**dims), variables)
    src = SeededEvalSource(n, vocab=dims["vocab_size"])
    t, v = extract_retrieval_embeddings(model, src, devices, batch,
                                        process_group=group)
    decoded_retrieval = sorted(set(src.decoded))
    src.decoded.clear()
    feats, labels, splits = extract_probe_features(model, src, devices,
                                                   process_group=group)
    decoded_probe = sorted(set(src.decoded))
    np.random.seed(0)
    accs = evaluate_linear_probe(model, src, devices, process_group=group)
    return dict(t=t, v=v, metrics=compute_retrieval_metrics(t @ v.T),
                feats=feats, labels=list(labels), splits=splits, accs=accs,
                decoded_retrieval=decoded_retrieval,
                decoded_probe=decoded_probe)


def eval_train_runs(rank, world, _group, cfg):
    """``run_training`` of ``cfg`` (its group through
    ``parallel.coordinator_address``) at this rank, recording each
    barrier the process meets and whether the in-training eval was
    running then, and the indices the eval source decoded; then, in this
    process alone, the eval of the run's initial model (the seed's) with
    no group.  Returns the run's eval metrics, its log lines, the
    barriers, the decoded indices and the one-process metrics."""
    from milnce_tpu_torch.data import datasets
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.train import loop

    barriers, decoded, inside = [], [], [False]
    real_barrier, real_eval = dist.barrier, loop._in_training_eval
    real_sample = datasets.MSRVTTSource.sample

    def barrier(*args, **kw):
        barriers.append(inside[0])
        return real_barrier(*args, **kw)

    def evaluate(*args, **kw):
        inside[0] = True
        try:
            return real_eval(*args, **kw)
        finally:
            inside[0] = False

    def sample(self, idx, rng=None):
        decoded.append(idx)
        return real_sample(self, idx, rng)

    cfg.parallel.process_id = rank
    lines = []
    dist.barrier, loop._in_training_eval = barrier, evaluate
    datasets.MSRVTTSource.sample = sample
    try:
        res = loop.run_training(cfg, log=lines.append)
    finally:
        dist.barrier, loop._in_training_eval = real_barrier, real_eval
        datasets.MSRVTTSource.sample = real_sample
    model = build_model(cfg.model, seed=cfg.train.seed)
    alone = loop._in_training_eval(cfg, model, torch.device("cpu"),
                                   lambda _m: None)
    return dict(metrics=res.eval_metrics, lines=lines, barriers=barriers,
                decoded=sorted(set(decoded)), alone=alone)
