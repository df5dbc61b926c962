"""graftlint Pass 2 for the PyTorch port: invariants of the registered
entries' op traces (``analysis/optrace.py``).

Each entry builds a tiny model (the sizes of :data:`TINY`), runs its call
once to warm, traces the next same-shaped call (the steady state) and
reduces the trace to an :class:`EntryRun`: plain data, so the entries of
a gloo group (``@W2``, the ``2d`` grid) run in two spawned ranks and hand
theirs back.  The checks:

- **no-f64** — no op reads or writes float64;
- **collectives** — the per-call multiset of c10d collectives equals
  ``EXPECTED_COLLECTIVES`` (the guarded step's equals the plain step's on
  one process and at W = 2, and has one flag all-reduce more on the 2-D
  grid).  The 2-D entries reduce a leaf at a time (the default
  ``parallel.overlap_grad_reduce``): an all-reduce a replicated leaf with
  a gradient and a reduce-scatter a sharded one; their ``_fused`` twins
  reduce the replicated leaves in one flat all-reduce, the grad-cache
  step's census equal to the plain step's in both forms;
- **scan-reduction-free** — in the grad-cache step the gradients are
  all-reduced once per optimizer step, never once per microbatch;
- **no-host-sync** — a training entry's steady-state step makes no
  ``_local_scalar_dense`` and no device-to-host copy (the port's
  transfer guard);
- **kernels** — the hand kernels' launches per call, by name, equal
  ``EXPECTED_LAUNCHES``.  The CPU runs the plain twins, so an entry on
  the kernel path is also planned on ``meta`` with the kernels' backend
  (``memplan.build_meta_step``), where every wrapper notes its launch;
- **recompile** — a third same-shaped call builds or loads no kernel
  library (``cuda_build._LIBS``), asks the card for no new cluster count
  (``milnce_stream._CLUSTERS``) and, in serving, leaves ``recompiles()``
  at 0;
- **state-dict** — the port's ``state_dict`` keys map onto the Flax
  param tree through ``utils/torch_convert.py`` and back with no key
  left over but ``num_batches_tracked``.

Each :class:`EntryRun` also carries its memory plan (``memplan``) and its
numerics audit (``numerics``), so Passes 4 and 5 read the same trace.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch

from milnce_tpu_torch.analysis import memplan, numerics
from milnce_tpu_torch.analysis.optrace import OpTrace, dtype_name, trace_call
from milnce_tpu_torch.ops import cuda_build
from milnce_tpu_torch.ops import milnce_stream as ms

TINY = dict(embedding_dim=16, vocab_size=64, word_embedding_dim=8,
            text_hidden_dim=16, inception_blocks=1)
B, FRAMES, SIZE, WORDS, K = 4, 4, 32, 6, 2
GROUP_WORLD = 2

# Measured per call on the CPU (and, for the kernels, on meta) at the
# tiny sizes.  Re-pin from a failing check's message.
EXPECTED_COLLECTIVES = {
    'train_step_milnce': {},
    'train_step_milnce_guarded': {},
    'train_step_milnce_instrumented': {},
    'train_step_curriculum': {},
    'train_step_milnce_chunked': {},
    'train_step_sdtw3': {},
    'grad_cache_step_milnce': {},
    'retrieval_embed': {},
    'softdtw': {},
    'serve_embed_ladder': {},
    'serve_pool_embed': {},
    'serve_quant_embed_ladder': {},
    'serve_index_topk': {},
    'serve_live_index': {},
    'train_step_milnce@W2': {'allgather_': 2, 'allreduce_': 5},
    'train_step_milnce_guarded@W2': {'allgather_': 2, 'allreduce_': 5},
    'grad_cache_step_milnce@W2': {'allgather_': 2, 'allreduce_': 5},
    'train_step_milnce_2d': {'allgather_': 22, 'allreduce_': 37, '_reduce_scatter_base_': 19},
    'train_step_milnce_2d_guarded': {'allgather_': 22, 'allreduce_': 38, '_reduce_scatter_base_': 19},
    'grad_cache_2d': {'allgather_': 22, 'allreduce_': 38, '_reduce_scatter_base_': 19},
    'train_step_milnce_2d_fused': {'allgather_': 22, 'allreduce_': 5, '_reduce_scatter_base_': 19},
    'train_step_milnce_2d_guarded_fused': {'allgather_': 22, 'allreduce_': 6, '_reduce_scatter_base_': 19},
    'grad_cache_2d_fused': {'allgather_': 22, 'allreduce_': 6, '_reduce_scatter_base_': 19},
}
EXPECTED_LAUNCHES = {
    'train_step_milnce': {},
    'train_step_milnce_guarded': {},
    'train_step_milnce_instrumented': {},
    'train_step_curriculum': {},
    'train_step_milnce_chunked': {'lse_fwd': 2, 'lse_bwd_rows': 2, 'lse_bwd_cols': 2},
    'train_step_sdtw3': {'softdtw_fwd': 6, 'softdtw_bwd': 6},
    'grad_cache_step_milnce': {},
    'retrieval_embed': {},
    'softdtw': {'softdtw_fwd': 1, 'softdtw_bwd': 1},
    'serve_embed_ladder': {},
    'serve_pool_embed': {},
    'serve_quant_embed_ladder': {},
    'serve_index_topk': {},
    'serve_live_index': {},
    'train_step_milnce@W2': {},
    'train_step_milnce_guarded@W2': {},
    'grad_cache_step_milnce@W2': {},
    'train_step_milnce_2d': {},
    'train_step_milnce_2d_guarded': {},
    'grad_cache_2d': {},
    'train_step_milnce_2d_fused': {},
    'train_step_milnce_2d_guarded_fused': {},
    'grad_cache_2d_fused': {},
}


@dataclasses.dataclass
class CheckResult:
    entry: str
    check: str
    ok: bool
    detail: str = ""

    def format(self) -> str:
        mark = "ok" if self.ok else "FAIL"
        tail = f" — {self.detail}" if self.detail else ""
        return f"[{mark}] {self.entry}/{self.check}{tail}"


@dataclasses.dataclass
class EntryRun:
    """What the passes read of one entry's traced call."""
    name: str
    train: bool
    ops: int = 0
    op_names: dict = dataclasses.field(default_factory=dict)
    f64: list = dataclasses.field(default_factory=list)
    collectives: dict = dataclasses.field(default_factory=dict)
    syncs: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    grad_reductions: int | None = None
    plan: memplan.MemPlan | None = None
    audit: dict | None = None
    results: list = dataclasses.field(default_factory=list)


def summarize(name: str, trace: OpTrace, train: bool,
              launches: dict | None = None, grad_numel: int = 0
              ) -> EntryRun:
    """Reduce a trace to an :class:`EntryRun`; ``grad_numel``: the
    gradients' element count, whose all-reduces are the step's gradient
    reductions (the scan-reduction-free check)."""
    f64 = sorted({f"{op.name} @ {op.owner}" for op in trace.ops
                  if any(dtype_name(d) == "f64" for d, _ in op.inputs
                         + op.outputs)})
    names: dict = {}
    for op in trace.ops:
        names[op.name] = names.get(op.name, 0) + 1
    reductions = None
    if grad_numel:
        reductions = sum(1 for op in trace.events("collective")
                         if op.name == "c10d.allreduce_" and op.inputs
                         and int(np.prod(op.inputs[0][1])) == grad_numel)
    return EntryRun(name, train, len(trace.ops), names, f64,
                    trace.collectives(),
                    [f"{op.name} @ {op.owner}" for op in trace.syncs()],
                    trace.kernels() if launches is None else launches,
                    reductions, memplan.plan_trace(trace, name, train),
                    numerics.audit(trace))


def check_entry(run: EntryRun) -> list[CheckResult]:
    """The Pass 2 checks of one entry."""
    out = [CheckResult(run.name, "no-f64", not run.f64,
                       "" if not run.f64 else f"float64 at {run.f64[:5]}")]
    want = EXPECTED_COLLECTIVES.get(run.name)
    out.append(CheckResult(
        run.name, "collectives", want == run.collectives,
        "" if want == run.collectives else
        f"collectives {run.collectives} != pinned {want}"))
    want = EXPECTED_LAUNCHES.get(run.name)
    out.append(CheckResult(
        run.name, "kernels", want == run.launches,
        "" if want == run.launches else
        f"kernel launches {run.launches} != pinned {want}"))
    if run.train:
        out.append(CheckResult(
            run.name, "no-host-sync", not run.syncs,
            "" if not run.syncs else
            f"{len(run.syncs)} host syncs in the steady-state step: "
            f"{run.syncs[:5]}"))
    if run.grad_reductions is not None:
        out.append(CheckResult(
            run.name, "scan-reduction-free", run.grad_reductions == 1,
            f"{run.grad_reductions} gradient all-reduces a step"
            if run.grad_reductions != 1 else ""))
    return out + list(run.results)


# ------------------------------------------------------------ the entries
def tiny_config(loss: str = "milnce", **loss_kw):
    from milnce_tpu_torch.config import ModelConfig, tiny_preset

    cfg = tiny_preset()
    cfg.model = ModelConfig(**TINY)
    cfg.data.num_frames, cfg.data.video_size = FRAMES, SIZE
    cfg.data.max_words, cfg.data.num_candidates = WORDS, K
    cfg.loss.name = loss
    for key, value in loss_kw.items():
        setattr(cfg.loss, key, value)
    return cfg


def tiny_inputs(seed: int, batch: int = B, frames: int = FRAMES,
                size: int = SIZE, device="cpu") -> tuple:
    gen = torch.Generator().manual_seed(seed)
    video = torch.randint(0, 256, (batch, frames, size, size, 3),
                          generator=gen, dtype=torch.uint8)
    text = torch.randint(1, TINY["vocab_size"], (batch * K, WORDS),
                         generator=gen, dtype=torch.int32)
    start = torch.rand(batch, generator=gen) * 4
    return tuple(x.to(device) for x in (video, text, start))


def build_train_step(cfg, guard: bool, accum: int = 1, group=None,
                     model_size: int = 0, device="cpu", overlap: bool = True):
    """The tiny model (seed 0), its optimizer and the train step of
    ``cfg``; ``model_size`` > 1 puts it on the (W / m, m) grid of
    ``group``, its gradients reduced a leaf at a time during the backward
    (``overlap``) or fused after it.  -> (model, optimizer, step)."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.train.schedule import build_schedule
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import (make_grad_cache_step,
                                             make_train_step)

    model = build_model(cfg.model, seed=0, group=group).to(device)
    placement = None
    if model_size > 1:
        from milnce_tpu_torch.config import ParallelConfig
        from milnce_tpu_torch.parallel.mesh import build_mesh
        from milnce_tpu_torch.parallel.sharding_map import ShardedPlacement

        grid = build_mesh(ParallelConfig(model_axis="model",
                                         model_parallel_size=model_size),
                          group)
        placement = ShardedPlacement(model, grid, group, min_size=256,
                                     overlap=overlap)
    optimizer, lr = build_optimizer(model, cfg.optim,
                                    build_schedule(cfg.optim, 10))
    kw = dict(finite_guard=guard, lr_scheduler=lr, group=group,
              placement=placement)
    step = (make_grad_cache_step(model, optimizer, accum, cfg.loss, **kw)
            if accum > 1 else make_train_step(model, optimizer, cfg.loss,
                                              **kw))
    return model, optimizer, step


def _caches() -> tuple:
    return frozenset(cuda_build._LIBS), frozenset(ms._CLUSTERS.items())


def _recompile(name: str, before: tuple) -> CheckResult:
    after = _caches()
    return CheckResult(name, "recompile", after == before,
                       "" if after == before else
                       "a same-shaped call built or loaded a kernel library "
                       "or asked the card for a new plan")


def meta_launches(cfg, guard: bool, accum: int = 1, batch: int = B,
                  frames: int = FRAMES, size: int = SIZE) -> dict:
    """The kernel launches of one steady-state step of ``cfg`` (at
    ``accum`` microbatches) planned on meta."""
    cfg.train.grad_accum = accum
    model, optimizer, step = memplan.build_meta_step(cfg, guard)
    inputs = memplan.step_inputs(batch, frames, size, K, WORDS)
    _, trace = memplan.plan_step(model, optimizer, step, inputs, "meta")
    return trace.kernels()


def _kernel_cfg(cfg):
    """A copy of ``cfg`` with the losses on their kernels' backends."""
    import copy

    cfg = copy.deepcopy(cfg)
    if cfg.loss.name == "milnce" and cfg.loss.milnce_impl == "chunked":
        cfg.loss.milnce_backend = "cuda"
    if cfg.loss.name != "milnce":
        cfg.loss.sdtw_backend = "cuda"
    return cfg


def train_entry(name: str, cfg, guard: bool = False, accum: int = 1,
                group=None, model_size: int = 0, wrap=None,
                kernels: bool = False, shapes=None,
                overlap: bool = True) -> EntryRun:
    """Warm, trace and re-run one train step.  ``wrap(step)`` wraps the
    traced call (the instrumented entry); ``kernels``: also plan it on
    meta on the kernel path for its launches; ``shapes``: a list of
    (batch, frames, size) stages run in order, the last traced;
    ``overlap``: the 2-D grid's reduction form."""
    torch.manual_seed(0)
    model, optimizer, step = build_train_step(cfg, guard, accum, group,
                                              model_size, overlap=overlap)
    call = wrap(step) if wrap is not None else step
    world = 1 if group is None else torch.distributed.get_world_size(group)
    stages = shapes or [(B // world, FRAMES, SIZE)]
    for i, (b, f, s) in enumerate(stages):
        call(*tiny_inputs(10 + i, b, f, s))
    b, f, s = stages[-1]
    before = _caches()
    trace, _ = trace_call(call, tiny_inputs(1, b, f, s), model=model,
                          optimizer=optimizer)
    call(*tiny_inputs(2, b, f, s))
    numel = (sum(p.numel() for g in optimizer.param_groups
                 for p in g["params"])
             if group is not None and model_size <= 1 else 0)
    launches = (meta_launches(_kernel_cfg(cfg), guard, accum, b, f, s)
                if kernels else None)
    run = summarize(name, trace, True, launches, numel)
    run.results.append(_recompile(name, before))
    return run


def _instrumented(step):
    """The step inside the loop's per-step span, with a recorder."""
    from milnce_tpu_torch.obs.spans import SpanRecorder

    rec = SpanRecorder()

    def call(*args):
        with rec.span("step"):
            return step(*args)

    return call


def _entry_train_step_milnce():
    return train_entry("train_step_milnce", tiny_config())


def _entry_train_step_milnce_guarded():
    return train_entry("train_step_milnce_guarded", tiny_config(), True)


def _entry_train_step_milnce_instrumented():
    run = train_entry("train_step_milnce_instrumented", tiny_config(), True,
                      wrap=_instrumented)
    plain = run_entry("train_step_milnce_guarded")
    same = not isinstance(plain, str) and run.op_names == plain.op_names
    run.results.append(CheckResult(
        run.name, "instrumentation-free", same,
        "" if same else "the span around the step changed its device ops"))
    return run


def _entry_train_step_curriculum():
    """Two stages' shapes through one step, the second traced."""
    return train_entry("train_step_curriculum", tiny_config(), True,
                       shapes=[(B, FRAMES, SIZE), (2, 2 * FRAMES, 40)])


def _entry_train_step_milnce_chunked():
    return train_entry("train_step_milnce_chunked",
                       tiny_config(milnce_impl="chunked", milnce_chunk=3,
                                   milnce_backend="scan"), True,
                       kernels=True)


def _entry_train_step_sdtw3():
    return train_entry("train_step_sdtw3",
                       tiny_config("sdtw_3", sdtw_backend="scan"), True,
                       kernels=True)


def _entry_grad_cache_step_milnce():
    return train_entry("grad_cache_step_milnce", tiny_config(), True,
                       accum=2)


def _entry_retrieval_embed():
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.train.step import (make_text_embed_fn,
                                             make_video_embed_fn)

    model = build_model(tiny_config().model, seed=0)
    video_fn, text_fn = make_video_embed_fn(model), make_text_embed_fn(model)

    def embed(video, text):
        return video_fn(video), text_fn(text)

    embed(*tiny_inputs(0)[:2])
    before = _caches()
    trace, _ = trace_call(embed, tiny_inputs(1)[:2], model=model)
    run = summarize("retrieval_embed", trace, False)
    run.results.append(_recompile(run.name, before))
    return run


def _entry_softdtw():
    """Soft-DTW's value and gradient (``backend='auto'``): the plain
    recurrence on the CPU, the kernels' launches on meta."""
    from milnce_tpu_torch.ops.softdtw import SoftDTW

    sdtw = SoftDTW(gamma=0.1, backend="auto")
    gen = torch.Generator().manual_seed(0)

    def call(x, y):
        x = x.detach().requires_grad_()
        value = sdtw(x, y).sum()
        value.backward()
        return value.detach(), x.grad

    x = torch.randn(3, 5, 8, generator=gen)
    y = torch.randn(3, 4, 8, generator=gen)
    call(x, y)
    before = _caches()
    trace, _ = trace_call(call, (x, y))
    meta = OpTrace()
    with meta:
        call(x.to("meta"), y.to("meta"))
    run = summarize("softdtw", trace, False, meta.kernels())
    run.results.append(_recompile(run.name, before))
    return run


def _entry_state_dict():
    """The port's state_dict keys onto the Flax tree and back."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.utils.torch_convert import (
        flax_to_torch_state_dict, torch_state_dict_to_flax)

    model = build_model(tiny_config().model, seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = flax_to_torch_state_dict(torch_state_dict_to_flax(sd))
    left_port = sorted(set(sd) - set(back))
    left_flax = sorted(set(back) - set(sd))
    ok = (not left_flax and all(k.endswith("num_batches_tracked")
                                for k in left_port))
    run = EntryRun("state_dict", False)
    run.results.append(CheckResult(
        "state_dict", "state-dict", ok,
        "" if ok else f"left over: port {left_port[:5]}, Flax "
        f"{left_flax[:5]}"))
    return run


def _engine(model=None, variables=None):
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.serving.engine import InferenceEngine

    model = model or build_model(tiny_config().model, seed=0)
    return InferenceEngine(model, variables, device="cpu", text_words=WORDS,
                           video_shape=(FRAMES, SIZE, SIZE, 3), max_batch=8)


def _ladder_run(name: str, engine, trace_engine=None) -> EntryRun:
    """Every batch size of the ladder through ``engine`` (an engine or a
    pool), then one traced call of ``trace_engine`` (``engine``); its
    ``recompiles()`` must stay 0."""
    rng = np.random.default_rng(0)
    for n in range(1, engine.max_batch + 1):
        engine.embed_text(rng.integers(1, TINY["vocab_size"], (n, WORDS),
                                       dtype=np.int32))
    clips = rng.integers(0, 256, (3, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    engine.embed_video(clips)
    target = trace_engine or engine
    trace, _ = trace_call(target.embed_video, (clips,),
                          model=getattr(target, "model", None))
    n_re = engine.recompiles()
    run = summarize(name, trace, False)
    run.results.append(CheckResult(
        name, "recompile", n_re == 0,
        "" if n_re == 0 else f"{n_re} new shapes past the warmed ladder"))
    return run


def _entry_serve_embed_ladder():
    return _ladder_run("serve_embed_ladder", _engine())


def _entry_serve_pool_embed():
    """A 2-replica pool; its replicas' workers dispatch on their own
    threads, so the trace is of one replica's engine on this one."""
    from milnce_tpu_torch.obs import metrics as obs_metrics
    from milnce_tpu_torch.serving.pool import ReplicaPool

    engines = [_engine(), _engine()]
    pool = ReplicaPool(engines, registry=obs_metrics.MetricsRegistry())
    try:
        return _ladder_run("serve_pool_embed", pool, engines[0])
    finally:
        pool.close()


def _entry_serve_quant_embed_ladder():
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.quant.quantize import quantize_variables
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    model = build_model(tiny_config().model, seed=0)
    qvars = quantize_variables(torch_state_dict_to_flax(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    return _ladder_run("serve_quant_embed_ladder", _engine(model, qvars))


def _corpus(n: int = 40, dim: int = TINY["embedding_dim"]) -> np.ndarray:
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _entry_serve_index_topk():
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex

    index = DeviceRetrievalIndex(_corpus(), k=5, query_buckets=(8,),
                                 device="cpu")
    q = _corpus(3)
    index.topk(q)
    trace, _ = trace_call(index.topk, (q,))
    n_re = index.recompiles()
    run = summarize("serve_index_topk", trace, False)
    run.results.append(CheckResult(run.name, "recompile", n_re == 0,
                                   "" if n_re == 0 else f"{n_re} new shapes"))
    return run


def _entry_serve_live_index():
    """A query, 24 rows added and flushed into a new generation, the
    query again traced: no new query shape across the swap."""
    from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex

    index = LiveRetrievalIndex(_corpus(), k=5, query_buckets=(8,),
                               device="cpu")
    try:
        q = _corpus(3)
        index.topk(q)
        index.add(_corpus(24))
        flushed = index.flush(timeout=30.0)
        index.topk(q)
        trace, _ = trace_call(index.topk, (q,))
        n_re = index.recompiles()
        run = summarize("serve_live_index", trace, False)
        run.results.append(CheckResult(
            run.name, "recompile-across-swaps", n_re == 0 and flushed,
            "" if n_re == 0 and flushed else
            f"flushed {flushed}, {n_re} new query shapes across the swap"))
        return run
    finally:
        index.close()


# ------------------------------------------------------------ group entries
def _group_entries(group) -> dict:
    """The entries of a gloo group of :data:`GROUP_WORLD` ranks."""
    cfg = tiny_config
    return {
        "train_step_milnce@W2": lambda: train_entry(
            "train_step_milnce@W2", cfg(), group=group),
        "train_step_milnce_guarded@W2": lambda: train_entry(
            "train_step_milnce_guarded@W2", cfg(), True, group=group),
        "grad_cache_step_milnce@W2": lambda: train_entry(
            "grad_cache_step_milnce@W2", cfg(), True, accum=2, group=group),
        "train_step_milnce_2d": lambda: train_entry(
            "train_step_milnce_2d", cfg(), group=group, model_size=2),
        "train_step_milnce_2d_guarded": lambda: train_entry(
            "train_step_milnce_2d_guarded", cfg(), True, group=group,
            model_size=2),
        "grad_cache_2d": lambda: train_entry(
            "grad_cache_2d", cfg(), True, accum=2, group=group,
            model_size=2),
        "train_step_milnce_2d_fused": lambda: train_entry(
            "train_step_milnce_2d_fused", cfg(), group=group, model_size=2,
            overlap=False),
        "train_step_milnce_2d_guarded_fused": lambda: train_entry(
            "train_step_milnce_2d_guarded_fused", cfg(), True, group=group,
            model_size=2, overlap=False),
        "grad_cache_2d_fused": lambda: train_entry(
            "grad_cache_2d_fused", cfg(), True, accum=2, group=group,
            model_size=2, overlap=False),
    }


GROUP_ENTRIES = ("train_step_milnce@W2", "train_step_milnce_guarded@W2",
                 "grad_cache_step_milnce@W2", "train_step_milnce_2d",
                 "train_step_milnce_2d_guarded", "grad_cache_2d",
                 "train_step_milnce_2d_fused",
                 "train_step_milnce_2d_guarded_fused", "grad_cache_2d_fused")


def _group_rank(rank: int, world: int, store: str, names, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        try:
            entries = _group_entries(dist.group.WORLD)
            runs = {}
            for name in names:
                try:
                    runs[name] = entries[name]()
                except Exception as exc:    # reported as a failed build
                    runs[name] = "".join(traceback.format_exception(exc))
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(out, "wb") as fh:
                pickle.dump(runs, fh)
    except BaseException:
        with open(f"{out}.rank{rank}.err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


def run_group_entries(names=GROUP_ENTRIES, timeout: float = 300.0) -> dict:
    """Run the group entries ``names`` in one spawned pair of gloo ranks
    (a ``FileStore`` in a temporary directory, no port); -> {name:
    EntryRun or a traceback string}."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "runs")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_group_rank,
                             args=(r, GROUP_WORLD, store, tuple(names), out))
                 for r in range(GROUP_WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if not os.path.exists(out):
            errs = [open(os.path.join(tmp, f)).read()
                    for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
            return {n: "group ranks failed:\n" + "\n".join(errs)
                    for n in names}
        with open(out, "rb") as fh:
            return pickle.load(fh)


ENTRY_POINTS = {
    "train_step_milnce": _entry_train_step_milnce,
    "train_step_milnce_guarded": _entry_train_step_milnce_guarded,
    "train_step_milnce_instrumented": _entry_train_step_milnce_instrumented,
    "train_step_curriculum": _entry_train_step_curriculum,
    "train_step_milnce_chunked": _entry_train_step_milnce_chunked,
    "train_step_sdtw3": _entry_train_step_sdtw3,
    "grad_cache_step_milnce": _entry_grad_cache_step_milnce,
    "retrieval_embed": _entry_retrieval_embed,
    "softdtw": _entry_softdtw,
    "state_dict": _entry_state_dict,
    "serve_embed_ladder": _entry_serve_embed_ladder,
    "serve_pool_embed": _entry_serve_pool_embed,
    "serve_quant_embed_ladder": _entry_serve_quant_embed_ladder,
    "serve_index_topk": _entry_serve_index_topk,
    "serve_live_index": _entry_serve_live_index,
}
ALL_ENTRIES = tuple(ENTRY_POINTS) + GROUP_ENTRIES

_RUNS: dict = {}


def run_entry(name: str):
    """One entry's run, once a process (Passes 2, 4 and 5 share it), on
    one CPU thread as the group ranks run (with more, the CPU kernels
    lay some gradients out otherwise and the accumulation copies them:
    other ops, other bytes); an entry's exception comes back as its
    traceback string."""
    if name not in _RUNS:
        if name in GROUP_ENTRIES:
            _RUNS.update(run_group_entries())
            return _RUNS[name]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _RUNS[name] = ENTRY_POINTS[name]()
        except Exception as exc:            # reported as a failed build
            _RUNS[name] = "".join(traceback.format_exception(exc))
        finally:
            torch.set_num_threads(threads)
    return _RUNS[name]


def run_trace_invariants(entries=None) -> list[CheckResult]:
    """The Pass 2 checks of ``entries`` (all by default); an entry's
    exception is a failing ``build`` result, never a crash."""
    results: list[CheckResult] = []
    for name in entries or ALL_ENTRIES:
        run = run_entry(name)
        if isinstance(run, str):
            results.append(CheckResult(name, "build", False,
                                       run.strip().splitlines()[-1]))
            continue
        results.extend(check_entry(run) if run.plan is not None
                       else run.results)
    return results


def traced_runs(entries=None) -> dict:
    """{name: EntryRun} of the entries with a trace (every one but
    ``state_dict``) that built."""
    out = {}
    for name in entries or ALL_ENTRIES:
        run = run_entry(name)
        if not isinstance(run, str) and run.plan is not None:
            out[name] = run
    return out
