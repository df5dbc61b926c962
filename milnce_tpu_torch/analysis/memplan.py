"""graftlint Pass 4 for the PyTorch port: the peak of live bytes of an
entry, from its op trace's storage lifetimes (``analysis/optrace.py``).

A storage lives from the op that creates it to the collection of the
last tensor on it; the entry's arguments (parameters, buffers,
gradients, optimizer tensors, inputs) live from the start.  The plan's
peak is the most bytes live at once, and its contributors are the
storages live at that moment, largest first, named by argument
(``text_module.fc2.weight``, ``state/<param>/exp_avg``, ``grad/<param>``)
or by the op that made them (``convolution f32[16,64,16,112,112]``).

Rules (entry-level: pinned tables, never inline suppressions):

- **GL013** — the peak within ``PEAK_TOLERANCE`` (0.10, the JAX
  planner's) of ``EXPECTED_PEAK_BYTES``;
- **GL014** — the eager form of a missing donation: a gradient still
  alive when the step's forward starts (``zero_grad(set_to_none=False)``),
  or a buffer made inside the step, of at least ``LEAK_FRACTION`` of the
  state's bytes, still alive when it returns (a saved copy outliving
  the step);
- **GL015** — the names of the top-3 contributors equal
  ``EXPECTED_TOP_CONTRIBUTORS``.

:func:`what_if_step` plans the full train step at any shape on the
``meta`` device (no card, no allocation) and :func:`budget_verdict`
holds a plan against a budget; the curriculum pre-flight prints it
beside its trial on the card.

Known approximations, against ``torch.cuda.max_memory_allocated``: the
caching allocator rounds every block up (512 B, and 2 MiB segments for
large ones); cuDNN and cuBLAS workspaces and any buffer an op allocates
and frees inside itself are invisible to a dispatch mode; the process's
other tensors (prefetched batches, a model kept for evaluation) are not
the entry's.
"""

from __future__ import annotations

import dataclasses

import torch

from milnce_tpu_torch.analysis.astlint import Finding
from milnce_tpu_torch.analysis.optrace import OpTrace, meta_fused, trace_call
from milnce_tpu_torch.analysis.rules import RULES

PEAK_TOLERANCE = 0.10
LEAK_FRACTION = 0.05


@dataclasses.dataclass
class MemPlan:
    entry: str
    peak_bytes: int
    argument_bytes: int
    contributors: list          # [(label, bytes)], largest first
    leaked: list                # [(label, bytes)] made in, alive after
    grads_at_forward: int       # gradient bytes alive at the forward

    def summary(self) -> str:
        top = ", ".join(f"{label} ({b / 2**20:.2f} MiB)"
                        for label, b in self.contributors[:3])
        return (f"{self.entry}: peak {self.peak_bytes / 2**30:.4f} GiB "
                f"(arguments {self.argument_bytes / 2**30:.4f} GiB); top: "
                f"{top}")


def plan_trace(trace: OpTrace, entry: str = "entry",
               step: bool = True) -> MemPlan:
    """The plan of one traced call; ``step``: a train step, whose
    storages made in the call and alive after it are GL014's leaks (a
    serving call's results may leave as host arrays on their
    storage)."""
    live = trace.live_at(trace.peak_clock)
    contributors = sorted(((s.label, s.nbytes) for s in live),
                          key=lambda x: (-x[1], x[0]))
    state = trace.argument_bytes()
    leaked = sorted(((s.label, s.nbytes) for s in trace.all_storages()
                     if not s.argument and s.died is None
                     and not s.returned and s.label != "unregistered"
                     and not s.label.startswith(("grad/", "state/"))
                     and s.nbytes >= LEAK_FRACTION * max(state, 1)),
                    key=lambda x: -x[1]) if step else []
    first = next((op for op in trace.ops if op.kind == "op"
                  and not op.owner.startswith(("entry", "backward",
                                               "optimizer"))), None)
    grads = 0
    if first is not None:
        grads = sum(s.nbytes for s in trace.live_at(first.clock)
                    if s.label.startswith("grad/"))
    return MemPlan(entry, trace.peak_bytes, state, contributors, leaked,
                   grads)


# ------------------------------------------------------------ the pins
# Measured on the CPU at the entries' tiny shapes (analysis/
# trace_invariants.py), bytes.  Re-pin from the drift message.
EXPECTED_PEAK_BYTES = {
    'train_step_milnce': 12727944,
    'train_step_milnce_guarded': 12736360,
    'train_step_milnce_instrumented': 12736360,
    'train_step_curriculum': 15932160,
    'train_step_milnce_chunked': 12736360,
    'train_step_sdtw3': 12736360,
    'grad_cache_step_milnce': 11609412,
    'retrieval_embed': 3875040,
    'softdtw': 6664,
    'serve_embed_ladder': 3874848,
    'serve_pool_embed': 3874848,
    'serve_quant_embed_ladder': 4396596,
    'serve_index_topk': 11724,
    'serve_live_index': 18444,
    'train_step_milnce@W2': 10581596,
    'train_step_milnce_guarded@W2': 10590012,
    'grad_cache_step_milnce@W2': 10590396,
    'train_step_milnce_2d': 8778400,
    'train_step_milnce_2d_guarded': 8786816,
    'grad_cache_2d': 9030940,
    'train_step_milnce_2d_fused': 9032608,
    'train_step_milnce_2d_guarded_fused': 9041024,
    'grad_cache_2d_fused': 9216796,
}
EXPECTED_TOP_CONTRIBUTORS = {
    'train_step_milnce': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'convolution f32[4,64,2,16,16]',
        'relu f32[4,64,2,16,16]',
    ],
    'train_step_milnce_guarded': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'convolution f32[4,64,2,16,16]',
        'relu f32[4,64,2,16,16]',
    ],
    'train_step_milnce_instrumented': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'convolution f32[4,64,2,16,16]',
        'relu f32[4,64,2,16,16]',
    ],
    'train_step_curriculum': [
        'constant_pad_nd f32[2,64,4,21,21]',
        'convolution f32[2,64,4,20,20]',
        'relu f32[2,64,4,20,20]',
    ],
    'train_step_milnce_chunked': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'convolution f32[4,64,2,16,16]',
        'relu f32[4,64,2,16,16]',
    ],
    'train_step_sdtw3': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'convolution f32[4,64,2,16,16]',
        'relu f32[4,64,2,16,16]',
    ],
    'grad_cache_step_milnce': [
        'conv_2c.conv1.weight',
        'conv_2c.conv2.weight',
        'convolution_backward f32[128,96,1,3,3]',
    ],
    'retrieval_embed': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'relu f32[4,64,2,16,16]',
        'conv_2c.conv1.weight',
    ],
    'softdtw': ['arg0', 'where f32[3,8,5]', 'arg1'],
    'serve_embed_ladder': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'relu f32[4,64,2,16,16]',
        'conv_2c.conv1.weight',
    ],
    'serve_pool_embed': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'relu f32[4,64,2,16,16]',
        'conv_2c.conv1.weight',
    ],
    'serve_quant_embed_ladder': [
        'constant_pad_nd f32[4,64,2,17,17]',
        'relu f32[4,64,2,16,16]',
        'mul f32[128,96,1,3,3]',
    ],
    'serve_index_topk': ['__lshift__ i64[8,40]', 'add i64[8,40]', 'unregistered'],
    'serve_live_index': ['__lshift__ i64[8,64]', 'add i64[8,64]', 'unregistered'],
    'train_step_milnce@W2': [
        'cat f32[527312]',
        'conv_2c.conv1.weight',
        'conv_2c.conv2.weight',
    ],
    'train_step_milnce_guarded@W2': [
        'cat f32[527312]',
        'conv_2c.conv1.weight',
        'conv_2c.conv2.weight',
    ],
    'grad_cache_step_milnce@W2': [
        'cat f32[527312]',
        'conv_2c.conv1.weight',
        'conv_2c.conv2.weight',
    ],
    'train_step_milnce_2d': [
        'cat f32[128,96,1,3,3]',
        'cat f32[192,192,3,1,1]',
        'cat f32[192,64,1,3,3]',
    ],
    'train_step_milnce_2d_guarded': [
        'cat f32[128,96,1,3,3]',
        'cat f32[192,192,3,1,1]',
        'cat f32[192,64,1,3,3]',
    ],
    'grad_cache_2d': [
        'cat f32[128,96,1,3,3]',
        'cat f32[192,192,3,1,1]',
        'cat f32[192,64,1,3,3]',
    ],
    'train_step_milnce_2d_fused': [
        'cat f32[128,96,1,3,3]',
        'cat f32[192,192,3,1,1]',
        'cat f32[192,64,1,3,3]',
    ],
    'train_step_milnce_2d_guarded_fused': [
        'cat f32[128,96,1,3,3]',
        'cat f32[192,192,3,1,1]',
        'cat f32[192,64,1,3,3]',
    ],
    'grad_cache_2d_fused': [
        'cat f32[128,96,1,3,3]',
        'cat f32[192,192,3,1,1]',
        'cat f32[192,64,1,3,3]',
    ],
}


def check_plan(plan: MemPlan, expected_peak=None, expected_top=None
               ) -> list[Finding]:
    """GL013-GL015 findings of one plan against its pins (the tables'
    by default)."""
    out = []
    where = f"<entry:{plan.entry}>"
    want = (EXPECTED_PEAK_BYTES.get(plan.entry) if expected_peak is None
            else expected_peak)
    if want is not None and abs(plan.peak_bytes - want) > PEAK_TOLERANCE * want:
        out.append(Finding(where, 0, RULES["GL013"],
                           f"{plan.entry}: peak {plan.peak_bytes} B drifted "
                           f"{(plan.peak_bytes - want) / want:+.1%} from the "
                           f"pinned {want} B (tolerance "
                           f"{PEAK_TOLERANCE:.0%}); top: "
                           f"{plan.contributors[:3]}"))
    top = [label for label, _ in plan.contributors[:3]]
    want_top = (EXPECTED_TOP_CONTRIBUTORS.get(plan.entry)
                if expected_top is None else expected_top)
    if want_top is not None and top != list(want_top):
        out.append(Finding(where, 0, RULES["GL015"],
                           f"{plan.entry}: top-3 peak contributors {top} "
                           f"!= pinned {list(want_top)}"))
    if plan.grads_at_forward:
        out.append(Finding(where, 0, RULES["GL014"],
                           f"{plan.entry}: {plan.grads_at_forward} B of "
                           "gradients alive when the forward starts — set "
                           "them to None (zero_grad(set_to_none=True))"))
    for label, nbytes in plan.leaked:
        out.append(Finding(where, 0, RULES["GL014"],
                           f"{plan.entry}: {label} ({nbytes} B) made in the "
                           "step is still alive after it — a copy that "
                           "outlives the step"))
    return out


def repin_dict(plans: list[MemPlan]) -> str:
    """The paste-ready pin tables of ``plans``."""
    peaks = {p.entry: p.peak_bytes for p in plans}
    tops = {p.entry: [label for label, _ in p.contributors[:3]]
            for p in plans}
    return (f"EXPECTED_PEAK_BYTES = {peaks!r}\n"
            f"EXPECTED_TOP_CONTRIBUTORS = {tops!r}")


# ------------------------------------------------------------ what-if
def build_meta_step(cfg, finite_guard: bool = True):
    """The train step of ``cfg`` (its model, optimizer, schedule, loss,
    ``train.grad_accum``) with the model on ``meta``: no weights are
    drawn and nothing is allocated.  -> (model, optimizer, step)."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.train.schedule import build_schedule
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import (make_grad_cache_step,
                                             make_train_step)

    with torch.device("meta"):
        model = build_model(cfg.model)
    with meta_fused():
        optimizer, lr = build_optimizer(model, cfg.optim,
                                        build_schedule(cfg.optim, 1000))
    kw = dict(finite_guard=finite_guard, lr_scheduler=lr)
    if cfg.train.grad_accum > 1:
        step = make_grad_cache_step(model, optimizer, cfg.train.grad_accum,
                                    cfg.loss, **kw)
    else:
        step = make_train_step(model, optimizer, cfg.loss, **kw)
    return model, optimizer, step


def step_inputs(batch: int, frames: int, size: int, candidates: int,
                words: int, device="meta") -> tuple:
    """A step's (video u8, text ids i32 (B*K, W), start f32) of that
    shape (zeros; nothing is allocated on meta)."""
    return (torch.zeros((batch, frames, size, size, 3), dtype=torch.uint8,
                        device=device),
            torch.zeros((batch * candidates, words), dtype=torch.int32,
                        device=device),
            torch.zeros(batch, device=device))


def plan_step(model, optimizer, step, inputs: tuple, entry: str,
              warm: bool = True) -> tuple:
    """Plan a steady-state step: one untraced-for-the-plan step first
    (Adam's moments exist after it, as on the card from step 2), then
    the traced one.  -> (plan, trace)."""
    with meta_fused():
        if warm:
            with OpTrace(model):
                step(*inputs)
        trace, _ = trace_call(step, inputs, model=model, optimizer=optimizer)
    return plan_trace(trace, entry), trace


def what_if_step(batch: int, frames: int, size: int, cfg=None, *,
                 remat: bool | None = None, accum: int | None = None,
                 finite_guard: bool = True, entry: str | None = None
                 ) -> MemPlan:
    """Plan the train step of ``cfg`` (the full preset's model and loss
    by default) at ``batch`` clips of ``frames`` x ``size``^2 on
    ``meta``.  ``remat``/``accum`` override ``model.remat`` and
    ``train.grad_accum``."""
    import copy

    from milnce_tpu_torch.config import full_preset

    cfg = copy.deepcopy(cfg) if cfg is not None else full_preset()
    if remat is not None:
        cfg.model.remat = remat
    if accum is not None:
        cfg.train.grad_accum = accum
    model, optimizer, step = build_meta_step(cfg, finite_guard)
    inputs = step_inputs(batch, frames, size, cfg.data.num_candidates,
                         cfg.data.max_words)
    name = entry or (f"train_step@{batch}x{frames}f@{size}"
                     + ("+remat" if cfg.model.remat else "")
                     + (f"/accum{cfg.train.grad_accum}"
                        if cfg.train.grad_accum > 1 else ""))
    plan, _ = plan_step(model, optimizer, step, inputs, name)
    return plan


def budget_verdict(plan: MemPlan, budget_gib: float) -> tuple:
    """(fits, message) against a device budget; the message names the
    top-3 contributors."""
    budget = int(budget_gib * 2 ** 30)
    fits = plan.peak_bytes <= budget
    top = ", ".join(f"{label} ({b / 2**20:.1f} MiB)"
                    for label, b in plan.contributors[:3])
    msg = (f"{plan.entry}: static plan {plan.peak_bytes / 2**30:.3f} GiB "
           f"{'fits' if fits else 'EXCEEDS'} the {budget_gib:g} GiB budget"
           f"; top contributors: {top}")
    return fits, msg
