"""graftlint Pass 4 of the PyTorch port (``analysis/memplan.py``): the
planner is exact on hand-counted programs, plans the tiny step on
``meta`` byte for byte as on CPU tensors, fires GL013-GL015 on planted
drifts, and orders the losses and the guard as their buffers say."""

import copy

import pytest
import torch
import torch.utils.checkpoint as ckpt

from milnce_tpu_torch.analysis import memplan
from milnce_tpu_torch.analysis import trace_invariants as ti
from milnce_tpu_torch.analysis.optrace import OpTrace, trace_call
from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss

torch.set_num_threads(1)         # six test workers share the cores

N = 1024                         # floats: 4096 bytes a buffer


def test_chain_with_known_frees():
    def chain(x):
        y = x * 2
        z = y + 1               # x, y, z live: the peak
        del y
        w = z * 3               # x, z, w
        del z
        return w.sum()

    trace, _ = trace_call(chain, (torch.ones(N),))
    assert trace.peak_bytes == 3 * 4 * N
    assert memplan.plan_trace(trace).contributors == [
        ("add f32[1024]", 4 * N), ("arg0", 4 * N), ("mul f32[1024]", 4 * N)]
    assert trace.argument_bytes() == 4 * N


def test_view_shares_its_base_storage():
    def views(x):
        v = x[1:]
        t = x.view(2, N // 2).t()
        return (v * 1).sum() + t.sum()

    trace, _ = trace_call(views, (torch.ones(N),))
    labels = [s.label for s in trace.all_storages()]
    assert not any(label.startswith(("slice", "view", "t ")) for label in
                   labels)
    # x, v * 1 and its sum, while the sum is made
    assert trace.peak_bytes == 4 * N + 4 * (N - 1) + 4


@pytest.mark.parametrize("checkpointed,live", [(False, 3), (True, 2)])
def test_checkpointed_block_keeps_no_intermediate(checkpointed, live):
    """After the forward, the plain block keeps x, a (saved for a * a)
    and b; the checkpointed one x and b alone."""
    def block(x):
        a = x * 2
        return a * a

    def run(x):
        b = ckpt.checkpoint(block, x, use_reentrant=False) if checkpointed \
            else block(x)
        marker = torch.empty(0)         # the clock after the forward
        b.sum().backward()
        return marker

    x = torch.ones(N, requires_grad=True)
    trace, _ = trace_call(run, (x,))
    mark = next(op for op in trace.ops if op.name == "empty")
    assert sum(s.nbytes for s in trace.live_at(mark.clock)) == live * 4 * N


def test_tiny_step_plans_the_same_on_meta_and_on_cpu():
    cfg = ti.tiny_config()
    meta = memplan.what_if_step(ti.B, ti.FRAMES, ti.SIZE, cfg)
    model, optimizer, step = ti.build_train_step(cfg, True)
    inputs = memplan.step_inputs(ti.B, ti.FRAMES, ti.SIZE, ti.K, ti.WORDS,
                                 device="cpu")
    cpu, _ = memplan.plan_step(model, optimizer, step, inputs, "cpu")
    assert meta.peak_bytes == cpu.peak_bytes
    assert meta.argument_bytes == cpu.argument_bytes
    assert meta.contributors == cpu.contributors


@pytest.mark.parametrize("entry", [e for e in ti.ENTRY_POINTS
                                   if e != "state_dict"])
def test_registered_entries_plan_at_their_pins(entry):
    run = ti.run_entry(entry)
    assert not isinstance(run, str), run
    assert memplan.check_plan(run.plan) == []


def test_pins_cover_every_traced_entry():
    traced = set(ti.ALL_ENTRIES) - {"state_dict"}
    assert set(memplan.EXPECTED_PEAK_BYTES) == traced
    assert set(memplan.EXPECTED_TOP_CONTRIBUTORS) == traced


def _guarded_plan():
    return ti.run_entry("train_step_milnce_guarded").plan


def test_gl013_fires_once_on_a_peak_drift():
    plan = copy.deepcopy(_guarded_plan())
    plan.peak_bytes = int(plan.peak_bytes * 1.2)
    assert [f.rule.id for f in memplan.check_plan(plan)] == ["GL013"]


def test_gl015_fires_once_on_a_contributor_drift():
    plan = copy.deepcopy(_guarded_plan())
    plan.contributors = plan.contributors[1:]
    assert [f.rule.id for f in memplan.check_plan(plan)] == ["GL015"]


def test_gl014_fires_once_on_gradients_kept_through_the_forward(monkeypatch):
    model, optimizer, step = ti.build_train_step(ti.tiny_config(), True)
    real = optimizer.zero_grad
    monkeypatch.setattr(optimizer, "zero_grad",
                        lambda set_to_none=True: real(set_to_none=False))
    plan, _ = memplan.plan_step(model, optimizer, step, ti.tiny_inputs(1),
                                "zeroed-in-place")
    assert plan.grads_at_forward > 0
    found = memplan.check_plan(plan, expected_peak=plan.peak_bytes,
                               expected_top=[c for c, _ in
                                             plan.contributors[:3]])
    assert [f.rule.id for f in found] == ["GL014"]


def test_gl014_fires_once_on_a_copy_outliving_the_step():
    model, optimizer, step = ti.build_train_step(ti.tiny_config(), True)
    kept = []

    def leaky(*args):
        out = step(*args)
        kept.append(torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()]))
        return out

    plan, _ = memplan.plan_step(model, optimizer, leaky, ti.tiny_inputs(1),
                                "leaky")
    found = memplan.check_plan(plan, expected_peak=plan.peak_bytes,
                               expected_top=[c for c, _ in
                                             plan.contributors[:3]])
    assert [f.rule.id for f in found] == ["GL014"]
    assert "cat" in found[0].message


def test_chunked_loss_plans_below_the_dense_loss():
    """MIL-NCE alone, forward and backward, 1024 clips of 5 captions at
    D = 512 on meta: the stream kernels' path never holds the (B, B*K)
    logits the dense loss does (its split partials grow with B alone: at
    128 clips they outweigh the small cube, 7.6 MB against 3.5)."""
    from milnce_tpu_torch.config import LossConfig

    def plan(cfg):
        fn = build_milnce_loss(cfg)

        def loss(v, t):
            fn(v, t).backward()

        v = torch.empty(1024, 512, device="meta", requires_grad=True)
        t = torch.empty(5120, 512, device="meta", requires_grad=True)
        trace = OpTrace()
        trace.arguments([("v", v), ("t", t)])
        with trace:
            loss(v, t)
        return trace.peak_bytes

    dense = plan(LossConfig(milnce_impl="dense"))
    chunked = plan(LossConfig(milnce_impl="chunked", milnce_backend="cuda",
                              milnce_chunk=8))
    assert chunked < dense
    assert dense - chunked >= 1024 * 5120 * 4


def test_guarded_step_plans_above_the_plain_by_one_saved_copy_at_most():
    from milnce_tpu_torch.models.build import build_model

    plain = ti.run_entry("train_step_milnce").plan.peak_bytes
    guarded = _guarded_plan().peak_bytes
    model = build_model(ti.tiny_config().model, seed=0)
    copy_bytes = sum(b.numel() * b.element_size() for b in model.buffers())
    assert 0 <= guarded - plain <= copy_bytes


def test_what_if_and_budget_verdict():
    plan = memplan.what_if_step(2, ti.FRAMES, ti.SIZE, ti.tiny_config())
    fits, msg = memplan.budget_verdict(plan, 80.0)
    assert fits and "fits the 80 GiB budget" in msg
    fits, msg = memplan.budget_verdict(plan, plan.peak_bytes / 2 ** 31)
    assert not fits and "EXCEEDS" in msg and plan.contributors[0][0] in msg
