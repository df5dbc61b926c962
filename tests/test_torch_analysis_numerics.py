"""graftlint Pass 5 of the PyTorch port (``analysis/numerics.py``): the
dtype census is bucketed by dtype, GL016-GL018 fire once each on planted
cases (GL017 on both halves), every registered entry audits green
against its pins, and the bf16 what-if names the reductions a bf16 model
would demote."""

import pytest
import torch

from milnce_tpu_torch.analysis import astlint, numerics
from milnce_tpu_torch.analysis import trace_invariants as ti
from milnce_tpu_torch.analysis.optrace import trace_call

torch.set_num_threads(1)         # six test workers share the cores


def test_census_buckets_bytes_by_dtype():
    def program(x):
        y = x.to(torch.bfloat16)        # 16 B of bf16
        z = y.sum()                     # 2 B of bf16
        i = x.long()                    # 64 B of i64
        return z, i

    trace, _ = trace_call(program, (torch.ones(8),))
    assert numerics.census(trace) == {"bf16": 18, "f32": 32, "i64": 64}
    assert numerics.casts(trace) == {"f32->bf16 _to_copy @ arg0": 1,
                                     "f32->i64 _to_copy @ arg0": 1}


def test_gl016_fires_once_on_a_planted_bf16_reduction():
    def program(x):
        return x.bfloat16().sum(dim=1), x.sum(dim=1)    # the f32 one is ok

    trace, _ = trace_call(program, (torch.ones(4, 128),))
    audit = numerics.audit(trace)
    assert audit["gl016"] == ["sum extent 128 bf16 @ entry"]
    found = numerics.check_pins("planted", audit, audit["census"],
                                audit["casts"])
    assert [f.rule.id for f in found] == ["GL016"]


def test_gl017_trace_half_fires_once():
    def program(x):
        guarded = torch.exp(x - x.amax())
        return torch.exp(x) + guarded

    trace, _ = trace_call(program, (torch.randn(16),))
    audit = numerics.audit(trace)
    assert len(audit["gl017"]) == 1
    found = numerics.check_pins("planted", audit, audit["census"],
                                audit["casts"])
    assert [f.rule.id for f in found] == ["GL017"]


def test_gl017_source_half_fires_once_in_losses():
    src = ("import torch\n"
           "def loss(x):\n"
           "    neg = torch.exp(x).sum()\n"
           "    row_max = x.amax(dim=1, keepdim=True)\n"
           "    ok = torch.exp(x - row_max).sum()\n"
           "    return neg + ok\n")
    found = astlint.lint_source(src, "milnce_tpu_torch/losses/planted.py")
    assert [f.rule.id for f in found] == ["GL017"]
    assert astlint.lint_source(src, "milnce_tpu_torch/eval/planted.py") == []


@pytest.mark.parametrize("drift", ["census", "casts"])
def test_gl018_fires_once_on_a_drift(drift):
    run = ti.run_entry("train_step_milnce_guarded")
    census, casts = dict(run.audit["census"]), dict(run.audit["casts"])
    if drift == "census":
        census["bf16"] = 1024
    else:
        casts.pop(next(iter(casts)))
    found = numerics.check_pins(run.name, run.audit, census, casts)
    assert [f.rule.id for f in found] == ["GL018"]
    assert drift.rstrip("s") in found[0].message or "cast" in \
        found[0].message


def test_residency_names_a_demoted_statistic():
    bn = torch.nn.BatchNorm1d(4).to(torch.bfloat16)
    x = torch.randn(8, 4, dtype=torch.bfloat16)
    trace, _ = trace_call(bn, (x,), model=bn)
    assert any("running_mean" in r for r in numerics.residency(trace))


@pytest.mark.parametrize("entry", [e for e in ti.ALL_ENTRIES
                                   if e != "state_dict"])
def test_registered_entries_audit_green(entry):
    run = ti.run_entry(entry)
    assert not isinstance(run, str), run
    assert numerics.check_pins(run.name, run.audit) == []
    assert run.audit["residency"] == []


def test_pins_cover_every_traced_entry():
    traced = set(ti.ALL_ENTRIES) - {"state_dict"}
    assert set(numerics.EXPECTED_DTYPE_CENSUS) == traced
    assert set(numerics.EXPECTED_CASTS) == traced


def test_bf16_what_if_names_the_demotions():
    sites = ti.run_entry("train_step_milnce").audit["what_if_bf16"]
    assert any(s.startswith("convolution") for s in sites)
    assert any(s.startswith(("mm", "addmm")) for s in sites)
    assert all("f32" in s for s in sites)
