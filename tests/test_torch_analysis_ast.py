"""graftlint Passes 1 and 3 of the PyTorch port (``milnce_tpu_torch/
analysis/{rules,astlint,concurrency}.py``): held against the JAX
package's passes on the same sources where the two share a vocabulary
(the suppression syntax, GL007, the lock discipline GL010-GL012, the
guard map and the lock-order edges), the port's own fixture (every rule
GL001-GL012 fires once and is suppressed once), and the clean bill of the
port's tree through ``python -m milnce_tpu_torch.analysis``."""

import os
import subprocess
import sys
from collections import Counter

import pytest

from milnce_tpu.analysis import astlint as jax_astlint
from milnce_tpu.analysis import concurrency as jax_concurrency
from milnce_tpu.analysis.rules import RULES as JAX_RULES
from milnce_tpu_torch.analysis import astlint, concurrency
from milnce_tpu_torch.analysis.rules import RULES, RULES_BY_NAME

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_graftlint_fixture.py")
JAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "graftlint_fixture.py")
SHARED = ("GL000", "GL007", "GL010", "GL011", "GL012")
# GL012 findings of the JAX sources that are device dispatches, whose
# verbs differ between the packages (jax.device_put / device_get /
# block_until_ready against .to(device) / .cuda() / .cpu() / .item() /
# synchronize): none in these sources, so the two agree line for line
DEVICE_DISPATCH_LINES: dict = {}


def _key(findings):
    """(path, line, rule, suppressed) of the shared rules, GL000 by its
    syntax cases (a stale suppression is stale against a pass's own
    vocabulary)."""
    return sorted((os.path.relpath(f.path, ROOT), f.line, f.rule.id,
                   f.suppressed) for f in findings
                  if f.rule.id in SHARED
                  and not (f.rule.id == "GL000" and "stale" in f.message))


@pytest.mark.parametrize("paths", [
    [JAX_FIXTURE],
    [os.path.join(ROOT, "milnce_tpu", "serving"),
     os.path.join(ROOT, "milnce_tpu", "obs")],
], ids=["jax-fixture", "jax-serving-obs"])
def test_ast_and_lock_passes_agree_with_jax(paths):
    jf, jg = jax_astlint.lint_paths_full(paths)
    pf, pg = astlint.lint_paths_full(paths)
    want, got = _key(jf), _key(pf)
    dispatch = {k for k in set(want) ^ set(got)
                if k[2] == "GL012" and k[1] in DEVICE_DISPATCH_LINES.get(
                    k[0], ())}
    assert set(want) ^ set(got) == dispatch
    assert want, "the shared rules fire on these sources"
    assert pg.edges == jg.edges


def test_guard_maps_agree_with_jax():
    files = astlint._discover_files([os.path.join(ROOT, "milnce_tpu", d)
                                     for d in ("serving", "obs")])
    seen = 0
    for path in files:
        src = open(path).read()
        _, _, want = jax_concurrency.lint_concurrency_source(src, path)
        _, _, got = concurrency.lint_concurrency_source(src, path)
        assert [(r.name, r.guards, r.write_once, r.shared, r.roots)
                for r in got] == [(r.name, r.guards, r.write_once, r.shared,
                                   r.roots) for r in want], path
        seen += sum(bool(r.guards) for r in got)
    assert seen >= 5


def test_rule_catalogue_keeps_the_jax_ids_and_names():
    assert [(r.id, r.name) for r in RULES.values()] == \
        [(r.id, r.name) for r in JAX_RULES.values()]
    assert len(RULES) == 19 and RULES_BY_NAME["host-sync-hot-loop"].id == \
        "GL001"
    for rule in RULES.values():
        assert "TPU" not in rule.rationale and "MXU" not in rule.rationale


def _fixture():
    return astlint.lint_source(open(FIXTURE).read(), FIXTURE)


def test_port_fixture_fires_every_rule_once():
    active = Counter(f.rule.id for f in _fixture() if not f.suppressed)
    assert active == {"GL000": 5, **{f"GL{i:03d}": 1 for i in range(1, 13)}}


def test_port_fixture_suppresses_every_rule_once():
    suppressed = [f for f in _fixture() if f.suppressed]
    assert Counter(f.rule.id for f in suppressed) == {
        f"GL{i:03d}": 1 for i in range(1, 13)}
    assert all(f.suppress_reason for f in suppressed)


@pytest.mark.parametrize("src,rule", [
    ("y = 1  # graftlint: disable=GL004\n", "no reason"),
    ("y = 1  # graftlint: disable=GL123(whatever)\n", "unknown rule"),
    ("y = 1  # graftlint: disable=GL016(entry)\n", "entry-level"),
    ("y = 1  # graftlint: disable=GL004(nothing here)\n", "stale"),
], ids=["no-reason", "unknown", "entry-level", "stale"])
def test_bad_suppressions_are_gl000(src, rule):
    (finding,) = astlint.lint_source(src)
    assert finding.rule.id == "GL000" and rule in finding.message


def test_suppression_by_name_and_on_its_own_line():
    src = ("import torch\n"
           "# graftlint: disable=f64-literal-drift(own-line form)\n"
           "x = torch.zeros(2, dtype=torch.float64)\n")
    (finding,) = astlint.lint_source(src)
    assert finding.rule.id == "GL004" and finding.suppressed
    assert finding.suppress_reason == "own-line form"


@pytest.mark.parametrize("src,fires", [
    ("def forward(self, x):\n    if x.shape[0] > 1:\n        pass\n", False),
    ("class M:\n    def forward(self, x, mode='pair'):\n"
     "        if mode == 'video':\n            pass\n", False),
    ("class M:\n    def forward(self, x):\n        y = x * 2\n"
     "        if y.any():\n            pass\n", True),
    ("class M:\n    def __init__(self, x):\n        if x:\n"
     "            pass\n", False),
], ids=["not-a-method", "host-argument", "tainted-by-assignment",
        "build-time"])
def test_step_scope_taint(src, fires):
    rules = [f.rule.id for f in astlint.lint_source(src)]
    assert ("GL002" in rules) == fires


def test_timing_needs_cuda_work_and_no_sync():
    host = ("import time\nimport torch\ndef f():\n    t0 = time.time()\n"
            "    g()\n    return time.time() - t0\n")
    assert astlint.lint_source(host) == []
    evented = ("import time\nimport torch\ndef f(x):\n"
               "    t0 = time.time()\n    x.cuda()\n"
               "    torch.cuda.synchronize()\n    return time.time() - t0\n")
    assert astlint.lint_source(evented) == []


def test_port_tree_lints_clean_in_process():
    findings = astlint.lint_paths([os.path.join(ROOT, "milnce_tpu_torch")])
    active = [f.format() for f in findings if not f.suppressed]
    assert not active, "\n".join(active)
    assert all(f.suppress_reason for f in findings if f.suppressed)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "milnce_tpu_torch.analysis", "--check",
         "--no-trace", *args], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))


def test_cli_clean_bill_on_the_port():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 findings" in proc.stdout


@pytest.mark.parametrize("src,rule", [
    ("import torch\npad = torch.tensor(0.5, dtype=torch.float64)\n",
     "GL004"),
    ("import threading\nA = threading.Lock()\nB = threading.Lock()\n"
     "def f():\n    with A:\n        with B:\n            pass\n"
     "def g():\n    with B:\n        with A:\n            pass\n", "GL011"),
], ids=["pass1", "pass3"])
def test_cli_fails_on_a_planted_finding(tmp_path, src, rule):
    bad = tmp_path / "bad_module.py"
    bad.write_text(src)
    report = tmp_path / "report.md"
    proc = _cli("--report", str(report), str(bad))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert rule in proc.stdout and rule in report.read_text()


def test_cli_writes_no_report_unless_asked(tmp_path):
    before = set(os.listdir(ROOT))
    assert _cli().returncode == 0
    assert set(os.listdir(ROOT)) == before
