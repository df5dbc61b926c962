"""``python -m milnce_tpu_torch.analysis``: graftlint for the port.

    python -m milnce_tpu_torch.analysis --check --no-trace   # AST gate
    python -m milnce_tpu_torch.analysis --check              # every pass
    python -m milnce_tpu_torch.analysis --what-if --batch 16 --frames 32 \\
        --size 224 [--remat] [--accum 8]                      # static plan
    python -m milnce_tpu_torch.analysis --what-if --dtype bf16  # demotions

Passes 1 and 3 (AST, no torch import) always run over ``paths``
(default: the port's package).  Without ``--no-trace`` the registered
entries run on the CPU at tiny sizes for Passes 2, 4 and 5 (a spawned
pair of gloo ranks for the group entries).  ``--check`` exits 1 on any
unsuppressed finding or failing check.  ``--repin`` prints the
paste-ready pin tables of every pass from this run.  ``--report PATH``
writes the markdown report there; nothing is written otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys


def _results(entry, check, findings):
    from milnce_tpu_torch.analysis.trace_invariants import CheckResult

    if not findings:
        return [CheckResult(entry, check, True)]
    return [CheckResult(entry, f"{check}:{f.rule.id}", False, f.message)
            for f in findings]


def _what_if(args) -> int:
    from milnce_tpu_torch.analysis import memplan

    if args.dtype == "bf16":
        from milnce_tpu_torch.analysis import numerics, trace_invariants

        for name, run in trace_invariants.traced_runs(
                [e for e in trace_invariants.ENTRY_POINTS
                 if e.startswith("train_step")]).items():
            sites = run.audit["what_if_bf16"]
            print(f"{name}: {len(sites)} f32 accumulations at extent >= "
                  f"{numerics.GL016_MIN_EXTENT} a bf16 model would demote")
            for site in sites:
                print(f"  {site}")
        return 0
    plan = memplan.what_if_step(args.batch, args.frames, args.size,
                                remat=args.remat, accum=args.accum)
    print(plan.summary())
    if args.budget_gib:
        print(memplan.budget_verdict(plan, args.budget_gib)[1])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m milnce_tpu_torch.analysis",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--no-concurrency", action="store_true")
    ap.add_argument("--no-memplan", action="store_true")
    ap.add_argument("--no-numerics", action="store_true")
    ap.add_argument("--repin", action="store_true")
    ap.add_argument("--report", default="")
    ap.add_argument("--what-if", action="store_true")
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--budget-gib", type=float, default=0.0)
    args = ap.parse_args(argv)
    if args.what_if:
        return _what_if(args)

    from milnce_tpu_torch.analysis.astlint import lint_paths_full

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = args.paths or [here]
    findings, graph = lint_paths_full(paths,
                                      concurrency=not args.no_concurrency)
    active = [f for f in findings if not f.suppressed]
    for f in active:
        print(f.format())
    print(f"graftlint passes 1+3: {len(active)} findings, "
          f"{len(findings) - len(active)} audited suppressions")
    trace_results = mem_results = num_results = plans = None
    if not args.no_trace:
        from milnce_tpu_torch.analysis import (memplan, numerics,
                                               trace_invariants)

        trace_results = trace_invariants.run_trace_invariants()
        runs = trace_invariants.traced_runs()
        plans = [r.plan for r in runs.values()]
        if not args.no_memplan:
            mem_results = [r for run in runs.values() for r in _results(
                run.name, "memplan", memplan.check_plan(run.plan))]
        if not args.no_numerics:
            num_results = [r for run in runs.values() for r in _results(
                run.name, "numerics",
                numerics.check_pins(run.name, run.audit))]
        for r in (trace_results + (mem_results or []) + (num_results or [])):
            if not r.ok:
                print(r.format())
        bad = sum(not r.ok for r in trace_results + (mem_results or [])
                  + (num_results or []))
        print(f"graftlint passes 2/4/5: {len(runs)} entries, {bad} failing "
              "checks")
        if args.repin:
            print("# analysis/trace_invariants.py")
            print("EXPECTED_COLLECTIVES = "
                  f"{ {n: r.collectives for n, r in runs.items()}!r}")
            print("EXPECTED_LAUNCHES = "
                  f"{ {n: r.launches for n, r in runs.items()}!r}")
            print("# analysis/memplan.py")
            print(memplan.repin_dict(plans))
            print("# analysis/numerics.py")
            print(numerics.repin_dict({n: r.audit for n, r in runs.items()}))
    if args.report:
        from milnce_tpu_torch.analysis.report import render_report

        with open(args.report, "w") as fh:
            fh.write(render_report(findings, trace_results, paths, graph,
                                   mem_results, num_results, plans))
    if not args.check:
        return 0
    failing = len(active) + sum(
        not r.ok for r in (trace_results or []) + (mem_results or [])
        + (num_results or []))
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
