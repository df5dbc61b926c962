"""The markdown report of ``python -m milnce_tpu_torch.analysis
--report PATH``: every pass's findings and checks, the audited
suppressions with their reasons, the lock-order edges and the rule
catalogue.  It is written only where ``--report`` says."""

from __future__ import annotations

from milnce_tpu_torch.analysis.astlint import Finding
from milnce_tpu_torch.analysis.rules import RULES

HEADER = ("<!-- written by `python -m milnce_tpu_torch.analysis --report "
          "PATH`; regenerate, do not hand-edit -->\n")


def _table(lines: list, results, skipped: str) -> None:
    if results is None:
        lines.append(f"(skipped: {skipped})")
    else:
        bad = [r for r in results if not r.ok]
        lines += [f"- checks: {len(results)}, failing: **{len(bad)}**", "",
                  "| entry | check | status |", "|---|---|---|"]
        for r in results:
            status = "ok" if r.ok else f"**FAIL** — {r.detail}"
            lines.append(f"| {r.entry} | {r.check} | {status} |")
    lines.append("")


def render_report(findings: list[Finding], trace_results=None, paths=None,
                  lock_graph=None, mem_results=None, numerics_results=None,
                  plans=None) -> str:
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    lines = [HEADER, "# graftlint report (PyTorch port)", ""]
    if paths:
        lines += [f"Scope: `{'`, `'.join(paths)}`", ""]
    lines += ["## Pass 1 + Pass 3: AST lint (rules + concurrency)", "",
              f"- findings: **{len(active)}**",
              f"- audited suppressions in force: {len(suppressed)}", ""]
    if active:
        lines += ["| where | rule | finding |", "|---|---|---|"]
        lines += [f"| `{f.path}:{f.line}` | {f.rule.id} ({f.rule.name}) | "
                  f"{f.message} |" for f in active]
        lines.append("")
    if suppressed:
        lines += ["### Audited exceptions", "", "| where | rule | reason |",
                  "|---|---|---|"]
        lines += [f"| `{f.path}:{f.line}` | {f.rule.id} ({f.rule.name}) | "
                  f"{f.suppress_reason} |" for f in suppressed]
        lines.append("")
    lines += ["## Pass 3: lock-order graph", ""]
    if lock_graph is None:
        lines.append("(skipped: --no-concurrency)")
    else:
        edges = sorted((u, v, site) for (u, v), site
                       in lock_graph.edges.items())
        lines.append(f"- locks: {len(lock_graph.locks)}; ordering edges: "
                     f"{len(edges)}")
        if edges:
            lines += ["", "| held | acquired | first site |", "|---|---|---|"]
            lines += [f"| `{u}` | `{v}` | `{p}:{n}` |"
                      for u, v, (p, n) in edges]
    lines += ["", "## Pass 2: trace invariants", ""]
    _table(lines, trace_results, "--no-trace")
    lines += ["## Pass 4: memory planner (GL013-GL015)", ""]
    _table(lines, mem_results, "--no-memplan or --no-trace")
    if plans:
        lines += ["| entry | peak bytes | top-3 contributors |",
                  "|---|---|---|"]
        lines += [f"| {p.entry} | {p.peak_bytes} | "
                  f"{', '.join(label for label, _ in p.contributors[:3])} |"
                  for p in plans]
        lines.append("")
    lines += ["## Pass 5: numerics (GL016-GL018)", ""]
    _table(lines, numerics_results, "--no-numerics or --no-trace")
    lines += ["## Rules", "", "| id | name | guards against |",
              "|---|---|---|"]
    lines += [f"| {r.id} | {r.name} | {r.summary} |" for r in RULES.values()]
    lines.append("")
    return "\n".join(lines)
