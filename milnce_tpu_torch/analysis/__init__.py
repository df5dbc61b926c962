"""graftlint for the PyTorch port: static analysis of the source and of
op traces of the hot path, and the runtime lock sanitizer.

- :mod:`~milnce_tpu_torch.analysis.rules` — the catalogue GL000-GL018
  and the suppression syntax ``# graftlint: disable=GLnnn(reason)``;
- :mod:`~milnce_tpu_torch.analysis.astlint` — Pass 1, a pure-AST lint
  (no torch import);
- :mod:`~milnce_tpu_torch.analysis.concurrency` — Pass 3, the lock
  discipline of the serving and obs threads (GL010-GL012);
- :mod:`~milnce_tpu_torch.analysis.optrace` — the op trace (a
  ``TorchDispatchMode``), the port's program representation;
- :mod:`~milnce_tpu_torch.analysis.trace_invariants` — Pass 2, the
  registered entries' invariants;
- :mod:`~milnce_tpu_torch.analysis.memplan` — Pass 4, the peak of live
  bytes (GL013-GL015) and the what-if planner;
- :mod:`~milnce_tpu_torch.analysis.numerics` — Pass 5 (GL016-GL018);
- :mod:`~milnce_tpu_torch.analysis.lockrt` — the runtime lock sanitizer
  the serving modules create their locks through.

CLI: ``python -m milnce_tpu_torch.analysis [--check] [--no-trace] ...``.
"""

from milnce_tpu_torch.analysis.rules import RULES, Rule  # noqa: F401
