"""Elastic training: preemption-aware drain, resume at another world
size, and the straggler policy (port of ``milnce_tpu/elastic/``).

- **drain** (:mod:`milnce_tpu_torch.elastic.drain`): a preemption signal
  (SIGTERM, a drain signal file, or the ``host.preempt`` fault site)
  finishes the in-flight optimizer step, forces a rotation checkpoint,
  writes the versioned ``ELASTIC_STAMP.json`` sidecar, and exits with a
  distinct "drained" status (``DRAINED_EXIT_CODE``, EX_TEMPFAIL: rerun
  with ``--train.resume true``).
- **resume at another world size** (:mod:`milnce_tpu_torch.elastic.stamp`):
  data-parallel parameters are whole on every rank, so nothing reshards;
  the plan cursor (``plan.locate``) is world-independent, so the data
  stream never skips or repeats a batch.  Indivisible batches and
  schedule-removed resumes refuse loudly.
- **straggler policy** (:mod:`milnce_tpu_torch.elastic.straggler`): the
  cross-rank step-time skew feeds a live policy that emits ``straggler``
  events, demotes a persistently slow rank in the goodput ledger, and
  (behind a knob) recommends a drain-and-resize.
"""

from milnce_tpu_torch.elastic.drain import DRAINED_EXIT_CODE, DrainController
from milnce_tpu_torch.elastic.stamp import (ELASTIC_STAMP_NAME,
                                            check_topology_resume,
                                            read_elastic_stamp,
                                            write_elastic_stamp)
from milnce_tpu_torch.elastic.straggler import StragglerPolicy

__all__ = [
    "DRAINED_EXIT_CODE", "DrainController", "ELASTIC_STAMP_NAME",
    "check_topology_resume", "read_elastic_stamp", "write_elastic_stamp",
    "StragglerPolicy",
]
