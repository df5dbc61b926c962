"""Training entry point: ``python -m milnce_tpu_torch.train.cli --preset
tiny|small|full [--section.field value ...]`` (the ``milnce-train-torch``
script).  Runs on the CUDA card unless ``--parallel.platform cpu``.

Data parallel over N cards of a host: ``torchrun --nproc_per_node N -m
milnce_tpu_torch.train.cli ...``; each rank joins an NCCL group from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and
trains on ``cuda:<LOCAL_RANK>``, ``train.batch_size`` being the global
batch.  Without torchrun, ``--parallel.coordinator_address host:port``
(or a ``tcp://`` / ``file://`` URL) with ``--parallel.num_processes`` and
``--parallel.process_id`` names the group.  The 2-D ``(data, model)``
layout adds ``--parallel.model_axis model --parallel.model_parallel_size
2`` (large parameters and their Adam moments sharded over pairs of
ranks; ``--parallel.fsdp_min_size``, ``--parallel.sharding_map``).

Exit status: 0 on completion; ``DRAINED_EXIT_CODE`` (75, EX_TEMPFAIL) on
every rank when the run drained (SIGTERM, ``--train.drain_signal_file``
or the ``host.preempt`` fault site): the checkpoint and both stamps are
on disk, and the orchestrator reruns with ``--train.resume true``, at
any world size that splits every stage's batch."""

from __future__ import annotations

from milnce_tpu_torch.config import parse_cli
from milnce_tpu_torch.elastic import DRAINED_EXIT_CODE
from milnce_tpu_torch.train.loop import run_training


def main(argv=None):
    cfg = parse_cli(argv, description="milnce-tpu-torch trainer")
    result = run_training(cfg)
    if result.drained:
        if result.rank == 0:
            print(f"drained: {result.steps} steps, final loss "
                  f"{result.last_loss:.4f} — checkpoint saved, resume with "
                  f"--train.resume true (exit {DRAINED_EXIT_CODE})")
        raise SystemExit(DRAINED_EXIT_CODE)
    if result.rank == 0:
        print(f"done: {result.steps} steps, final loss "
              f"{result.last_loss:.4f}")


if __name__ == "__main__":
    main()
