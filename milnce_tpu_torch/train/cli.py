"""Training entry point: ``python -m milnce_tpu_torch.train.cli --preset
tiny|small|full [--section.field value ...]`` (the ``milnce-train-torch``
script).  Runs on the CUDA card unless ``--parallel.platform cpu``.

Data parallel over N cards of a host: ``torchrun --nproc_per_node N -m
milnce_tpu_torch.train.cli ...``; each rank joins an NCCL group from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and
trains on ``cuda:<LOCAL_RANK>``, ``train.batch_size`` being the global
batch.  Without torchrun, ``--parallel.coordinator_address host:port``
(or a ``tcp://`` / ``file://`` URL) with ``--parallel.num_processes`` and
``--parallel.process_id`` names the group."""

from __future__ import annotations

from milnce_tpu_torch.config import parse_cli
from milnce_tpu_torch.train.loop import run_training


def main(argv=None):
    cfg = parse_cli(argv, description="milnce-tpu-torch trainer")
    result = run_training(cfg)
    if result.rank == 0:
        print(f"done: {result.steps} steps, final loss "
              f"{result.last_loss:.4f}")


if __name__ == "__main__":
    main()
