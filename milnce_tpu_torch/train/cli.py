"""Training entry point: ``python -m milnce_tpu_torch.train.cli --preset
tiny|small|full [--section.field value ...]`` (the ``milnce-train-torch``
script).  Runs on the CUDA card unless ``--parallel.platform cpu``."""

from __future__ import annotations

from milnce_tpu_torch.config import parse_cli
from milnce_tpu_torch.train.loop import run_training


def main(argv=None):
    cfg = parse_cli(argv, description="milnce-tpu-torch trainer")
    result = run_training(cfg)
    print(f"done: {result.steps} steps, final loss {result.last_loss:.4f}")


if __name__ == "__main__":
    main()
