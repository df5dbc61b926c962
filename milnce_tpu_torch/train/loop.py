"""Training loop (a slim port of ``milnce_tpu/train/loop.py``).

Builds the model from the seed, draws synthetic batches, runs
``train.max_steps`` optimizer steps (or all epochs) and prints the JAX
loop's display line every ``n_display`` steps.  Checkpointing, resume,
goodput, curriculum, elastic drain, observability and real-video data
are not ported yet.

Precision: the JAX towers run in f32, so TF32 is switched off for both
cuDNN convolutions and CUDA matmuls before anything runs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from milnce_tpu_torch.config import Config
from milnce_tpu_torch.data.synthetic import BatchLoader, SyntheticVideoTextSource
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.train.schedule import build_schedule_total
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_train_step


@dataclass
class TrainResult:
    steps: int
    last_loss: float
    skipped_steps: int = 0      # finite-guard: updates dropped on
                                # non-finite gradients
    model: Optional[torch.nn.Module] = None


def disable_tf32() -> str:
    """Turn TF32 off for convolutions and matmuls; returns both flags as
    a printable line."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def resolve_device(platform: str) -> torch.device:
    """``parallel.platform`` -> torch device; 'cuda' refuses to run
    without a card instead of falling back to the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("parallel.platform=cuda but no CUDA device is "
                               "visible (use --parallel.platform cpu)")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown parallel.platform {platform!r} "
                     "(expected cuda | cpu)")


def run_training(cfg: Config, log: Callable[[str], None] = print,
                 on_step: Optional[Callable[[int, float, float], None]] = None
                 ) -> TrainResult:
    """Train for ``cfg.train.max_steps`` steps (None = every epoch).
    ``on_step(step, seconds, loss)`` is called after each step with the
    host time the step took, synchronized with the device, and its loss."""
    log(disable_tf32())
    device = resolve_device(cfg.parallel.platform)
    if not cfg.data.synthetic:
        raise NotImplementedError("the torch port trains on the synthetic "
                                  "source only (--data.synthetic true)")
    model = build_model(cfg.model, seed=cfg.train.seed).to(device)
    source = SyntheticVideoTextSource(cfg.data,
                                      vocab_size=cfg.model.vocab_size)
    loader = BatchLoader(source, cfg.train.batch_size, device,
                         seed=cfg.train.seed)
    steps_per_epoch = loader.steps_per_epoch()
    if steps_per_epoch == 0:
        raise ValueError(f"{len(source)} samples give no batch of "
                         f"{cfg.train.batch_size}")
    total = steps_per_epoch * cfg.optim.epochs
    schedule = build_schedule_total(cfg.optim, total)
    optimizer, lr_scheduler = build_optimizer(model, cfg.optim, schedule)
    step_fn = make_train_step(model, optimizer, cfg.loss,
                              finite_guard=cfg.train.finite_guard,
                              lr_scheduler=lr_scheduler)
    max_steps = cfg.train.max_steps or total
    log(f"device: {device} | global batch: {cfg.train.batch_size} | "
        f"steps: {max_steps}")

    steps = skipped = window = 0
    running = torch.zeros((), device=device)
    last = torch.zeros((), device=device)
    tick = time.time()
    window_t0 = time.perf_counter()
    for epoch in range(cfg.optim.epochs):
        for video, text, start in loader.epoch(epoch):
            t0 = time.perf_counter()
            out = step_fn(video, text, start)
            if cfg.train.finite_guard:
                last, skip = out
                skipped += skip
            else:
                last = out
            running += last
            steps += 1
            window += 1
            if on_step is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                on_step(steps, time.perf_counter() - t0, float(last))
            if window == cfg.train.n_display or steps == max_steps:
                mean_loss = float(running) / window
                elapsed = time.perf_counter() - window_t0
                progress = ((steps - 1) % steps_per_epoch + 1) / steps_per_epoch
                log(f"Epoch {epoch + 1}, Elapsed Time: "
                    f"{time.time() - tick:.3f}, Epoch status: "
                    f"{progress:.4f}, Training loss: {mean_loss:.4f}, "
                    f"Learning rate: {schedule(steps):.6f}, Throughput: "
                    f"{window * cfg.train.batch_size / elapsed:.1f} clips/s")
                if cfg.train.halt_on_nan and mean_loss != mean_loss:
                    log(f"halting: non-finite loss at step {steps}")
                    return TrainResult(steps, float(last), skipped, model)
                running.zero_()
                window = 0
                window_t0 = time.perf_counter()
            if steps >= max_steps:
                return TrainResult(steps, float(last), skipped, model)
    return TrainResult(steps, float(last), skipped, model)
