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

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from milnce_tpu_torch.config import Config
from milnce_tpu_torch.data.synthetic import BatchLoader, SyntheticVideoTextSource
from milnce_tpu_torch.losses.milnce_chunked import stream_on_kernels
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.ops.milnce_stream import STREAM_DMAX
from milnce_tpu_torch.train.schedule import build_schedule_total
from milnce_tpu_torch.train.state import build_optimizer
from milnce_tpu_torch.train.step import make_train_step


# Knobs of the reference loop that this loop does not read yet, as dotted
# names; a run that sets one away from its dataclass default is refused.
# A name leaves the table in the change that ports it.  Not here:
# train.skip_rollback_after, whose breaker is on by default in the
# reference; without a checkpoint to roll back to it halts, as here.
UNPORTED_KNOBS = (
    "train.resume", "train.checkpoint_dir", "train.pretrain_ckpt",
    "train.evaluate", "train.grad_accum", "train.faults",
    "train.curriculum", "train.trace_dir", "train.obs_dir",
    "train.capture_dir", "train.drain_signal_file", "parallel.model_axis",
    "parallel.model_parallel_size", "parallel.coordinator_address",
    "parallel.num_processes", "parallel.process_id")


def check_config(cfg: Config, device_type: str) -> None:
    """Refuse, before anything is built, what a run on ``device_type``
    would not honour: every knob of :data:`UNPORTED_KNOBS` set away from
    its default, and an embedding wider than the MIL-NCE stream kernels
    take when the loss would stream on them."""
    default = Config()
    unported = [name for name in UNPORTED_KNOBS
                if _knob(cfg, name) != _knob(default, name)]
    if unported:
        raise ValueError(f"not ported yet: {', '.join(unported)} (leave "
                         "them at their defaults)")
    if (cfg.loss.name == "milnce" and cfg.model.embedding_dim > STREAM_DMAX
            and stream_on_kernels(cfg.loss, cfg.train.batch_size,
                                  cfg.data.num_candidates, device_type)):
        raise ValueError(
            f"model.embedding_dim={cfg.model.embedding_dim}: the MIL-NCE "
            f"stream kernels take D <= {STREAM_DMAX}; use loss.milnce_impl "
            "dense")


def _knob(cfg: Config, name: str):
    section, field = name.split(".")
    return getattr(getattr(cfg, section), field)


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
    check_config(cfg, cfg.parallel.platform)
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

    # The finite guard's display window, as the JAX loop keeps it: a
    # skipped step's loss stays out of the sum and the count, a window
    # with no applied update has a NaN mean, and ``consec`` counts the
    # skipped steps since the last applied one, across windows.
    guard_on = cfg.train.finite_guard
    steps = skipped = window = valid = consec = 0
    running = torch.zeros((), device=device)
    last = torch.zeros((), device=device)
    tick = time.time()
    window_t0 = time.perf_counter()
    for epoch in range(cfg.optim.epochs):
        for video, text, start in loader.epoch(epoch):
            t0 = time.perf_counter()
            out = step_fn(video, text, start)
            last, skip = out if guard_on else (out, 0)
            skipped += skip
            if skip:
                consec += 1
            else:
                running += last
                valid += 1
                consec = 0
            steps += 1
            window += 1
            if on_step is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                on_step(steps, time.perf_counter() - t0, float(last))
            if window == cfg.train.n_display or steps == max_steps:
                mean_loss = float(running) / valid if valid else math.nan
                elapsed = time.perf_counter() - window_t0
                progress = ((steps - 1) % steps_per_epoch + 1) / steps_per_epoch
                log(f"Epoch {epoch + 1}, Elapsed Time: "
                    f"{time.time() - tick:.3f}, Epoch status: "
                    f"{progress:.4f}, Training loss: {mean_loss:.4f}, "
                    f"Learning rate: {schedule(steps):.6f}, Throughput: "
                    f"{window * cfg.train.batch_size / elapsed:.1f} clips/s")
                # A guarded window with no applied update is NaN by
                # construction: that is the breaker's case, not the
                # divergence halt's.  The reference also saves a
                # post-mortem checkpoint before it halts; that waits for
                # checkpointing.
                if (cfg.train.halt_on_nan and not math.isfinite(mean_loss)
                        and not (guard_on and math.isnan(mean_loss))):
                    log(f"halting: non-finite training loss at step {steps}")
                    raise FloatingPointError(
                        f"training loss became non-finite ({mean_loss}) at "
                        f"step {steps}")
                # The breaker: the reference rolls the weights back to its
                # last rotation checkpoint, and halts when there is none.
                # The port keeps no checkpoint yet, so it always halts.
                if (guard_on and cfg.train.skip_rollback_after
                        and consec >= cfg.train.skip_rollback_after):
                    raise FloatingPointError(
                        f"{consec} consecutive non-finite updates at step "
                        f"{steps} and no rotation checkpoint to roll back "
                        "to - halting")
                running.zero_()
                window = valid = 0
                window_t0 = time.perf_counter()
            if steps >= max_steps:
                return TrainResult(steps, float(last), skipped, model)
    return TrainResult(steps, float(last), skipped, model)
