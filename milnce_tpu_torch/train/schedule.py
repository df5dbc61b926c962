"""LR schedule (port of ``milnce_tpu/train/schedule.py``).

Cosine with linear warmup, as the reference (utils.py:26-38): warmup over
``num_warmup_steps``, then ``max(0, 0.5 * (1 + cos(pi * num_cycles * 2 *
progress)))``, stepped per batch.  One formula: on a Python number it is
evaluated in Python floats (the loop's LR display), on a 0-d tensor on
the device in the count's float type with the same operations (the optimizer's lr, ``train/state.py::DeviceLR``), so the
step reads it with no host sync.
"""

from __future__ import annotations

import math

import torch

from milnce_tpu_torch.config import OptimConfig


def cosine_with_warmup(base_lr: float, num_warmup_steps: int,
                       num_training_steps: int, num_cycles: float = 0.5):
    def schedule(step):
        if torch.is_tensor(step):
            if not step.is_floating_point():
                step = step.float()
            warm = base_lr * step / max(1.0, num_warmup_steps)
            progress = (step - num_warmup_steps) / max(
                1.0, num_training_steps - num_warmup_steps)
            decay = base_lr * torch.clamp(0.5 * (1.0 + torch.cos(
                math.pi * num_cycles * 2.0 * progress)), min=0.0)
            return torch.where(step < num_warmup_steps, warm, decay)
        step = float(step)
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(
            1.0, num_training_steps - num_warmup_steps)
        return base_lr * max(
            0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def build_schedule_total(cfg: OptimConfig, total_steps: int):
    """``step -> lr`` over an explicit run-total step count."""
    return cosine_with_warmup(cfg.lr, cfg.warmup_steps, total_steps,
                              cfg.num_cycles)


def build_schedule(cfg: OptimConfig, steps_per_epoch: int):
    return build_schedule_total(cfg, steps_per_epoch * cfg.epochs)
