"""Fault-tolerant training runtime (port of ``milnce_tpu/resilience/``):
deterministic fault injection driving the recovery machinery it
exercises (decode watchdog, bounded resample, finite-update guard,
checkpoint save retry)."""

from milnce_tpu_torch.resilience.faults import (FaultRegistry, InjectedFault,
                                                arm, armed, device_schedule,
                                                disarm, maybe_hang,
                                                maybe_raise)

__all__ = ["FaultRegistry", "InjectedFault", "arm", "armed",
           "device_schedule", "disarm", "maybe_hang", "maybe_raise"]
