"""Fault-tolerant training runtime of the port (``repro.runtime``)."""

from repro_torch.runtime.trainer import (  # noqa: F401
    FailureInjector,
    StragglerMonitor,
    Trainer,
)
