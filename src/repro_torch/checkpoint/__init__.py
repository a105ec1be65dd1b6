"""Atomic checkpoints of the port (``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
