"""Optimizers, schedules and gradient clipping of the port
(``repro.optim``), over trees of tensors."""

from repro_torch.optim.optimizers import (  # noqa: F401
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    warmup_cosine,
)
