"""Deterministic synthetic data of the port (``repro.data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMDataset,
    make_batch_iterator,
)
