"""olmo-1b [dense]: 16L d=2048 16H (kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (no scale/bias), SwiGLU, tied embeddings
[arXiv:2402.00838].
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304,
        norm="nonparam", act="swiglu", tie_embeddings=True,
        dtype="bfloat16",
    ),
    train=TrainPolicy(microbatches=1, fsdp=False),
    shape_skips=("long_500k",),
    skip_reason="full quadratic attention: 512k decode KV infeasible",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=128, vocab=500, dtype="float32",
            q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
