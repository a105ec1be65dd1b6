"""granite-3-8b [dense]: 40L d=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

GQA decoder, SwiGLU, RMSNorm [hf:ibm-granite/granite-3.0-8b-base family].
Full attention => long_500k skipped.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab=49155,
        norm="rms", act="swiglu", rope_theta=10000.0,
        dtype="bfloat16", attn_sharding="sp",
    ),
    train=TrainPolicy(microbatches=4, fsdp=False, zero2=True),
    shape_skips=("long_500k",),
    skip_reason="full quadratic attention: 512k decode KV infeasible",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=160, vocab=503, dtype="float32",
            q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
