"""deepseek-coder-33b [dense]: 62L d=7168 56H (GQA kv=8) d_ff=19200
vocab=32256. Llama-architecture decoder [arXiv:2401.14196].
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=19200, vocab=32256,
        norm="rms", act="swiglu", rope_theta=100000.0,
        dtype="bfloat16", attn_sharding="sp",
    ),
    train=TrainPolicy(microbatches=8, fsdp=False, zero2=True),
    shape_skips=("long_500k",),
    skip_reason="full quadratic attention: 512k decode KV infeasible",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
            d_ff=192, vocab=500, dtype="float32",
            q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
