"""qwen1.5-32b [dense]: 64L d=5120 40H (kv=40) d_ff=27392 vocab=152064.

QKV bias (Qwen signature) [hf:Qwen/Qwen1.5 family]. Full 40-head MHA
gives the largest decode KV cache of the pool per token, which is why it
is stored int8-quantized, with a float32 scale per token and head. The
smoke config keeps the reference's ``kv_cache_dtype="auto"``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab=152064,
        qkv_bias=True, norm="rms", act="swiglu", rope_theta=1000000.0,
        dtype="bfloat16", kv_cache_dtype="int8", attn_sharding="sp",
    ),
    train=TrainPolicy(microbatches=8, fsdp=False, zero2=True),
    shape_skips=("long_500k",),
    skip_reason="full quadratic attention: 512k decode KV infeasible",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=2, d_model=80, n_heads=5, n_kv_heads=5,
            d_ff=192, vocab=500, dtype="float32", kv_cache_dtype="auto",
            q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
