"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

InternLM2/Qwen2-0.5B-class LM backbone [arXiv:2404.16821]. The InternViT
vision tower is a stub: ``data.pipeline`` provides precomputed
1024-dim patch embeddings that are projected and placed at the
first ``n_image_tokens`` positions of the sequence.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151655,
        qkv_bias=True, norm="rms", act="swiglu", rope_theta=1000000.0,
        frontend="vision_stub", frontend_dim=1024, n_image_tokens=256,
        dtype="bfloat16", attn_sharding="sp",
    ),
    train=TrainPolicy(microbatches=1, fsdp=False, zero2=True),
    shape_skips=("long_500k",),
    skip_reason="full quadratic attention: 512k decode KV infeasible",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
            d_ff=112, vocab=500, frontend_dim=48, n_image_tokens=16,
            dtype="float32", q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
