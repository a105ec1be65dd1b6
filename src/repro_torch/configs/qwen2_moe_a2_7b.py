"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (kv=16) expert d_ff=1408,
MoE 60 routed top-4 + 4 gated shared experts [hf:Qwen/Qwen1.5-MoE-A2.7B].

Every layer is MoE. The 60 routed experts are padded to 64 so the expert
axis shards over the 16-way model axis (padding experts are routing-dead).
Shared experts total 4x1408 = 5632 hidden width with a learned sigmoid
gate.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, ModelConfig, MoEConfig,
                                      TrainPolicy)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=151936,
        qkv_bias=True, norm="rms", act="swiglu", rope_theta=1000000.0,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                      n_shared=4, d_ff_shared=5632, shared_gate=True,
                      scoring="softmax", norm_topk=False, pad_multiple=64),
        dtype="bfloat16",
    ),
    train=TrainPolicy(microbatches=2, fsdp=False),
    shape_skips=("long_500k",),
    skip_reason="full quadratic attention: 512k decode KV infeasible",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=96, vocab=500,
            moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=96,
                          n_shared=2, d_ff_shared=192, shared_gate=True,
                          scoring="softmax", norm_topk=False, pad_multiple=8,
                          n_groups=4),
            dtype="float32", q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
