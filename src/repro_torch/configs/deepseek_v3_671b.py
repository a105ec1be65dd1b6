"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, expert d_ff=2048,
MoE 1 shared + 256 routed top-8, MTP [arXiv:2412.19437].

MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v=128 — the KV
cache stores only the 576-dim latent per token. Routing is sigmoid-scored
with a selection-only bias (aux-loss-free balancing hook). One extra MTP
block predicts token t+2 through the shared head (weight 0.3 in the loss).
The reference trains it with Adafactor and 16 microbatches.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, MLAConfig, ModelConfig,
                                      MoEConfig, TrainPolicy)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab=129280,
        norm="rms", act="swiglu", rope_theta=10000.0,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                      n_shared=1, d_ff_shared=2048,
                      scoring="sigmoid", norm_topk=True, pad_multiple=0),
        mtp=True,
        dtype="bfloat16",
    ),
    train=TrainPolicy(microbatches=16, fsdp=True, optimizer="adafactor"),
    shape_skips=("long_500k",),
    skip_reason="full quadratic (latent) attention: 512k decode skipped",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=64, vocab=500,
            mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                          qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                          n_shared=1, d_ff_shared=64,
                          scoring="sigmoid", norm_topk=True, pad_multiple=0,
                          n_groups=4),
            dtype="float32", q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
