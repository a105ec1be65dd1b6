"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention in a 1:2 pattern
[arXiv:2402.19427 (Griffin)].

Block pattern (rec, rec, attn) x 8 + (rec, rec) = 26 layers. Attention is
local (window 2048) MQA, so decode caches are O(window): this arch runs
the long_500k cell. The RG-LRU recurrence itself is elementwise — the
paper's GEMM emulation applies to the block projections but not the scan
(the reference's DESIGN.md, §Arch-applicability).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, RGLRUConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256000,
        norm="rms", act="geglu", attn_window=2048,
        block_pattern=("rec", "rec", "attn"),
        rglru=RGLRUConfig(lru_width=2560, conv_kernel=4),
        sub_quadratic=True,
        dtype="bfloat16", attn_sharding="sp",
    ),
    train=TrainPolicy(microbatches=2, fsdp=False, zero2=True),
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
            d_ff=128, vocab=500, attn_window=32,
            rglru=RGLRUConfig(lru_width=64, conv_kernel=4),
            dtype="float32", q_chunk=32, kv_chunk=32),
        train=TrainPolicy(microbatches=1))
