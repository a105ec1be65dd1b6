"""mamba2-780m [ssm]: 48L d=1536 attn-free, vocab=50280, ssm_state=128 —
SSD state-space duality [arXiv:2405.21060].

Every block is a Mamba-2 SSD mixer (no attention, no separate FFN).
Decode state is O(1) per layer, so this arch runs the long_500k cell.
Intra-chunk SSD compute is all matmuls; the emulated-GEMM backend
applies to the projections, and chunk-level GEMMs are small enough
that emulation overhead is documented as unattractive (the reference's
DESIGN.md, §Arch-applicability).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, SSDConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=50280,
        norm="rms", act="swiglu",
        block_pattern=("ssd",),
        ssd=SSDConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                      chunk=256),
        tie_embeddings=True,
        sub_quadratic=True,
        dtype="bfloat16",
    ),
    train=TrainPolicy(microbatches=2, fsdp=False),
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=3, d_model=64, vocab=500,
            ssd=SSDConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                          chunk=32),
            dtype="float32", q_chunk=32, kv_chunk=32),
        train=TrainPolicy(microbatches=1))
