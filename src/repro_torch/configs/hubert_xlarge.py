"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional), LayerNorm, GELU FFN, same backbone as
wav2vec 2.0 [arXiv:2106.07447]. The convolutional waveform frontend is a
stub: ``data.pipeline`` provides precomputed 512-dim frame embeddings.
Encoder-only => no decode step (decode_32k / long_500k cells skipped).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ModelConfig, TrainPolicy

CONFIG = ArchConfig(
    model=ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504,
        norm="layernorm", act="gelu", causal=False, qkv_bias=True,
        frontend="audio_stub", frontend_dim=512,
        dtype="bfloat16",
    ),
    train=TrainPolicy(microbatches=2, fsdp=False),
    shape_skips=("decode_32k", "long_500k"),
    skip_reason="encoder-only: no autoregressive decode step exists",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        model=dataclasses.replace(
            CONFIG.model, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=128, frontend_dim=32, dtype="float32",
            q_chunk=64, kv_chunk=64),
        train=TrainPolicy(microbatches=1))
