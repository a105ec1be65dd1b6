"""Architecture registry of the port: ``--arch <id>`` -> ArchConfig.

Ported: olmo-1b, olmo-1b-emu (olmo-1b with its GEMM sites under Scheme I
and Scheme II), granite-3-8b and deepseek-coder-33b (dense GQA
decoders), qwen1.5-32b (dense MHA with QKV bias and an int8 KV cache),
qwen2-moe-a2.7b and qwen2-moe-a2.7b-emu (softmax top-4 MoE with gated
shared experts), recurrentgemma-2b (RG-LRU blocks and local attention
over a ring-buffer KV cache, (rec, rec, attn) x 8 + (rec, rec)),
mamba2-780m (Mamba-2 SSD blocks), internvl2-1b (a decoder behind the
vision stub: projected patch embeddings over the first tokens) and
hubert-xlarge (a bidirectional encoder behind the audio stub: projected
frame embeddings) and deepseek-v3-671b (MLA attention over a latent KV
cache, sigmoid-routed top-8 MoE with a shared expert, multi-token
prediction, Adafactor): every id of the reference's registry.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (ALL_SHAPES, ArchConfig,  # noqa: F401
                                      ModelConfig, ShapeSpec, TrainPolicy)

ARCH_IDS = ("granite-3-8b", "deepseek-coder-33b", "olmo-1b", "olmo-1b-emu",
            "qwen1.5-32b", "qwen2-moe-a2.7b", "qwen2-moe-a2.7b-emu",
            "recurrentgemma-2b", "mamba2-780m", "internvl2-1b",
            "hubert-xlarge", "deepseek-v3-671b")

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()
