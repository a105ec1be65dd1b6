"""qwen2-moe-a2.7b-emu [moe]: qwen2-moe-a2.7b with a per-site emulated-
GEMM policy shipped in the config.

The grouped expert matmuls are the dominant FLOP sink and run Scheme I
at p=4 — their (E, G*C, d) stacks are exactly the strided-batched fused
path this config exercises — while the router stays on Scheme II
(tiny K, exactness matters for top-k stability) and the dense
projections default to cached Scheme I. The gating/combine one-hot
einsums stay native: their operands are exact 0/1 masks.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen2_moe_a2_7b
from repro_torch.configs.base import ArchConfig

_SITES = (
    ("default", "ozaki1-p4+cached"),
    ("moe_expert", "ozaki1-p4"),
    ("moe_gate", "ozaki2-m6"),
    ("attn_qk", "ozaki2-m6"),
    ("attn_av", "ozaki1-p4"),
)

CONFIG = dataclasses.replace(
    qwen2_moe_a2_7b.CONFIG,
    model=dataclasses.replace(qwen2_moe_a2_7b.CONFIG.model,
                              name="qwen2-moe-a2.7b-emu"),
    gemm_sites=_SITES,
)


def smoke() -> ArchConfig:
    base = qwen2_moe_a2_7b.smoke()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, name="qwen2-moe-a2.7b-emu"),
        gemm_sites=_SITES,
    )
