"""olmo-1b-emu [dense]: olmo-1b with the paper's emulated-GEMM site
policy shipped in the config instead of CLI flags.

Dense projections (attention/FFN/logits) run Scheme I at p=4 with cached
weight decomposition, while the attention score contraction uses Scheme
II with 6 moduli (the narrow-K shape where modular slices beat mantissa
slices). The weighted-value contraction stays on plain Scheme I (its
operand is a fresh softmax output every step, so ``+cached`` would never
hit).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import olmo_1b
from repro_torch.configs.base import ArchConfig

_SITES = (
    ("default", "ozaki1-p4+cached"),
    ("attn_qk", "ozaki2-m6"),
    ("attn_av", "ozaki1-p4"),
)

CONFIG = dataclasses.replace(
    olmo_1b.CONFIG,
    model=dataclasses.replace(olmo_1b.CONFIG.model, name="olmo-1b-emu"),
    gemm_sites=_SITES,
)


def smoke() -> ArchConfig:
    base = olmo_1b.smoke()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, name="olmo-1b-emu"),
        gemm_sites=_SITES,
    )
