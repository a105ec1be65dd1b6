"""Analytical HBM-traffic models of the paper (``repro.core.traffic``).

The port keeps the four fused models that the telemetry's modeled bytes
read (``telemetry.record.modeled_gemm_bytes``): paper Eqs. 10, 15 and 18.
All results in bytes; ``out_bytes`` is the output element size (4 =
float32, 8 = float64). The naive models, the flop counts and the
roofline helpers of the reference module are ROADMAP.md § 1 item 7.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GemmShape:
    m: int
    n: int
    k: int


def scheme1_fused_bytes(s: GemmShape, p: int, out_bytes: int = 8) -> int:
    """Paper Eq. 10: each slice loaded once; accumulators never leave chip."""
    return p * (s.m + s.n) * s.k + out_bytes * s.m * s.n


def scheme2_fused_bytes_per_modulus(s: GemmShape) -> int:
    """Paper Eq. 15: in-epilogue mod reduce — only the INT8 residue leaves."""
    return (s.m + s.n) * s.k + s.m * s.n


def scheme2_3m_fused_bytes_per_modulus(s: GemmShape) -> int:
    """Paper Eq. 18: the 24MN intermediate term vanishes."""
    return 3 * (s.m + s.n) * s.k + 2 * s.m * s.n
