"""Shared pieces of the port's emulated-GEMM kernels.

``Blocks`` is the tile plan the dispatcher caches and hands to a
backend. The truncate-subtract recurrence of the reference's
``carve_slices`` lives once in ``repro_torch.core.scheme1.carve``; the
CUDA kernels mirror it element by element (``csrc/scheme1_common.cuh``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Blocks:
    bm: int
    bn: int
    bk: int

    def aligned(self, m: int, n: int, k: int) -> bool:
        return m % self.bm == 0 and n % self.bn == 0 and k % self.bk == 0
