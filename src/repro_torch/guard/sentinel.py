"""Input sentinels: special-value probes and NaN/Inf masking
(``repro.guard.sentinel``).

Ozaki decompositions are integer pipelines — a NaN or Inf operand entry
does not propagate, it truncates into garbage int8 slices and the GEMM
returns a *finite wrong number*.  Native ``torch.matmul`` propagates: any
non-finite entry in row i of A (or column j of B) makes the whole output
row i (column j) NaN — Inf included, because the emulated product cannot
distinguish +Inf·0 from +Inf·x, so (like LAPACK) every non-finite
contamination maps to NaN.

The guard restores that contract *around* the kernels: operands are
sanitized (non-finite entries zeroed) before dispatch so the integer
pipeline sees finite data, and the affected output rows/columns are
masked to NaN afterwards with one ``torch.where``.  The kernels stay
untouched, and when the mask is empty the sanitize/mask pair is the
identity (``where`` with an all-false mask returns the original bits).

``probe_operands`` also estimates the per-row exponent spread
(log2(max|row|) - log2(min nonzero |row|)): rows wider than the
decomposition captures lose their small entries to the power-of-two row
scale, which is what the a posteriori verifier (``guard.verify``) exists
to catch — the probe is the cheap leading indicator.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SentinelProbe:
    """Result of the pre-dispatch operand probe (tensors on the operands'
    device, so the probe itself adds no synchronization).

    row_mask: (M,) bool — rows of A containing a non-finite entry.
    col_mask: (N,) bool — columns of B containing a non-finite entry.
    spread_a / spread_b: () float32 — max per-row (per-col) exponent
      spread estimate in bits, 0 for empty/zero operands.
    """
    row_mask: torch.Tensor
    col_mask: torch.Tensor
    spread_a: torch.Tensor
    spread_b: torch.Tensor

    def any_nonfinite(self) -> torch.Tensor:
        return torch.any(self.row_mask) | torch.any(self.col_mask)


def _frexp_exponent(x: torch.Tensor) -> torch.Tensor:
    """frexp's exponent (exact on subnormals, unlike log2); the 16-bit
    types through float32, which holds them exactly."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return torch.frexp(x).exponent


def exponent_spread(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Max over rows of log2(max|row|) - log2(min nonzero |row|), in bits.

    Non-finite entries are ignored (they are sanitized away before the
    decomposition ever sees them).  Rows with <= 1 distinct magnitude
    contribute 0.
    """
    ax = torch.abs(x)
    finite = torch.isfinite(ax) & (ax > 0)
    hi = torch.amax(torch.where(finite, ax, torch.zeros_like(ax)), dim=axis)
    lo = torch.amin(torch.where(finite, ax, torch.full_like(ax, torch.inf)),
                    dim=axis)
    ok = (hi > 0) & torch.isfinite(lo)
    one = torch.ones_like(hi)
    e_hi = _frexp_exponent(torch.where(ok, hi, one))
    e_lo = _frexp_exponent(torch.where(ok, lo, one))
    spread = torch.where(ok, (e_hi - e_lo).to(torch.float32),
                         torch.zeros((), dtype=torch.float32, device=x.device))
    if spread.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.amax(spread)


def probe_operands(a: torch.Tensor, b: torch.Tensor) -> SentinelProbe:
    """Cheap pre-dispatch probe: O(MK + KN) elementwise + reductions."""
    return SentinelProbe(
        row_mask=~torch.all(torch.isfinite(a), dim=-1),
        col_mask=~torch.all(torch.isfinite(b), dim=0),
        spread_a=exponent_spread(a, axis=-1),
        spread_b=exponent_spread(b, axis=0),
    )


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """Zero the non-finite entries so the integer pipeline sees finite
    data.  Identity (bit-for-bit) on fully finite input."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def zero_masked_rows(x: torch.Tensor, mask: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Zero whole rows (axis=0) / columns (axis=1) flagged by ``mask`` —
    used by the verifier so masked lanes contribute nothing to either
    side of the residual."""
    shape = [1, 1]
    shape[axis] = x.shape[axis]
    return torch.where(mask.reshape(shape), torch.zeros_like(x), x)


def apply_special_values(c: torch.Tensor, probe: SentinelProbe) -> torch.Tensor:
    """Post-hoc mask: NaN the output rows/columns native matmul would
    have NaN'd.  One fused ``where`` — bit-identity when no entry is
    masked."""
    mask = probe.row_mask[:, None] | probe.col_mask[None, :]
    return torch.where(mask, torch.full((), torch.nan, dtype=c.dtype,
                                        device=c.device), c)
