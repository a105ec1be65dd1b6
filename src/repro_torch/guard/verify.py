"""A posteriori verification of emulated GEMM results
(``repro.guard.verify``).

``verify_gemm`` is the stochastic residual check of the
guaranteed-accuracy Ozaki literature (Schwarz et al., PAPERS.md): instead
of recomputing C = A B at higher precision (a full second GEMM), compare

    C @ x   vs   A @ (B @ x)

for a handful of +-1 (Rademacher) probe vectors x.  Both sides are
matrix-vector products — O(r (MN + MK + KN)) flops for r probes versus
O(p^2 MNK) for the emulated GEMM itself — and any corruption of C that is
not orthogonal to all r probes shows up as a residual far above the
decomposition's analytic error bound.

The tolerance is *derived, not tuned*: the decomposition residual bound
(2^(1-bits) relative, bits from ``EmulationConfig.bits``) plus the
float32 rounding of the verification matvecs themselves, normalized per
output row by a bound that majorizes both the row-scaled Scheme-I
residual structure and the magnitude of C's row.

Two deliberate differences from the reference, neither of which moves a
verdict: the probe vectors come from a ``torch.Generator`` seeded with
``seed`` (the reference draws them from ``jax.random``; the residual's
``err`` therefore differs in its low bits), and the matvecs run in full
float32 whatever the process's TF32 setting is (``torch.matmul`` on the
card would otherwise follow it). B enters the matvec in row chunks of at
most ``CHUNK_ELEMENTS``, so a bfloat16 weight is never copied whole to
float32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.precision import EmulationConfig

# Elements of B converted to float32 at a time (64 MB).
CHUNK_ELEMENTS = 1 << 24

_PROBES: dict = {}


@dataclasses.dataclass(frozen=True)
class VerifyResult:
    """Outcome of one stochastic residual check (tensors on the operands'
    device: reading ``ok`` or ``err`` on the host is the sync)."""
    ok: torch.Tensor     # () bool — max normalized residual <= tol
    err: torch.Tensor    # () float32 — max_i |C x - A (B x)|_i / den_i
    tol: float           # the analytic threshold the residual is held to

    def __bool__(self) -> bool:  # eager convenience: `if verify_gemm(...):`
        return bool(self.ok)


def tolerance(bits: int, m: int, n: int, k: int,
              tol_factor: float = 16.0) -> float:
    """Analytic trip threshold for a ``bits``-bit emulated (M,K)@(K,N).

    2^(1-bits): the decomposition's relative residual (one doubling of the
    elementwise bound to cover both operands).  (k + n) * eps: accumulated
    float32 rounding of the two verification matvec chains.
    ``tol_factor`` is the safety margin on top.
    """
    eps = float(torch.finfo(torch.float32).eps)
    return float(tol_factor) * (2.0 ** (1 - bits) + (k + n) * eps)


def rademacher(n: int, probes: int, seed: int, device) -> torch.Tensor:
    """(n, probes) float32 +-1 from a ``torch.Generator`` seeded with
    ``seed``, drawn on the host and kept per device."""
    key = (n, probes, seed, str(device))
    x = _PROBES.get(key)
    if x is None:
        gen = torch.Generator().manual_seed(seed)
        x = (torch.randint(0, 2, (n, probes), generator=gen) * 2 - 1).to(
            dtype=torch.float32, device=device)
        if len(_PROBES) >= 256:
            _PROBES.pop(next(iter(_PROBES)))
        _PROBES[key] = x
    return x


@contextlib.contextmanager
def full_float32():
    """float32 matmuls in full float32 (no TF32) for the scope."""
    prev = torch.get_float32_matmul_precision()
    if prev != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev != "highest":
            torch.set_float32_matmul_precision(prev)


def _b_side(b: torch.Tensor, x: torch.Tensor, col_mask):
    """B @ x, sum |B| and sum_j max_k |B_kj| of float32 B (masked columns
    zeroed), B taken ``CHUNK_ELEMENTS`` a batch element at a time; B is
    (K, N) or (Bt, K, N), the sums () or (Bt,)."""
    k, n = b.shape[-2:]
    lead = tuple(b.shape[:-2])
    rows = max(1, CHUNK_ELEMENTS // max(n, 1))
    bx = torch.empty(lead + (k, x.shape[1]), dtype=torch.float32,
                     device=b.device)
    sum_b = torch.zeros(lead, dtype=torch.float32, device=b.device)
    col_max = torch.zeros(lead + (n,), dtype=torch.float32, device=b.device)
    for r0 in range(0, k, rows):
        bc = b[..., r0:r0 + rows, :].to(torch.float32)
        if col_mask is not None:
            bc = torch.where(col_mask[..., None, :], 0.0, bc)
        bx[..., r0:r0 + rows, :] = bc @ x
        abs_b = torch.abs(bc)
        sum_b += abs_b.sum(dim=(-2, -1))
        col_max = torch.maximum(col_max, torch.amax(abs_b, dim=-2))
    return bx, sum_b, col_max.sum(dim=-1)


def _err(a, b, c, probes, seed, row_mask, col_mask) -> torch.Tensor:
    """max_i |C x - A (B x)|_i / den_i (module doc) of (M, K) @ (K, N),
    or per element of a (Bt, ...) batch, masked lanes zeroed."""
    m, n = a.shape[-2], b.shape[-1]
    a = a.to(torch.float32)
    c = c.to(torch.float32)
    if row_mask is not None:
        a = torch.where(row_mask[..., :, None], 0.0, a)
        c = torch.where(row_mask[..., :, None], 0.0, c)
    if col_mask is not None:
        c = torch.where(col_mask[..., None, :], 0.0, c)
    x = rademacher(n, probes, seed, a.device)
    with full_float32():
        bx, sum_b, sum_col_max_b = _b_side(b, x, col_mask)
        lhs = c @ x                    # (..., M, r)
        rhs = a @ bx                   # (..., M, r) — never forms A @ B
    resid = torch.amax(torch.abs(lhs - rhs), dim=-1)     # (..., M)
    abs_a = torch.abs(a)
    tiny = torch.finfo(torch.float32).tiny
    den = (torch.amax(abs_a, dim=-1) * sum_b[..., None]
           + abs_a.sum(dim=-1) * sum_col_max_b[..., None] + tiny)
    if not m:
        return torch.zeros(tuple(a.shape[:-2]), dtype=torch.float32,
                           device=a.device)
    return torch.amax(resid / den, dim=-1)


def _bits(cfg, bits, k):
    if bits is not None:
        return bits
    if cfg is not None:
        return EmulationConfig.parse(cfg).bits(k)
    return 24  # fp32-mantissa default when nothing else is known


def verify_gemm(a: torch.Tensor, b, c: torch.Tensor,
                cfg: "EmulationConfig | str | None" = None, *,
                bits: int | None = None, probes: int = 2,
                tol_factor: float = 16.0, seed: int = 0,
                row_mask: torch.Tensor | None = None,
                col_mask: torch.Tensor | None = None) -> VerifyResult:
    """Stochastic residual check of an emulated 2-D GEMM result.

    Args:
      a, b: the operands of the emulated product (b may be a prepared
        operand — ``PreparedOperand`` / ``PreparedResidues`` — whose dense
        form is recovered via ``.reconstruct()``).
      c: the emulated result to verify.
      cfg: the EmulationConfig (or spec string) that produced ``c`` — sets
        the error-bound bits via ``cfg.bits(K)``.
      bits: explicit precision bits; overrides ``cfg``.
      probes: number of Rademacher probe vectors.
      seed: seeds the ``torch.Generator`` the probes come from.
      row_mask / col_mask: NaN/Inf sentinel masks (``guard.sentinel``) —
        masked lanes of a/b/c are zeroed on both sides of the residual so
        special-value handling never trips the check.
    """
    if hasattr(b, "reconstruct"):
        b = b.reconstruct()
    m, k = a.shape
    n = b.shape[1]
    err = _err(a, b, c, probes, seed, row_mask, col_mask)
    tol = tolerance(_bits(cfg, bits, k), m, n, k, tol_factor)
    return VerifyResult(ok=err <= tol, err=err, tol=tol)


def verify_batched(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   cfg: "EmulationConfig | str | None" = None, *,
                   probes: int = 2, tol_factor: float = 16.0, seed: int = 0,
                   row_mask: torch.Tensor | None = None,
                   col_mask: torch.Tensor | None = None) -> VerifyResult:
    """:func:`verify_gemm` of each element of a (Bt, M, K) @ (Bt, K, N)
    batch at once, with the same probe vectors for every element (the
    reference's vmap of the 2-D check): ``ok`` and ``err`` are (Bt,),
    the masks (Bt, M) and (Bt, N)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    err = _err(a, b, c, probes, seed, row_mask, col_mask)
    tol = tolerance(_bits(cfg, None, k), m, n, k, tol_factor)
    return VerifyResult(ok=err <= tol, err=err, tol=tol)
