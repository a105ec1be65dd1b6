"""Ozaki Scheme II in PyTorch: CRT modular-arithmetic emulated GEMM.

The torch counterpart of ``repro.core.scheme2`` (paper Sec. II-C2):

  1. scale the operands to integers A' = trunc(diag(mu) A), mu a power
     of two, in the operand's own type;
  2. balanced residues A'_l = ((A' + m_l//2) mod m_l) - m_l//2 in int8,
     for p pairwise-coprime moduli m_l <= 256;
  3. one exact int8 GEMM per modulus into int32;
  4. C'_l = C_l mod m_l;
  5. CRT reconstruction by balanced Garner digits (exact int32) and a
     double-double Horner evaluation, rounded to the output type, then
     divided by mu * nu rounded to that type.

Every modulo is a floor modulo (``torch.remainder``, the sign of the
divisor, as ``jnp.remainder``). The reference picks its integer and
double-double types from the global x64 flag; the port states them
(ROADMAP.md § 3 H6): a float64 operand takes its residues through int64
and any other through int32, and a float64 output reconstructs in
float64 double-double and any other in float32. That is the reference's
arithmetic without x64 for float32 and bfloat16, and with x64 for
float64 (DGEMM-grade Scheme II). ``matmul`` is the plain version of the
fused EmuGEMM-II kernel (``repro_torch.kernels.ozaki2``) and what the
'torch' backend runs. ``balanced_residues`` hands its stack to the
guard's fault-injection hook (``guard.inject``), as in the reference.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core import dd
from repro_torch.core.precision import (EmulationAccuracyError,
                                        EmulationConfig, scheme2_budget)
from repro_torch.core.scheme1 import exact_pow2

# Operand types of the port's Scheme II, with their mantissa bits + 1
# (``jnp.finfo(dtype).nmant + 1``), which cap the integer budget, and
# their ``finfo.maxexp``, which caps the scales.
MANTISSA = {torch.float32: 24, torch.bfloat16: 8, torch.float64: 53,
            torch.float16: 11}
_MAXEXP = {torch.float32: 128, torch.bfloat16: 128, torch.float64: 1024,
           torch.float16: 16}
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float64, torch.float16)


def operand(x: torch.Tensor) -> torch.Tensor:
    """Floats keep their type (the whole integerize chain runs in it),
    other types become float32 (``gpu._float_or_f32``)."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if x.dtype not in MANTISSA:
        raise NotImplementedError(
            f"Scheme II takes float32, bfloat16, float16 or float64 operands "
            f"in the port, got {x.dtype}")
    return x


def budget_bits(moduli, k_dim: int, dtype: torch.dtype) -> int:
    """The shared integer budget: the CRT bound, capped at the lhs
    type's mantissa."""
    return min(scheme2_budget(moduli, k_dim), MANTISSA[dtype])


def _pow2_int_scale(a: torch.Tensor, axis: int,
                    budget_bits: int) -> torch.Tensor:
    """Power-of-two mu per row/col, in a's type, such that
    |trunc(mu * a)| < 2^budget_bits (mu * amax in [2^(budget-1),
    2^budget)); clamped below the type's overflow point, so that
    subnormal-only lines integerize to zeros."""
    amax = torch.amax(torch.abs(a), dim=axis, keepdim=True)
    if amax.dtype != torch.float64:
        amax = amax.float()          # exact; frexp takes no half type
    _, exp = torch.frexp(torch.where(amax == 0, torch.ones_like(amax), amax))
    e = torch.clamp(budget_bits - exp, max=_MAXEXP[a.dtype] - 1)
    return exact_pow2(e, a.dtype)


def integerize(a: torch.Tensor, axis: int, budget_bits: int):
    """A' = trunc(diag(mu) A), in a's type. Returns (a_int, mu)."""
    mu = _pow2_int_scale(a, axis, budget_bits)
    return torch.trunc(a * mu), mu


def balanced_residues(a_int: torch.Tensor, moduli) -> torch.Tensor:
    """(p, *a.shape) int8 balanced residues of an exact-integer float
    array, reduced in int64 for float64 (integers up to 2^53) and in
    int32 otherwise.

    A float16 array is the one whose finite operands can overflow their
    type: a float16 rhs integerized at a float32 lhs's budget (> 16
    bits) rounds to +-inf. Its conversion saturates, as XLA's does, and
    the + m // 2 below then wraps in int32 as the reference's does
    (ROADMAP.md § 3 R9)."""
    oversized = [int(m) for m in moduli if int(m) > 256]
    if oversized:
        raise ValueError(
            f"moduli {oversized} exceed 256: balanced residues must fit "
            "int8 — no backend lowers wider moduli")
    if a_int.dtype == torch.float16:
        a_int = a_int.double().clamp(-2 ** 31, 2 ** 31 - 1)
        ai = a_int.to(torch.int32)
    else:
        ai = a_int.to(torch.int64 if a_int.dtype == torch.float64
                      else torch.int32)
    outs = []
    for m in moduli:
        half = int(m) // 2
        outs.append((torch.remainder(ai + half, int(m)) - half)
                    .to(torch.int8))
    from repro_torch.guard.inject import maybe_corrupt_residues
    return maybe_corrupt_residues(torch.stack(outs))


def check_exact_k(k_dim: int, moduli) -> None:
    """Refuse contraction lengths whose int32 residue accumulation could
    wrap: K * (max m // 2)^2 must stay below 2^31 (K <= 131071 at
    m = 256)."""
    half = max(int(m) for m in moduli) // 2
    if k_dim * half * half >= 2 ** 31:
        k_max = (2 ** 31 - 1) // (half * half)
        raise EmulationAccuracyError(
            f"Scheme II: K={k_dim} can overflow the int32 residue "
            f"accumulators (bound K * {half}^2 < 2^31, i.e. K <= "
            f"{k_max} for these moduli). Remediation: re-plan with a "
            f"'bits=<N>:k{k_dim}' spec so plan_precision budgets the "
            "moduli for this contraction length, or split the contraction "
            f"so each part stays <= {k_max}.")


def residue_gemms(a_res: torch.Tensor, b_res: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 6: one exact int8 GEMM per modulus, (p, ..., M, N) int32.

    Each runs as a float64 matmul: every partial sum is an integer far
    below 2^53 (``check_exact_k``), so it is exact in any order."""
    acc = a_res.to(torch.float64) @ b_res.to(torch.float64)
    return acc.to(torch.int64).to(torch.int32)


def modular_reduce(acc: torch.Tensor, moduli) -> torch.Tensor:
    """Paper Eq. 7: C'_l = C_l mod m_l, into [0, m_l), int32."""
    return torch.stack([torch.remainder(acc[l], int(m))
                        for l, m in enumerate(moduli)]).to(torch.int32)


@lru_cache(maxsize=None)
def garner_constants(moduli: tuple[int, ...]) -> tuple[tuple[int, ...], ...]:
    """inv[i][j] = m_j^-1 mod m_i for j < i (Python ints; 0 elsewhere)."""
    p = len(moduli)
    return tuple(tuple(pow(moduli[j], -1, moduli[i]) if j < i else 0
                       for j in range(p)) for i in range(p))


def garner_digits(residues: torch.Tensor, moduli) -> list[torch.Tensor]:
    """Balanced mixed-radix digits d_i in [-m_i/2, m_i/2] with
    x = d_0 + m_0 (d_1 + m_1 (d_2 + ...)), in exact int32.
    ``residues``: (p, ..., M, N) int32 in [0, m_l)."""
    moduli = tuple(int(m) for m in moduli)
    inv = garner_constants(moduli)
    digits: list[torch.Tensor] = []
    for i, m in enumerate(moduli):
        t = residues[i]
        for j in range(i):
            # |t - d_j| * inv < 2^17: exact in int32.
            t = torch.remainder((t - digits[j]) * inv[i][j], m)
        digits.append(torch.where(t > m // 2, t - m, t).to(torch.int32))
    return digits


def dd_dtype(out_dtype: torch.dtype) -> torch.dtype:
    """The double-double's base type: float64 for a float64 output,
    float32 for any other (ROADMAP.md § 3 H6)."""
    return torch.float64 if out_dtype == torch.float64 else torch.float32


def mixed_radix_to_dd(digits: list[torch.Tensor], moduli,
                      dtype: torch.dtype = torch.float32):
    """The balanced mixed-radix polynomial in double-double of ``dtype``
    (Horner, highest digit first)."""
    p = len(digits)
    hi = digits[p - 1].to(dtype)
    lo = torch.zeros_like(hi)
    for i in range(p - 2, -1, -1):
        hi, lo = dd.mul_scalar(hi, lo, float(moduli[i]))
        hi, lo = dd.add_scalar_array(hi, lo, digits[i].to(dtype))
    return hi, lo


def crt_reconstruct(residues: torch.Tensor, moduli,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The centered representative in (-P/2, P/2] of the residues, as
    ``out_dtype``: hi and lo each rounded to it, then added in it."""
    moduli = tuple(int(m) for m in moduli)
    hi, lo = mixed_radix_to_dd(garner_digits(residues, moduli), moduli,
                               dd_dtype(out_dtype))
    return hi.to(out_dtype) + lo.to(out_dtype)


def unscale(c_int: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """c / (mu * nu), every op in ``out_dtype``."""
    return c_int / (mu.to(out_dtype) * nu.to(out_dtype))


def scaled_matmul(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, moduli,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Steps 1-5 for given scales: (..., M, K) @ (..., K, N) with mu
    (..., M, 1) in a's type and nu (..., 1, N) in b's type."""
    if out_dtype not in OUT_DTYPES:
        raise NotImplementedError(
            f"Scheme II out_dtype {out_dtype}: the port reconstructs into "
            "float32, bfloat16, float16 or float64")
    moduli = tuple(int(m) for m in moduli)
    return residue_matmul(balanced_residues(torch.trunc(a * mu), moduli),
                          balanced_residues(torch.trunc(b * nu), moduli),
                          mu, nu, moduli, out_dtype)


def residue_matmul(a_res: torch.Tensor, b_res: torch.Tensor, mu: torch.Tensor,
                   nu: torch.Tensor, moduli,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Steps 3-5 on the balanced residues (p, ..., M, K) and
    (p, ..., K, N) of the integerized operands."""
    c_res = modular_reduce(residue_gemms(a_res, b_res), moduli)
    return unscale(crt_reconstruct(c_res, moduli, out_dtype), mu, nu,
                   out_dtype)


def scales(a: torch.Tensor, b: torch.Tensor, moduli):
    """mu (..., M, 1) and nu (..., 1, N) at the shared budget of the
    lhs type (the reference's ``_matmul_scheme2``)."""
    budget = budget_bits(moduli, a.shape[-1], a.dtype)
    return (_pow2_int_scale(a, -1, budget), _pow2_int_scale(b, -2, budget))


def matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Emulated (..., M, K) @ (..., K, N) via Scheme II, unfused."""
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    moduli = cfg.resolved_moduli()
    check_exact_k(a.shape[-1], moduli)
    a, b = operand(a), operand(b)
    mu, nu = scales(a, b, moduli)
    return scaled_matmul(a, b, mu, nu, moduli, out_dtype)


def effective_bits(moduli, k_dim: int) -> int:
    return scheme2_budget(moduli, k_dim)


def fused_matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Scheme-II GEMM through the dispatcher: EmuGEMM-II on CUDA tensors,
    the plain version on CPU tensors."""
    import dataclasses
    from repro_torch.kernels import dispatch  # lazy: dispatch imports us
    if cfg.scheme != "ozaki2":
        cfg = dataclasses.replace(cfg, scheme="ozaki2")
    return dispatch.emulated_matmul(a, b, cfg=cfg, out_dtype=out_dtype)
