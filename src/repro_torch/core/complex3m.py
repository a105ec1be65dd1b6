"""Scheme-II complex GEMM via the 3M identity (paper Sec. IV-B), in
PyTorch: the torch counterpart of ``repro.core.complex3m``.

T1 = Ar'Br', T2 = Ai'Bi', T3 = (Ar'+Ai')(Br'+Bi')   (all mod m_l)
C_re = T1 - T2 ; C_im = T3 - T1 - T2.

In modular integer arithmetic every operation is exact, so 3M has no
cancellation problem and takes three int8 GEMMs per modulus where 4M
takes four. The sum residues (Ar'+Ai') are re-balanced into the int8
range before their GEMM, and the budget is one bit tighter
(``scheme2_budget(..., complex_guard=True)``: C_im sums two products).
One power-of-two scale per row of A and per column of B is shared by
the real and imaginary parts, and the result is multiplied by
``inv = 1 / (mu * nu)`` (real Scheme II divides by mu * nu; the two
round differently).

A real operand is its own real part with a zero imaginary part, so
complex @ real and real @ complex both work. The output type follows
the reference: float64 parts when a is complex128, float32 otherwise,
unless given; the residues and double-double follow
``repro_torch.core.scheme2`` (int64 residues for float64 parts, a
float64 double-double for a float64 output).

:func:`scaled_matmul` is the plain version of the 3M plane route K7g
(``repro_torch.kernels.ozaki3m.fused_matmul_3m``) and, with
:func:`matmul`, what the 'torch' backend runs.
"""

from __future__ import annotations

import torch

from repro_torch.core import scheme2
from repro_torch.core.precision import EmulationConfig, scheme2_budget
from repro_torch.core.scheme1 import complex_parts

# Part types of the complex outputs torch can assemble.
_PART_DTYPES = (torch.float32, torch.float64)


def _balanced(x_int32: torch.Tensor, m: int) -> torch.Tensor:
    """((x + m//2) mod m) - m//2 as int8 (floor modulo)."""
    half = m // 2
    return (torch.remainder(x_int32 + half, m) - half).to(torch.int8)


def parts(x: torch.Tensor):
    """(re, im) of an operand, each a float type Scheme II takes."""
    re, im = complex_parts(x)
    return scheme2.operand(re), scheme2.operand(im)


def scales(a: torch.Tensor, b: torch.Tensor, moduli):
    """mu (..., M, 1) in a's part type and nu (..., 1, N) in b's, shared
    by the real and imaginary parts, at the 3M budget capped at the
    mantissa of a's part type."""
    ar, ai = parts(a)
    br, bi = parts(b)
    budget = min(scheme2_budget(moduli, a.shape[-1], complex_guard=True),
                 scheme2.MANTISSA[ar.dtype])
    mu = scheme2._pow2_int_scale(torch.maximum(ar.abs(), ai.abs()), -1,
                                 budget)
    nu = scheme2._pow2_int_scale(torch.maximum(br.abs(), bi.abs()), -2,
                                 budget)
    return mu, nu


def default_out_dtype(a: torch.Tensor) -> torch.dtype:
    return torch.float64 if a.dtype == torch.complex128 else torch.float32


def scaled_matmul(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, moduli,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The 3M pipeline for given scales: (..., M, K) @ (..., K, N),
    complex or real operands, -> complex (..., M, N) with parts of
    ``out_dtype``."""
    if out_dtype not in _PART_DTYPES:
        raise NotImplementedError(
            f"complex Scheme II assembles complex64 or complex128 results; "
            f"out_dtype {out_dtype} has no complex type")
    moduli = tuple(int(m) for m in moduli)
    return residue_matmul(phase_residues(a, mu, moduli),
                          phase_residues(b, nu, moduli), mu, nu, moduli,
                          out_dtype)


def phase_residues(x: torch.Tensor, scale: torch.Tensor,
                   moduli) -> torch.Tensor:
    """(p, 3, ...) int8: the balanced residues of re and im integerized
    with the shared scale, and the re-balanced residues of their sum."""
    xr, xi = parts(x)
    res = [scheme2.balanced_residues(torch.trunc(v * scale), moduli)
           for v in (xr, xi)]
    sums = torch.stack([_balanced(res[0][l].to(torch.int32)
                                  + res[1][l].to(torch.int32), int(m))
                        for l, m in enumerate(moduli)])
    return torch.stack([res[0], res[1], sums], dim=1)


def residue_matmul(a3: torch.Tensor, b3: torch.Tensor, mu: torch.Tensor,
                   nu: torch.Tensor, moduli,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The 3M products of the phase residues (p, 3, ..., M, K) and
    (p, 3, ..., K, N), one modulus at a time, so that the float64 copies
    that ``residue_gemms`` multiplies stay small, then the CRTs."""
    c_re, c_im = [], []
    for l, m in enumerate(int(m) for m in moduli):
        t1, t2, t3 = (scheme2.residue_gemms(a3[l, t], b3[l, t])
                      for t in range(3))
        # The exact modular combination, in the reference's order.
        t1m, t2m, t3m = (torch.remainder(t, m) for t in (t1, t2, t3))
        c_re.append(torch.remainder(t1m - t2m, m).to(torch.int32))
        c_im.append(torch.remainder(t3m - t1m - t2m, m).to(torch.int32))
    return reconstruct(torch.stack(c_re), torch.stack(c_im), mu, nu, moduli,
                       out_dtype)


def reconstruct(c_re: torch.Tensor, c_im: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, moduli, out_dtype: torch.dtype
                ) -> torch.Tensor:
    """Canonical (p, ..., M, N) residues of C_re and C_im -> the complex
    product: two CRTs, each times inv = 1 / (mu * nu) in ``out_dtype``."""
    cr = scheme2.crt_reconstruct(c_re, moduli, out_dtype)
    ci = scheme2.crt_reconstruct(c_im, moduli, out_dtype)
    inv = 1.0 / (mu.to(out_dtype) * nu.to(out_dtype))
    return torch.complex(cr * inv, ci * inv)


def matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Emulated complex (..., M, K) @ (..., K, N) via Scheme II + 3M,
    unfused."""
    if out_dtype is None:
        out_dtype = default_out_dtype(a)
    moduli = cfg.resolved_moduli()
    scheme2.check_exact_k(a.shape[-1], moduli)
    mu, nu = scales(a, b, moduli)
    return scaled_matmul(a, b, mu, nu, moduli, out_dtype)


def gemm_count(cfg: EmulationConfig) -> int:
    """3M: 3 GEMMs per modulus (vs 4 for 4M)."""
    return 3 * cfg.p


def fused_matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Complex Scheme-II GEMM through the dispatcher: the 3M plane route
    on CUDA tensors, the plain version on CPU tensors."""
    import dataclasses
    from repro_torch.kernels import dispatch  # lazy: the backends import us
    if cfg.scheme != "ozaki2":
        cfg = dataclasses.replace(cfg, scheme="ozaki2")
    return dispatch.emulated_matmul(a, b, cfg=cfg, out_dtype=out_dtype)
