"""Ozaki Scheme I in PyTorch: mantissa-slice decomposition for emulated GEMM.

The torch counterpart of ``repro.core.scheme1``. Decomposition (paper
Eq. 1): A ~= diag(mu) * sum_i 2^{-beta(i+1)} A'_i with A'_i signed int8
slices extracted by iterated truncation; B analogously along columns. The
p(p+1)/2 exact int8 GEMMs are grouped by positional weight s = i + j into p
int32 accumulators (Eq. 2) and merged by the shift-reduce (Eq. 3).

This module is the plain version of the fused kernel
(``repro_torch.kernels.ozaki1``): every step is an elementwise exact float
op or an exact integer product, so it runs the same on CPU and CUDA
tensors and is bit-identical to the JAX reference on float32 operands.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import EmulationConfig

# (bias, minexp, maxexp, mantissa bits, integer type of the same width)
# per float type — numpy's finfo numbers, as the reference clips to them.
_FLOAT_LAYOUT = {
    torch.float32: (127, -126, 128, 23, torch.int32),
    torch.float64: (1023, -1022, 1024, 52, torch.int64),
    torch.bfloat16: (127, -126, 128, 7, torch.int16),
    torch.float16: (15, -14, 16, 10, torch.int16),
}


def exact_pow2(exp: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact ``2.0 ** exp`` in ``dtype``, built from the exponent field.

    Exponents below the normal range clamp to the smallest normal power
    (the scale stays nonzero and exactly invertible); above it the field
    saturates to +inf, mirroring ``repro.core.scheme1.exact_pow2``.
    """
    bias, minexp, maxexp, nmant, itype = _FLOAT_LAYOUT[dtype]
    e = torch.clamp(exp.to(torch.int64), minexp, maxexp)
    bits = ((e + bias) << nmant).to(itype)
    return bits.view(dtype)


def widen(x: torch.Tensor) -> torch.Tensor:
    """Half floats and integers widen to float32 before slicing; float32
    and float64 keep their mantissa (``repro.kernels.backends.gpu._widen``).
    Widening bf16 is exact, and so is every later slicing step."""
    if not x.is_floating_point() or x.element_size() < 4:
        return x.to(torch.float32)
    return x


def complex_parts(x: torch.Tensor):
    """(re, im) of x; a real x is its own real part with a zero
    imaginary part, as ``jnp.real`` / ``jnp.imag`` take it."""
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def pow2_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Power-of-two scale mu with |x / mu| in [0, 1) along ``dim``,
    keepdim, in ``widen(x)``'s dtype.

    mu = 2^e where frexp(max|x|) = (m, e), m in [0.5, 1); all-zero
    lines get mu = 1. The max is taken in x's own type (exact), so a
    bf16 weight is never copied to float32 for it.
    """
    lo, hi = torch.aminmax(x, dim=dim, keepdim=True)
    amax = widen(torch.maximum(hi, -lo))
    _, e = torch.frexp(torch.where(amax == 0, torch.ones_like(amax), amax))
    return exact_pow2(e, amax.dtype)


def carve(r: torch.Tensor, p: int, beta: int) -> list[torch.Tensor]:
    """The p signed int8 beta-bit slices of ``r`` (already divided by its
    power-of-two scale) via iterated truncate-and-subtract; every step is
    exact in floating point."""
    two_beta = float(2 ** beta)
    slices = []
    for _ in range(p):
        shifted = r * two_beta
        s = torch.trunc(shifted)
        slices.append(s.to(torch.int8))
        r = shifted - s
    return slices


def split(a: torch.Tensor, p: int, beta: int, axis: int):
    """(slices (p, *a.shape) int8, scale) with
    a ~= scale * sum_i 2^{-beta (i+1)} slices[i], the scale along
    ``axis``."""
    a = widen(a)
    scale = pow2_scale(a, axis)
    return carve_stack(a / scale, p, beta), scale


def carve_stack(r: torch.Tensor, p: int, beta: int) -> torch.Tensor:
    """:func:`carve`'s slices as one (p, *r.shape) stack, handed to the
    guard's fault-injection hook (``guard.inject``), which corrupts it
    while a fault is armed: the decomposition of :func:`split` and of the
    plain versions of the EmuGEMM-I kernels. The kernels carve inside a
    launch and are never injected."""
    from repro_torch.guard.inject import maybe_corrupt_slices
    return maybe_corrupt_slices(torch.stack(carve(r, p, beta)))


def interleave_k(slices: torch.Tensor, operand: str, t_k: int) -> torch.Tensor:
    """Paper Eq. 11: interleave p slices along K at ``t_k`` granularity.

    Operand 'a' (slices (p, M, K)) gives (M, p*K), column groups cycling
    A'_0 | ... | A'_{p-1} per K-chunk; operand 'b' (slices (p, K, N))
    gives (p*K, N), row groups cycling the same way. K must be a
    multiple of ``t_k``.
    """
    p = slices.shape[0]
    if operand not in ("a", "b"):
        raise ValueError(f"operand must be 'a' or 'b', got {operand!r}")
    k = slices.shape[2] if operand == "a" else slices.shape[1]
    if k % t_k:
        raise ValueError(f"K={k} not divisible by t_k={t_k}")
    if operand == "a":
        m = slices.shape[1]
        s = slices.reshape(p, m, k // t_k, t_k)
        return s.permute(1, 2, 0, 3).reshape(m, p * k)
    n = slices.shape[2]
    s = slices.reshape(p, k // t_k, t_k, n)
    return s.permute(1, 0, 2, 3).reshape(p * k, n)


def deinterleave_k(x: torch.Tensor, p: int, operand: str,
                   t_k: int) -> torch.Tensor:
    """Inverse of :func:`interleave_k`: (M, p*K) -> (p, M, K) for 'a',
    (p*K, N) -> (p, K, N) for 'b'."""
    if operand == "a":
        m, pk = x.shape
        k = pk // p
        s = x.reshape(m, k // t_k, p, t_k)
        return s.permute(2, 0, 1, 3).reshape(p, m, k)
    if operand == "b":
        pk, n = x.shape
        k = pk // p
        s = x.reshape(k // t_k, p, t_k, n)
        return s.permute(1, 0, 2, 3).reshape(p, k, n)
    raise ValueError(f"operand must be 'a' or 'b', got {operand!r}")


def triangular_accumulators(a_slices, b_slices, p: int) -> torch.Tensor:
    """Paper Eq. 2: C_s = sum_{i<=s} A'_i B'_{s-i}, s = 0..p-1, as
    (p, ..., M, N) int32.

    Each slice product runs as a float64 matmul: every partial sum is an
    integer below 2^53, so the product is exact in any summation order.
    The sum over i wraps to int32 as the reference's int32 adds do.
    """
    a64 = [x.to(torch.float64) for x in a_slices]
    accs = []
    for s in range(p):
        acc = None
        for i in range(s + 1):
            prod = a64[i] @ b_slices[s - i].to(torch.float64)
            acc = prod if acc is None else acc + prod
        accs.append(acc.to(torch.int64).to(torch.int32))
    return torch.stack(accs)


def shift_reduce(accs: torch.Tensor, beta: int, scale_a: torch.Tensor,
                 scale_b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Paper Eq. 3: C = diag(mu) (sum_s 2^{-beta(s+2)} C_s) diag(nu),
    summed highest weight first in ``out_dtype``, every op rounded to it
    (int32 -> bf16 or float16 goes through float32, as torch converts).
    The weight is rounded to ``out_dtype`` first, as the reference's
    ``jnp.asarray(w, dtype=out_dtype)``: exact in float32, bf16 and
    float64 down to p = 16 (2^-119), in float16 subnormal at s = 1 and
    zero from s = 2 at beta = 7."""
    c = torch.zeros(accs.shape[1:], dtype=out_dtype, device=accs.device)
    for s in range(accs.shape[0]):
        w = torch.tensor(2.0 ** (-beta * (s + 2)), dtype=out_dtype).item()
        c = c + accs[s].to(out_dtype) * w
    return c * scale_a.to(out_dtype) * scale_b.to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Emulated (..., M, K) @ (..., K, N) via Scheme I, unfused: every
    slice product is an independent matmul."""
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    beta = cfg.resolved_beta(a.shape[-1])
    a_sl, mu = split(a, cfg.p, beta, axis=-1)
    b_sl, nu = split(b, cfg.p, beta, axis=-2)
    accs = triangular_accumulators(a_sl, b_sl, cfg.p)
    return shift_reduce(accs, beta, mu, nu, out_dtype)


def decomposition_residual_bound(p: int, beta: int) -> float:
    """Elementwise |a - reconstruction| <= scale * 2^{-beta p}."""
    return float(2.0 ** (-beta * p))


def fused_matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
                 out_dtype=None) -> torch.Tensor:
    """Scheme-I GEMM on the EmuGEMM-I kernels, via the dispatcher (on a
    CUDA tensor the plane route; on a CPU tensor its plain version)."""
    import dataclasses
    from repro_torch.kernels import dispatch
    if cfg.scheme != "ozaki1":
        cfg = dataclasses.replace(cfg, scheme="ozaki1")
    return dispatch.emulated_matmul(a, b, cfg=cfg, out_dtype=out_dtype)


def matmul_complex_4m(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Scheme-I complex GEMM via the 4M formulation (paper Sec. V-D:
    'EmuGEMM-I uses the 4M formulation'):
    C_re = Ar Br - Ai Bi, C_im = Ar Bi + Ai Br, four real emulated GEMMs:
    of float32 parts for complex64, of float64 parts for complex128 (the
    parts' type by default, as the reference's ``out_dtype=None``).
    """
    if out_dtype is None:
        out_dtype = (torch.float32 if a.dtype == torch.complex64
                     else torch.float64)
    ar, ai = complex_parts(a)
    br, bi = complex_parts(b)
    rr = matmul(ar, br, cfg, out_dtype)
    ii = matmul(ai, bi, cfg, out_dtype)
    ri = matmul(ar, bi, cfg, out_dtype)
    ir = matmul(ai, br, cfg, out_dtype)
    return torch.complex(rr - ii, ri + ir)
