"""Double-double (compensated) arithmetic for exact CRT evaluation
(``repro.core.dd``).

A value is an unevaluated sum hi + lo with |lo| <= ulp(hi)/2, about
twice the mantissa bits of the base type. Scheme II evaluates Garner's
mixed-radix polynomial with it, in float64 for a float64 output and in
float32 otherwise (``scheme2.dd_dtype``), and rounds the result to the
output type.

No FMA: ``two_prod`` splits with Veltkamp (constant 2^12 + 1 for
float32, 2^27 + 1 for float64: ``2^((nmant + 2) // 2) + 1``, as the
reference computes it), which is exact in IEEE arithmetic. Every op here
is one torch elementwise op, so nothing can contract ``ah * bh - p``
into an FMA; the CUDA kernels (``kernels/csrc/emugemm_common.cuh``)
write the same ops as explicit ``_rn`` intrinsics for that reason.
"""

from __future__ import annotations

import torch


def _split_constant(dtype: torch.dtype) -> float:
    # Veltkamp split constant 2^ceil(t/2) + 1 where t = mantissa bits.
    nmant = {torch.float32: 23, torch.float64: 52}[dtype]
    return float(2 ** ((nmant + 2) // 2) + 1)


def two_sum(a, b):
    """Exact: a + b = s + e."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Exact when |a| >= |b|: a + b = s + e."""
    s = a + b
    e = b - (s - a)
    return s, e


def _veltkamp(a):
    c = _split_constant(a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact: a * b = p + e (Dekker, FMA-free)."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def mul_scalar(hi, lo, c: float):
    """(hi, lo) * c for a scalar c exact in the type (a small modulus)."""
    c = torch.full_like(hi, c)
    p1, p2 = two_prod(hi, c)
    p2 = p2 + lo * c
    return quick_two_sum(p1, p2)


def add_scalar_array(hi, lo, x):
    """(hi, lo) + x for an array of values exact in the type (digits)."""
    s, e = two_sum(hi, x)
    e = e + lo
    return quick_two_sum(s, e)


def add2(hi1, lo1, hi2, lo2):
    """(hi1, lo1) + (hi2, lo2), sloppy (single-branch) dd addition."""
    s, e = two_sum(hi1, hi2)
    e = e + lo1 + lo2
    return quick_two_sum(s, e)


def split_const(_: float, exact_int: int):
    """Represent a (possibly >53-bit) python integer as a dd constant."""
    hi = float(exact_int)
    lo = float(exact_int - int(hi))
    return hi, lo
