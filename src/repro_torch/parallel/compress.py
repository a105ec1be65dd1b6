"""Scheme-II gradient compression for data-parallel reduction
(``repro.parallel.compress``).

The Ozaki Scheme II idea applied to a collective: the values are scaled
to integers, reduced to ``p`` balanced int8-range residues modulo
pairwise-coprime moduli, summed in exact int32 modular arithmetic, and
reconstructed by CRT. Every step is exact integer math, so the sum is
bitwise the same whatever the reduction order or the number of ranks,
which a float all-reduce is not, and the wire format is p bytes an
element.

The sum of n integerized values needs |sum| < P / 2, so the budget is
log2(P) - 2 - ceil(log2 n), at most 30 bits; :func:`compressed_psum`
picks it from the modulus set and the rank count. The numbers are the
reference's, bit for bit: the scale is
``exp2(budget - 1 - ceil(log2(amax)))`` with ``log2`` rounded to float32
(so an amax just above a power of two can round down onto it, as the
reference's does), ``remainder`` is a floor modulo and the rounding is
half to even.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.precision import default_moduli
from repro_torch.core.scheme2 import garner_digits, mixed_radix_to_dd
from repro_torch.parallel import comm


def _budget(moduli, n_devices: int) -> int:
    log2_p_prod = sum(math.log2(m) for m in moduli)
    budget = int(log2_p_prod - 2 - math.ceil(math.log2(max(2, n_devices))))
    return min(budget, 30)  # int32 residue math headroom


def _scale(amax: torch.Tensor, budget: int) -> torch.Tensor:
    """The reference's float32 scale, ``exp2(budget - 1 - ceil(log2(amax)))``
    as XLA computes it, which maps |x| <= amax below about 2^(budget - 1).

    ``jnp.log2`` is ``log(x) / log(2)`` in float32, which XLA compiles to
    a product with the float32 reciprocal; that product (not the
    correctly rounded log2) is what the ceiling sees, and it puts a small
    power of two 2^e just above e. ``jnp.exp2(n)`` is ``exp(n * log(2))``
    with the product rounded to float32, so at an integer n it is not
    2^n but the float32 exp of that rounded argument, up to dozens of
    ulps away; below 2^-126 XLA flushes it to zero."""
    amax = torch.clamp(amax.float(), min=1e-30)
    exp = torch.ceil(torch.log(amax) * _INV_LN2)
    arg = (budget - 1 - exp) * _LN2
    scale = torch.exp(arg.double()).float()
    return torch.where(scale < 2.0 ** -126, torch.zeros_like(scale), scale)


_LN2 = float(torch.tensor(math.log(2), dtype=torch.float32))
_INV_LN2 = float(torch.tensor(1 / math.log(2), dtype=torch.float32))


def residues_of(x: torch.Tensor, scale: torch.Tensor, moduli) -> list:
    """The balanced residues of round(x * scale) for each modulus."""
    xi = torch.round(x.float() * scale).to(torch.int32)
    return [torch.remainder(xi + m // 2, m) - m // 2 for m in moduli]


def reconstruct(sums: list, scale: torch.Tensor, moduli) -> torch.Tensor:
    """The float32 value of the summed residues (Garner digits, then the
    double-double Horner sum), unscaled."""
    canon = [torch.remainder(r, m).to(torch.int32)
             for r, m in zip(sums, moduli)]
    digits = garner_digits(torch.stack(canon), moduli)
    hi, lo = mixed_radix_to_dd(digits, moduli)
    total = hi.float() + lo.float()
    return total / scale


def compressed_psum(x: torch.Tensor, group, n_devices: int,
                    p: int = 6) -> torch.Tensor:
    """Exact, deterministic sum of float32 ``x`` over ``group``.

    ``group`` is ``(mesh, axes)``: a mesh (``launch.mesh``) and the axis
    name (or tuple of names) to sum over, the reference's ``axis_name``.
    The values are clamped into a power-of-two scale chosen from the
    *global* max magnitude (one scalar reduction), so every rank
    integerizes identically; the residues' sums are exact int32."""
    mesh, axes = group
    moduli = default_moduli(p)
    budget = _budget(moduli, n_devices)
    amax = torch.max(torch.abs(x.float())).reshape(1)
    # The max over ranks: a gather of one scalar each, then max (exact).
    amax = torch.max(comm.gather_raw(amax, 0, mesh, axes))
    scale = _scale(amax, budget)
    sums = [comm.sum_raw(r, mesh, axes) for r in residues_of(x, scale,
                                                             moduli)]
    return reconstruct(sums, scale, moduli)


def compressed_pmean(x: torch.Tensor, group, n_devices: int,
                     p: int = 6) -> torch.Tensor:
    return compressed_psum(x, group, n_devices, p) / n_devices
