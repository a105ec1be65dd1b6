"""Scheme-pinned end-to-end wrappers of the port (``repro.kernels.ops``).

:func:`fused_scheme2_matmul` is the route that drives the residue form of
EmuGEMM-II (``ozaki2.fused_residue_matmul``): the scales and the balanced
residues are computed in torch, the p residue GEMMs with their modular
reduction run in the kernel, and the CRT runs in torch. It takes float32,
bfloat16 and float64 operands (a float64 output reconstructs in float64
double-double). On CUDA tensors it equals the fused form
(``dispatch.emulated_matmul`` under ``ozaki2``) bit for bit.

:func:`fused_3m_matmul` is the complex route that drives the 3M residue
kernel (``ozaki3m.fused_3m_residue_matmul``): the shared scales and the
[re, im, re+im] residue phases in torch, the 3p residue GEMMs with the 3M
combination in the kernel, the two CRTs in torch. It equals the fused 3M
kernel's result bit for bit. The reference's Scheme-I wrappers of this
module are not ported (ROADMAP.md § 2, K8).
"""

from __future__ import annotations

import torch

from repro_torch.core import complex3m, scheme2
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import ozaki2, ozaki3m


def _resolve(cfg, scheme: str, p: int) -> EmulationConfig:
    """An explicit cfg must be of ``scheme``; an ambient one of another
    scheme is not for this wrapper, which then takes its pinned default."""
    from repro_torch import api
    if cfg is not None:
        cfg = api.precision(cfg)
        if cfg.scheme != scheme:
            raise ValueError(f"this wrapper is {scheme}-only; got "
                             f"scheme={cfg.scheme!r}")
        return cfg
    ambient = api.current_emulation()
    if ambient is not None and ambient.scheme == scheme:
        return ambient
    return EmulationConfig(scheme=scheme, p=p)


def fused_scheme2_matmul(a: torch.Tensor, b: torch.Tensor, cfg=None,
                         out_dtype=torch.float32) -> torch.Tensor:
    """End-to-end EmuGEMM-II real GEMM (M, K) @ (K, N) through the residue
    form (ozaki2 with 8 moduli when nothing is configured)."""
    cfg = _resolve(cfg, "ozaki2", 8)
    moduli = cfg.resolved_moduli()
    scheme2.check_exact_k(a.shape[-1], moduli)
    a, b = scheme2.operand(a), scheme2.operand(b)
    mu, nu = scheme2.scales(a, b, moduli)
    a_res = scheme2.balanced_residues(torch.trunc(a * mu), moduli)
    b_res = scheme2.balanced_residues(torch.trunc(b * nu), moduli)
    # Balanced int8 residues -> canonical [0, m_l) int32 (the reference's
    # _canonical_residues).
    c_res = scheme2.modular_reduce(
        ozaki2.fused_residue_matmul(a_res, b_res, moduli).to(torch.int32),
        moduli)
    c_int = scheme2.crt_reconstruct(c_res, moduli, out_dtype)
    return scheme2.unscale(c_int, mu, nu, out_dtype)


def fused_3m_matmul(a: torch.Tensor, b: torch.Tensor, cfg=None,
                    out_dtype=None) -> torch.Tensor:
    """End-to-end EmuGEMM-II complex GEMM (M, K) @ (K, N) through the 3M
    residue kernel (ozaki2 with 8 moduli when nothing is configured);
    parts of ``out_dtype``, float64 by default for a complex128 lhs and
    float32 otherwise, as the reference."""
    cfg = _resolve(cfg, "ozaki2", 8)
    if out_dtype is None:
        out_dtype = complex3m.default_out_dtype(a)
    moduli = cfg.resolved_moduli()
    scheme2.check_exact_k(a.shape[-1], moduli)
    mu, nu = complex3m.scales(a, b, moduli)

    def phases(x, scale):
        """(p, 3, ...) residues [re, im, re+im], the sum re-balanced."""
        re, im = (scheme2.balanced_residues(torch.trunc(v * scale), moduli)
                  for v in complex3m.parts(x))
        sums = torch.stack([
            complex3m._balanced(re[l].to(torch.int32) + im[l].to(torch.int32),
                                int(m))
            for l, m in enumerate(moduli)])
        return torch.stack([re, im, sums], dim=1)

    c_re8, c_im8 = ozaki3m.fused_3m_residue_matmul(phases(a, mu),
                                                   phases(b, nu), moduli)
    return complex3m.reconstruct(
        scheme2.modular_reduce(c_re8.to(torch.int32), moduli),
        scheme2.modular_reduce(c_im8.to(torch.int32), moduli),
        mu, nu, moduli, out_dtype)
