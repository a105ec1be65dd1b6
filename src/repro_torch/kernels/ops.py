"""Scheme-pinned end-to-end wrappers of the port (``repro.kernels.ops``).

:func:`fused_scheme2_matmul` is the route that drives the residue form of
EmuGEMM-II (``ozaki2.fused_residue_matmul``): the scales and the balanced
residues are computed in torch, the p residue GEMMs with their modular
reduction run in the kernel, and the CRT runs in torch. On CUDA tensors
it equals the fused form (``dispatch.emulated_matmul`` under ``ozaki2``)
bit for bit. The reference's Scheme-I and complex wrappers of this
module are not ported (ROADMAP.md § 1 item 3).
"""

from __future__ import annotations

import torch

from repro_torch.core import scheme2
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import ozaki2


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
