"""Scheme-pinned end-to-end wrappers of the port (``repro.kernels.ops``).

:func:`fused_scheme1_matmul` is EmuGEMM-I end to end. Under
``cfg.decomp`` 'kernel' or 'auto' the power-of-two scales run in torch
and the slicing in the kernel (the 2-D form of
``ozaki1.fused_matmul_scheme1``); under 'xla' both operands are split in
torch, interleaved on K at ``decompose.TILE`` (K padded with zero
slices) and multiplied by the kernel's interleaved form
(``ozaki1.fused_matmul_interleaved``), the paper's Sec. III-A pipeline,
with the scales narrowed to float32 as the reference's route narrows
them. The two routes give the same bits wherever the scales are float32
numbers (every float32 and bf16 operand, and a float64 one within
2^+-126). Operands are float32, bf16, float16 (widened to float32) or
float64, p in 1..16. No spec token sets ``decomp``, so a caller reaches
'xla' through ``EmulationConfig(decomp='xla')``.

:func:`int8_matmul` is ``matmul_int8.int8_matmul``, re-exported.

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
combination in the kernel, the two CRTs in torch. It equals the 3M
plane route's result bit for bit.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from repro_torch.core import complex3m, scheme1, scheme2
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import decompose, dispatch, ozaki1, ozaki2, ozaki3m
from repro_torch.kernels.backends.cuda import KERNEL_BLOCKS
from repro_torch.kernels.matmul_int8 import int8_matmul  # noqa: F401  (re-export)


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


def fused_scheme1_matmul(a: torch.Tensor, b: torch.Tensor, cfg=None,
                         out_dtype=torch.float32, blocks=None) -> torch.Tensor:
    """End-to-end EmuGEMM-I: (M, K) @ (K, N) float -> (M, N) ``out_dtype``
    (ozaki1-p4 when nothing is configured); the decomposition site
    follows ``cfg.decomp``.

    ``blocks`` may only name the kernel's own tile
    (``backends.cuda.KERNEL_BLOCKS``): the kernel is compiled for one.
    """
    cfg = _resolve(cfg, "ozaki1", 4)
    if blocks is not None and blocks != KERNEL_BLOCKS:
        raise ValueError(f"fused_scheme1_matmul: the kernel runs one tile, "
                         f"{KERNEL_BLOCKS}; got blocks={blocks}")
    k = a.shape[1]
    p, beta = cfg.p, cfg.resolved_beta(k)
    if cfg.decomp in ("auto", "kernel"):
        if a.dtype != b.dtype or a.dtype != torch.bfloat16:
            a, b = scheme1.widen(a), scheme1.widen(b)   # bf16 @ bf16 stays
            common = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(common), b.to(common)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        return ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, beta, out_dtype)
    a_sl, mu = scheme1.split(a, p, beta, axis=1)
    b_sl, nu = scheme1.split(b, p, beta, axis=0)
    pad = decompose.round_up(k) - k
    a_hat = scheme1.interleave_k(F.pad(a_sl, (0, pad)), "a", decompose.TILE)
    b_hat = scheme1.interleave_k(F.pad(b_sl, (0, 0, 0, pad)), "b",
                                 decompose.TILE)
    return ozaki1.fused_matmul_interleaved(a_hat, b_hat, mu.float(),
                                           nu.float(), p, beta, out_dtype)


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
    c_re8, c_im8 = ozaki3m.fused_3m_residue_matmul(
        complex3m.phase_residues(a, mu, moduli),
        complex3m.phase_residues(b, nu, moduli), moduli)
    return complex3m.reconstruct(
        scheme2.modular_reduce(c_re8.to(torch.int32), moduli),
        scheme2.modular_reduce(c_im8.to(torch.int32), moduli),
        mu, nu, moduli, out_dtype)


def maybe_fused_matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig):
    """Deprecated dispatch hook; use ``dispatch.auto_fused_matmul``."""
    warnings.warn(
        "ops.maybe_fused_matmul is deprecated; call "
        "dispatch.auto_fused_matmul (or repro_torch.dot_general/einsum)",
        DeprecationWarning, stacklevel=2)
    return dispatch.auto_fused_matmul(a, b, cfg)
