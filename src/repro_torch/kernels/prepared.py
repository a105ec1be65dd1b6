"""Pre-decomposed rhs operands of the port (``repro.kernels.prepared``,
Scheme I).

Training re-decomposes the same weight in the forward, the remat
re-forward and the backward dA = dC B^T. A :class:`PreparedOperand`
holds the finished decomposition instead:

  * ``slices`` — the p int8 slices, interleaved on K ((p * Kp, N), paper
    Eq. 11) at granularity ``blocks.bk``, the K tile of the mixed kernel;
  * ``scale``  — the (1, N) float32 power-of-two column scale;
  * ``p``/``beta``, ``k``/``n`` (the logical dims), ``layout``;
  * ``twin``   — the same weight prepared as the rhs of B^T, for dA;
  * ``backend`` — the kernel backend that prepared it and consumes it.

:func:`prepare_rhs` builds one from a single read of the weight (K2, the
pair kernel; K2r twice when the backward runs at another slice count),
and :func:`matmul_prepared` consumes it through the mixed form of the
EmuGEMM-I kernel (K3): the lhs is carved in the kernel, the prepared
planes stream as they are.

Unlike the reference, nothing is padded to 128: the prepared layouts
round K (and N in the twin) up to the kernel's tile only, with zero
slices, and beta comes from the logical dims, which the reference's
padded dims agree with wherever ``safe_beta`` is 7 (every dim up to
2^17; :func:`_beta` checks it). The reference's 'stacked' layout of its
XLA expansion has no counterpart: ``impl='xla'`` prepares on the
``torch`` backend, the plain versions, in the same layout.
Scheme II (``PreparedResidues``) and the once-per-step hoist
(``StepPrepared``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import scheme1
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import backends
from repro_torch.kernels.backends.cuda import KERNEL_BLOCKS
from repro_torch.kernels.common import Blocks
from repro_torch.kernels.decompose import TILE

_REF_ALIGN = 128     # the reference's prepared padding


@dataclasses.dataclass
class PreparedOperand:
    """A pre-split, pre-interleaved Scheme-I rhs operand (module doc)."""
    slices: torch.Tensor
    scale: torch.Tensor
    p: int
    beta: int
    blocks: Blocks
    layout: str
    k: int
    n: int
    twin: "PreparedOperand | None" = None
    backend: str = "cuda"

    def stacked(self) -> torch.Tensor:
        """The (p, Kp, N) slice stack, deinterleaved."""
        return scheme1.deinterleave_k(self.slices, self.p, self.blocks.bk)

    def reconstruct(self) -> torch.Tensor:
        """The dense (k, n) float32 weight the slices represent, exact up
        to the decomposition residual (scale * 2^(-beta p) elementwise)."""
        st = self.stacked().float()
        w = torch.zeros(st.shape[1:], dtype=torch.float32,
                        device=st.device)
        for i in range(self.p):
            w = w + 2.0 ** (-self.beta * (i + 1)) * st[i]
        return (w * self.scale.float())[:self.k, :self.n]


def _beta(cfg: EmulationConfig, dim: int) -> int:
    """beta for a prepared contraction of length ``dim``; the reference
    takes it from the dim padded to 128, which must give the same."""
    beta = cfg.resolved_beta(dim)
    padded = -(-dim // _REF_ALIGN) * _REF_ALIGN
    if cfg.resolved_beta(padded) != beta:
        raise NotImplementedError(
            f"beta differs between K={dim} ({beta}) and its 128-padded "
            f"{padded}; such a contraction is beyond safe_beta's 7-bit range")
    return beta


def _backend_name(cfg: EmulationConfig, device) -> str:
    if cfg.impl == "xla" or cfg.decomp == "xla":
        return "torch"
    return backends.resolve_backend_name(None, cfg, device)


def prepare_rhs(b: torch.Tensor, cfg: EmulationConfig, *,
                with_twin: bool = False) -> PreparedOperand:
    """Decompose a (K, N) float rhs once, for reuse across GEMMs.

    With ``with_twin`` the K-transposed layout for the backward dA GEMM
    comes too: from the same read of b (the pair kernel) when forward
    and backward share p, else from a second rhs decomposition of b.T at
    ``cfg.bwd_p`` (b.T is a strided view, never copied).
    """
    if isinstance(b, PreparedOperand):
        return b
    if cfg.scheme == "ozaki2":
        raise NotImplementedError(
            "Scheme-II prepared residues (PreparedResidues, with the "
            "prepared-residue form of EmuGEMM-II) are not ported yet "
            "(ROADMAP.md § 1 item 3)")
    if cfg.scheme != "ozaki1":
        raise ValueError(f"prepare_rhs needs an emulated scheme, got "
                         f"{cfg.scheme!r}")
    if b.dim() != 2:
        raise ValueError(f"prepare_rhs is 2-D; got {tuple(b.shape)}")
    if b.is_complex():
        raise ValueError("prepare_rhs is real-valued; decompose the real "
                         "and imaginary parts separately (4M formulation)")
    if not b.is_floating_point():
        b = b.float()
    name = _backend_name(cfg, b.device)
    be = backends.get_backend(name)
    be.check(cfg, b, b)
    k, n = b.shape
    p, beta = cfg.p, _beta(cfg, k)
    nu = scheme1.pow2_scale(b, -2)                              # (1, N)
    if not with_twin:
        hat, _ = be.decompose(b, nu, None, p, beta, 0)
        return PreparedOperand(hat, nu, p, beta, KERNEL_BLOCKS,
                               "interleaved", k, n, backend=name)
    p_bwd, beta_bwd = cfg.bwd_p or p, _beta(cfg, n)
    tau = scheme1.pow2_scale(b, -1).T                           # (1, K)
    if p_bwd == p:
        hat, t_hat = be.decompose(b, nu, tau, p, beta, beta_bwd)
    else:
        hat, _ = be.decompose(b, nu, None, p, beta, 0)
        t_hat, _ = be.decompose(b.T, tau, None, p_bwd, beta_bwd, 0)
    twin = PreparedOperand(t_hat, tau, p_bwd, beta_bwd, KERNEL_BLOCKS,
                           "interleaved", n, k, backend=name)
    return PreparedOperand(hat, nu, p, beta, KERNEL_BLOCKS, "interleaved",
                           k, n, twin, name)


def matmul_prepared(a: torch.Tensor, prep: PreparedOperand,
                    out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) float @ prepared (K, N) -> (M, N) ``out_dtype``, on the
    backend that prepared ``prep``: the lhs is carved in the mixed
    kernel, the prepared planes stream as they are."""
    if not isinstance(prep, PreparedOperand):
        raise NotImplementedError(
            f"matmul_prepared takes a Scheme-I PreparedOperand, got "
            f"{type(prep).__name__} (Scheme II: ROADMAP.md § 1 item 3)")
    m, k = a.shape
    if k != prep.k:
        raise ValueError(f"lhs K={k} vs prepared K={prep.k}")
    if a.is_complex():
        raise ValueError("matmul_prepared is real-valued; got complex lhs "
                         f"{a.dtype}")
    if prep.layout != "interleaved" or prep.blocks.bk != TILE:
        raise ValueError(f"prepared operand interleaved at {prep.blocks.bk} "
                         f"({prep.layout}); the mixed kernel reads "
                         f"granularity {TILE}")
    if not a.is_floating_point():
        a = a.float()
    mu = scheme1.pow2_scale(a, -1)                              # (M, 1)
    return backends.get_backend(prep.backend).matmul_mixed(
        a, prep.slices, mu, prep.scale, prep.p, prep.beta, out_dtype)
