"""The 'cuda' backend: Scheme I on the hand-written EmuGEMM-I kernel.

The torch counterpart of the Scheme-I part of
``repro.kernels.backends.gpu``: ``choose_blocks_gpu`` (here
:func:`choose_blocks_cuda`), ``_matmul_scheme1`` and
``_matmul_scheme1_batched``. As in the reference, the power-of-two
scales and beta are computed outside the kernel (beta from the logical
K), and the kernel receives them. The kernel zero-fills ragged edges
itself, so nothing is padded and every shape reaches it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decompose, ozaki1
from repro_torch.kernels.backends.base import BackendCapabilities, KernelBackend
from repro_torch.kernels.common import Blocks

_CAPS = BackendCapabilities(
    schemes=frozenset({"ozaki1"}),
    operand_dtypes=frozenset({torch.float32, torch.bfloat16}),
)

# The one tile the kernel is compiled for (csrc/emugemm1.cu). Its K tile
# is the interleave granularity of a prepared weight.
KERNEL_BLOCKS = Blocks(bm=64, bn=64, bk=decompose.TILE)


def choose_blocks_cuda(m: int, n: int, k: int, p: int) -> Blocks | None:
    """The kernel's tile for an (m, k) @ (k, n) problem at slice count p,
    or None when the kernel has no instance for p."""
    del m, n, k
    return KERNEL_BLOCKS if 1 <= p <= ozaki1.MAX_P else None


def scales(a: torch.Tensor, b: torch.Tensor):
    """mu (..., M, 1) and nu (..., 1, N): power-of-two row scales of a
    and column scales of b, as the kernel takes them."""
    from repro_torch.core import scheme1
    return scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)


class CudaBackend(KernelBackend):
    name = "cuda"

    @property
    def capabilities(self) -> BackendCapabilities:
        return _CAPS

    def choose_blocks(self, m, n, k, p):
        return choose_blocks_cuda(m, n, k, p)

    def matmul(self, a, b, cfg, out_dtype, blocks):
        self.check(cfg, a, b)
        if a.dtype != b.dtype:
            common = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(common), b.to(common)
        beta = cfg.resolved_beta(a.shape[-1])
        mu, nu = scales(a, b)
        return ozaki1.fused_matmul_scheme1(a, b, mu, nu, cfg.p, beta,
                                           out_dtype)

    def decompose(self, b, nu, tau, p, beta_f, beta_b):
        if tau is None:
            return decompose.decompose_interleave_rhs(b, nu, p, beta_f), None
        return decompose.decompose_interleave_pair(b, nu, tau, p, beta_f,
                                                   beta_b)

    def matmul_mixed(self, a, b_hat, mu, nu, p, beta, out_dtype):
        return ozaki1.fused_matmul_mixed(a, b_hat, mu, nu, p, beta, out_dtype)
