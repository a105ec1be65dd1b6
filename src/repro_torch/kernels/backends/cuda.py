"""The 'cuda' backend: Scheme I on the hand-written EmuGEMM-I kernels
(2-D products and prepared weights on its plane route; float32, bfloat16
and float64 operands, p in 1..16, and float16 ones widened to float32 on
entry with the output in the promoted type, as the reference's ``_widen``
does), Scheme II on
EmuGEMM-II (float32, bfloat16, float16 and float64 products, 2-D or
batched, each operand integerized in its own type, and complex Scheme II,
all on its plane route).

The torch counterpart of ``repro.kernels.backends.gpu``:
``choose_blocks_gpu`` (here :func:`choose_blocks_cuda`),
``_matmul_scheme1[_batched]``, ``_matmul_scheme2[_batched]``,
``_matmul_3m``, ``supported_moduli`` and ``_check_moduli``, the
prepared-residue consumption of ``prepared.matmul_prepared_scheme2``; and the
dispatcher's Scheme-I complex 4M (``dispatch._fused_2d``), which runs as
four launches of EmuGEMM-I. As in the reference, the
power-of-two scales, beta and the Scheme-II budget are computed outside
the kernels, and the kernels receive them. Scheme II integerizes each
operand in its own type with the budget of the lhs type, as the
reference does, so mixed operand types are not promoted. Unlike the
reference, moduli the kernel does not take raise instead of falling
back to the plain version, and the budget and beta come from the
logical K (the reference takes them from K padded to 16, which differs
only for K <= 8). The kernels zero-fill ragged edges themselves, so
nothing is padded and every shape reaches them.
"""

from __future__ import annotations

import torch

from repro_torch.core import complex3m, scheme1, scheme2
from repro_torch.kernels import decompose, ozaki1, ozaki2, ozaki3m
from repro_torch.kernels.backends.base import BackendCapabilities, KernelBackend
from repro_torch.kernels.common import Blocks

_CAPS = BackendCapabilities(
    schemes=frozenset({"ozaki1", "ozaki2"}),
    operand_dtypes=frozenset({torch.float32, torch.bfloat16, torch.float16,
                              torch.float64, torch.complex64,
                              torch.complex128}),
)

# The tile each scheme's plan names: Scheme I's, whose K tile is the
# granularity of the 'interleaved' layout (the kernels choose their own
# tiles), and the plane GEMM of csrc/emugemm2_planes.cu, which runs every
# Scheme-II product with a float rhs, real or complex 3M.
KERNEL_BLOCKS = Blocks(bm=64, bn=64, bk=decompose.TILE)
SCHEME2_BLOCKS = Blocks(bm=ozaki2.PLANE_TILE[0], bn=ozaki2.PLANE_TILE[1],
                        bk=ozaki2.PLANE_K)


def choose_blocks_cuda(m: int, n: int, k: int, p: int,
                       scheme: str = "ozaki1") -> Blocks | None:
    """The kernel's tile for an (m, k) @ (k, n) problem at slice count
    (Scheme I) or modulus count (Scheme II) p, or None when the kernel
    has no instance for p."""
    del m, n, k
    if scheme in ("ozaki2", "ozaki2-3m"):
        if not 1 <= p <= ozaki2.MAX_MODULI:
            return None
        return SCHEME2_BLOCKS
    return KERNEL_BLOCKS if 1 <= p <= ozaki1.MAX_P else None


def scales(a: torch.Tensor, b: torch.Tensor):
    """mu (..., M, 1) and nu (..., 1, N): power-of-two row scales of a
    and column scales of b, as the kernel takes them."""
    from repro_torch.core import scheme1
    return scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)


def scheme2_operands(a: torch.Tensor, b: torch.Tensor, moduli):
    """(a, b, mu, nu) as the Scheme-II kernel takes them: K checked
    against the int32 bound, each operand in its own float type, the
    scales at the budget of the lhs type."""
    scheme2.check_exact_k(a.shape[-1], moduli)
    a, b = scheme2.operand(a), scheme2.operand(b)
    return (a, b, *scheme2.scales(a, b, moduli))


class CudaBackend(KernelBackend):
    name = "cuda"

    @property
    def capabilities(self) -> BackendCapabilities:
        return _CAPS

    def choose_blocks(self, m, n, k, p, *, scheme="ozaki1"):
        return choose_blocks_cuda(m, n, k, p, scheme)

    def matmul(self, a, b, cfg, out_dtype, blocks):
        self.check(cfg, a, b)
        if a.is_complex() or b.is_complex():
            return self._matmul_complex(a, b, cfg, out_dtype, blocks)
        if cfg.scheme == "ozaki2":
            moduli = cfg.resolved_moduli()
            ozaki2.check_moduli(moduli)
            a, b, mu, nu = scheme2_operands(a, b, moduli)
            return ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli,
                                               out_dtype)
        # float16 widens to float32 (bf16 stays: the kernels widen it).
        a, b = (x.float() if x.dtype == torch.float16 else x for x in (a, b))
        if a.dtype != b.dtype:
            common = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(common), b.to(common)
        beta = cfg.resolved_beta(a.shape[-1])
        mu, nu = scales(a, b)
        return ozaki1.fused_matmul_scheme1(a, b, mu, nu, cfg.p, beta,
                                           out_dtype)

    def _matmul_complex(self, a, b, cfg, out_dtype, blocks):
        """([Bt,] M, K) @ ([Bt,] K, N) with a complex operand -> complex:
        the 3M route under Scheme II (a batch on its batch coordinate);
        under Scheme I (2-D only), which has no complex kernel,
        C_re = Ar Br - Ai Bi and C_im = Ar Bi + Ai Br from four EmuGEMM-I
        launches (4M, as the reference's dispatcher runs it: of float64
        parts for complex128)."""
        if cfg.scheme == "ozaki2":
            moduli = cfg.resolved_moduli()
            ozaki2.check_moduli(moduli)
            scheme2.check_exact_k(a.shape[-1], moduli)
            mu, nu = complex3m.scales(a, b, moduli)
            return ozaki3m.fused_matmul_3m(a, b, mu, nu, moduli, out_dtype)
        ar, ai = scheme1.complex_parts(a)
        br, bi = scheme1.complex_parts(b)
        rr, ii, ri, ir = (self.matmul(x, y, cfg, out_dtype, blocks)
                          for x, y in ((ar, br), (ai, bi), (ar, bi), (ai, br)))
        return torch.complex(rr - ii, ri + ir)

    def matmul_mixed(self, a, b_hat, mu, nu, p, beta, out_dtype):
        return ozaki1.fused_matmul_mixed(a, b_hat, mu, nu, p, beta, out_dtype)

    def matmul_prepared_residues(self, a, b_res, mu, nu, moduli, out_dtype,
                                 n):
        ozaki2.check_moduli(moduli)
        return ozaki2.fused_matmul_scheme2_prepared(a, b_res, mu, nu, moduli,
                                                    out_dtype, n)
