"""The 'torch' backend: the plain versions, in the role of the reference's
'xla' backend.

It runs Scheme I as separate torch ops (``ozaki1.fused_matmul_plain``,
which is ``repro_torch.core.scheme1``, and the prepared-weight kernels'
plain versions) and Scheme II likewise
(``ozaki2.fused_matmul_scheme2_plain``, which is
``repro_torch.core.scheme2.matmul``'s pipeline, for any moduli set, and
``fused_matmul_scheme2_prepared_plain`` for a prepared weight), and
complex GEMMs as ``scheme1.matmul_complex_4m`` and
``complex3m.matmul``, on whatever device the operands are on. A CUDA tensor
reaches it only when it is asked for by name, as the bit-parity checks
do.
"""

from __future__ import annotations

import torch

from repro_torch.core import complex3m, scheme1
from repro_torch.kernels import ozaki1, ozaki2
from repro_torch.kernels.backends.base import BackendCapabilities, KernelBackend
from repro_torch.kernels.backends.cuda import scales, scheme2_operands

_CAPS = BackendCapabilities(
    schemes=frozenset({"ozaki1", "ozaki2"}),
    operand_dtypes=frozenset({torch.float32, torch.bfloat16, torch.float16,
                              torch.float64, torch.complex64,
                              torch.complex128}),
)


class TorchBackend(KernelBackend):
    name = "torch"

    @property
    def capabilities(self) -> BackendCapabilities:
        return _CAPS

    def choose_blocks(self, m, n, k, p, *, scheme="ozaki1"):
        return None          # no tiles: whole-array torch ops

    def matmul(self, a, b, cfg, out_dtype, blocks):
        self.check(cfg, a, b)
        if a.is_complex() or b.is_complex():
            if cfg.scheme == "ozaki2":
                return complex3m.matmul(a, b, cfg, out_dtype)
            return scheme1.matmul_complex_4m(a, b, cfg, out_dtype)
        if cfg.scheme == "ozaki2":
            moduli = cfg.resolved_moduli()
            a, b, mu, nu = scheme2_operands(a, b, moduli)
            return ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli,
                                                     out_dtype)
        beta = cfg.resolved_beta(a.shape[-1])
        mu, nu = scales(a, b)
        return ozaki1.fused_matmul_plain(a, b, mu, nu, cfg.p, beta, out_dtype)

    def matmul_mixed(self, a, b_hat, mu, nu, p, beta, out_dtype):
        return ozaki1.fused_matmul_mixed_plain(a, b_hat, mu, nu, p, beta,
                                               out_dtype)

    def matmul_prepared_residues(self, a, b_res, mu, nu, moduli, out_dtype,
                                 n):
        return ozaki2.fused_matmul_scheme2_prepared_plain(
            a, b_res, mu, nu, moduli, out_dtype, n)
