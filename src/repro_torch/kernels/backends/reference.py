"""The 'torch' backend: the plain versions, in the role of the reference's
'xla' backend.

It runs Scheme I as separate torch ops (``ozaki1.fused_matmul_plain``,
which is ``repro_torch.core.scheme1``, and the prepared-weight kernels'
plain versions) on whatever device the operands are on. A CUDA tensor
reaches it only when it is asked for by name, as the bit-parity checks
do.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decompose, ozaki1
from repro_torch.kernels.backends.base import BackendCapabilities, KernelBackend
from repro_torch.kernels.backends.cuda import scales

_CAPS = BackendCapabilities(
    schemes=frozenset({"ozaki1"}),
    operand_dtypes=frozenset({torch.float32, torch.bfloat16, torch.float16,
                              torch.float64}),
)


class TorchBackend(KernelBackend):
    name = "torch"

    @property
    def capabilities(self) -> BackendCapabilities:
        return _CAPS

    def choose_blocks(self, m, n, k, p):
        return None          # no tiles: whole-array torch ops

    def matmul(self, a, b, cfg, out_dtype, blocks):
        self.check(cfg, a, b)
        beta = cfg.resolved_beta(a.shape[-1])
        mu, nu = scales(a, b)
        return ozaki1.fused_matmul_plain(a, b, mu, nu, cfg.p, beta, out_dtype)

    def decompose(self, b, nu, tau, p, beta_f, beta_b):
        if tau is None:
            return decompose.decompose_rhs_plain(b, nu, p, beta_f), None
        return decompose.decompose_pair_plain(b, nu, tau, p, beta_f, beta_b)

    def matmul_mixed(self, a, b_hat, mu, nu, p, beta, out_dtype):
        return ozaki1.fused_matmul_mixed_plain(a, b_hat, mu, nu, p, beta,
                                               out_dtype)
