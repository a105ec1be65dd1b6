"""KernelBackend interface of the port (``repro.kernels.backends.base``).

A backend owns how an emulated GEMM runs: which schemes and operand
types it takes, how it plans tiles, and the 2-D and strided-batched
matmuls. The registry in :mod:`repro_torch.kernels.backends` maps names
('torch', 'cuda') to instances.
"""

from __future__ import annotations

import abc
import dataclasses

import torch

from repro_torch.kernels.common import Blocks


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a backend runs: its Ozaki schemes and operand types (Scheme
    II narrows the real ones to float32, bfloat16 and float64 on both
    backends, ``repro_torch.core.scheme2.operand``; a complex operand runs
    as 3M under Scheme II and as 4M under Scheme I).
    Both built-in backends take every shape as it is (the CUDA kernel
    masks ragged edges itself), so, unlike the reference, there is no
    alignment to pad to."""
    schemes: frozenset
    operand_dtypes: frozenset


class KernelBackend(abc.ABC):
    name: str

    @property
    @abc.abstractmethod
    def capabilities(self) -> BackendCapabilities:
        ...

    @abc.abstractmethod
    def choose_blocks(self, m: int, n: int, k: int, p: int, *,
                      scheme: str = "ozaki1") -> Blocks | None:
        """Tiles for an (m, k) @ (k, n) problem with ``p`` slices (Scheme
        I) or moduli (Scheme II), or None."""

    @abc.abstractmethod
    def matmul(self, a: torch.Tensor, b: torch.Tensor, cfg, out_dtype,
               blocks: Blocks | None) -> torch.Tensor:
        """(M, K) @ (K, N), or strided-batched (B, M, K) @ (B, K, N) in
        one launch, under ``cfg``."""

    @abc.abstractmethod
    def matmul_mixed(self, a: torch.Tensor, b_hat: torch.Tensor,
                     mu: torch.Tensor, nu: torch.Tensor, p: int, beta: int,
                     out_dtype) -> torch.Tensor:
        """(M, K) float @ a prepared weight's int8 slices in the layout
        this backend prepares ('planes' on 'cuda', 'interleaved' on
        'torch'); see ``repro_torch.kernels.ozaki1.fused_matmul_mixed``."""

    @abc.abstractmethod
    def matmul_prepared_residues(self, a: torch.Tensor, b_res: torch.Tensor,
                                 mu: torch.Tensor, nu: torch.Tensor, moduli,
                                 out_dtype, n: int) -> torch.Tensor:
        """(M, K) float @ a prepared weight's (p, Kp, Np) int8 residues
        -> (M, n); see
        ``repro_torch.kernels.ozaki2.fused_matmul_scheme2_prepared``."""

    def check(self, cfg, a: torch.Tensor, b: torch.Tensor) -> None:
        """Raise unless this backend runs ``cfg`` on these operands."""
        caps = self.capabilities
        if cfg.scheme not in caps.schemes:
            raise NotImplementedError(
                f"backend {self.name!r} has no {cfg.scheme} kernel; it runs "
                f"{sorted(caps.schemes)}")
        for x in (a, b):
            if x.dtype not in caps.operand_dtypes:
                raise NotImplementedError(
                    f"backend {self.name!r} takes "
                    f"{sorted(str(d) for d in caps.operand_dtypes)} operands, "
                    f"got {x.dtype}")
