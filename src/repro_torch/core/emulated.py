"""Emulated GEMM front end of the port, forward only
(``repro.core.emulated``).

``emulated_dot(a, b, cfg)`` computes a @ b under the emulation selected by
``cfg``: 'native' is a plain matmul, 'ozaki1' the Scheme-I emulation on the
selected kernel backend. Leading batch dims of ``a`` flatten into M.
Serving never differentiates; the ``torch.autograd.Function`` with the
reference's custom VJP comes with the training slice (ROADMAP.md § 1).
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import NATIVE, EmulationConfig


def _dot_2d(a: torch.Tensor, b: torch.Tensor,
            cfg: EmulationConfig) -> torch.Tensor:
    """Dispatch a single (M, K) @ (K, N) according to cfg."""
    if cfg.scheme == "native":
        out_dtype = (getattr(torch, cfg.out_dtype) if cfg.out_dtype
                     else torch.promote_types(a.dtype, b.dtype))
        return torch.matmul(a.to(out_dtype), b.to(out_dtype))
    if cfg.scheme != "ozaki1":
        raise NotImplementedError(
            f"{cfg.scheme} is not ported yet (ROADMAP.md § 1 item 3)")
    from repro_torch.kernels import dispatch
    if cfg.impl in ("auto", "pallas"):
        return dispatch.auto_fused_matmul(a, b, cfg)
    # impl='xla': the reference expansion, which is the plain version.
    out_dtype = (getattr(torch, cfg.out_dtype) if cfg.out_dtype
                 else torch.promote_types(a.dtype, b.dtype))
    return dispatch.emulated_matmul(a, b, cfg=cfg, out_dtype=out_dtype,
                                    backend="torch")


def emulated_dot(a: torch.Tensor, b: torch.Tensor,
                 cfg: EmulationConfig = NATIVE) -> torch.Tensor:
    """a: (..., K) float; b: (K, N) float -> (..., N)."""
    lead = a.shape[:-1]
    out = _dot_2d(a.reshape(-1, a.shape[-1]), b, cfg)
    return out.reshape(*lead, b.shape[-1])


def emulated_dot_batched(a: torch.Tensor, b: torch.Tensor,
                         cfg: EmulationConfig = NATIVE) -> torch.Tensor:
    """a: (..., B, M, K) @ b: (..., B, K, N), matching leading axes ->
    (..., B, M, N) as ONE strided-batched launch."""
    from repro_torch.kernels import dispatch
    if cfg.scheme == "ozaki1" and cfg.impl == "xla":
        return dispatch.emulated_matmul_batched(a, b, cfg=cfg,
                                                backend="torch")
    return dispatch.emulated_matmul_batched(a, b, cfg=cfg)

