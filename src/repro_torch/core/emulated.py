"""Emulated GEMM front end of the port (``repro.core.emulated``).

``emulated_dot(a, b, cfg)`` computes a @ b under the emulation selected by
``cfg``: 'native' is a plain matmul, 'ozaki1' the Scheme-I emulation on the
selected kernel backend. Leading batch dims of ``a`` flatten into M.

Both front doors are differentiable through ``torch.autograd.Function``s
that mirror the reference's custom VJPs: dA = dC B^T and dB = A^T dC run
through the same emulated GEMM, at ``cfg.bwd_p`` slices when it is set.
With ``cfg.cache_weights`` (``+cached``) the forward prepares B once
(forward slices plus the K-transposed twin, from one read) and the
backward's dA consumes the twin. Only (a, b, twin) are saved for the
backward, through ``save_for_backward``, so activation checkpointing
discards and recomputes them (the recompute prepares B again, as the
reference's remat does).

As in the reference, a call that is not differentiated (no grad mode, or
no operand requiring grad) runs the plain forward, which prepares
nothing: ``+cached`` only changes how a differentiated step runs, never
its bits.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import NATIVE, EmulationConfig


def _out_dtype(cfg: EmulationConfig, a, b) -> torch.dtype:
    return (getattr(torch, cfg.out_dtype) if cfg.out_dtype
            else torch.promote_types(a.dtype, b.dtype))


def prepared_dot(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """x: (..., K) @ a PreparedOperand w: (K, N) -> (..., N)."""
    from repro_torch.kernels import prepared
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, torch.float32)
    lead = x.shape[:-1]
    out = prepared.matmul_prepared(x.reshape(-1, x.shape[-1]), w,
                                   out_dtype=out_dtype)
    return out.reshape(*lead, w.n)


def _cacheable(a, b, cfg: EmulationConfig) -> bool:
    return (cfg.scheme == "ozaki1" and cfg.cache_weights and b.dim() == 2
            and not a.is_complex() and not b.is_complex())


def _dot_2d(a: torch.Tensor, b: torch.Tensor,
            cfg: EmulationConfig) -> torch.Tensor:
    """Dispatch a single (M, K) @ (K, N) according to cfg."""
    if cfg.scheme == "native":
        out_dtype = _out_dtype(cfg, a, b)
        return torch.matmul(a.to(out_dtype), b.to(out_dtype))
    if cfg.scheme != "ozaki1":
        raise NotImplementedError(
            f"{cfg.scheme} is not ported yet (ROADMAP.md § 1 item 3)")
    from repro_torch.kernels import dispatch
    if cfg.impl in ("auto", "pallas"):
        return dispatch.auto_fused_matmul(a, b, cfg)
    # impl='xla': the reference expansion, which is the plain version.
    return dispatch.emulated_matmul(a, b, cfg=cfg,
                                    out_dtype=_out_dtype(cfg, a, b),
                                    backend="torch")


def _bwd_cfg(cfg: EmulationConfig) -> EmulationConfig:
    if cfg.bwd_p and cfg.bwd_p != cfg.p:
        return dataclasses.replace(cfg, p=cfg.bwd_p)
    return cfg


def _flat_dot(a, b, cfg):
    lead = a.shape[:-1]
    return _dot_2d(a.reshape(-1, a.shape[-1]), b, cfg).reshape(
        *lead, b.shape[-1])


class _EmulatedDot(torch.autograd.Function):
    """The reference's ``_emulated_dot`` custom VJP (``_fwd``, ``_bwd``,
    ``_bwd_core``)."""

    @staticmethod
    def forward(ctx, a, b, cfg):
        ctx.cfg = cfg
        if not _cacheable(a, b, cfg):
            ctx.twin = None
            ctx.save_for_backward(a, b)
            return _flat_dot(a, b, cfg)
        # Decompose the rhs once: forward layout + K-transposed twin.
        from repro_torch.kernels import prepared
        prep = prepared.prepare_rhs(b, cfg, with_twin=True)
        out = prepared_dot(a, prep, _out_dtype(cfg, a, b))
        twin = prep.twin
        # The twin's tensors go through save_for_backward, so that
        # activation checkpointing can drop them; its metadata stays.
        ctx.twin = dataclasses.replace(twin, slices=None, scale=None)
        ctx.save_for_backward(a, b, twin.slices, twin.scale)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, *twin_tensors = ctx.saved_tensors
        cfg = _bwd_cfg(ctx.cfg)
        a2 = a.reshape(-1, a.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        da = db = None
        if ctx.needs_input_grad[0]:
            if ctx.twin is not None:
                twin = dataclasses.replace(ctx.twin, slices=twin_tensors[0],
                                           scale=twin_tensors[1])
                da_dtype = _out_dtype(cfg, g2, b)
                da = prepared_dot(g2, twin, da_dtype)
            else:
                da = _dot_2d(g2, b.T, cfg)
            da = da.reshape(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _dot_2d(a2.T, g2, cfg).to(b.dtype)
        return da, db, None


def _differentiated(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def emulated_dot(a: torch.Tensor, b: torch.Tensor,
                 cfg: EmulationConfig = NATIVE) -> torch.Tensor:
    """a: (..., K) float; b: (K, N) float -> (..., N)."""
    if _differentiated(a, b):
        return _EmulatedDot.apply(a, b, cfg)
    return _flat_dot(a, b, cfg)


# ---------------------------------------------------------------------------
# Strided-batched contractions: one launch over the whole stack.
# ---------------------------------------------------------------------------

def _batched(a, b, cfg):
    from repro_torch.kernels import dispatch
    if cfg.scheme == "ozaki1" and cfg.impl == "xla":
        return dispatch.emulated_matmul_batched(a, b, cfg=cfg,
                                                backend="torch")
    return dispatch.emulated_matmul_batched(a, b, cfg=cfg)


class _EmulatedDotBatched(torch.autograd.Function):
    """The reference's ``_emulated_dot_batched`` custom VJP: both backward
    GEMMs are again one strided-batched launch (the transposes are
    strided views, not copies)."""

    @staticmethod
    def forward(ctx, a, b, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(a, b)
        return _batched(a, b, cfg)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        cfg = _bwd_cfg(ctx.cfg)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _batched(g, b.transpose(-1, -2), cfg).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _batched(a.transpose(-1, -2), g, cfg).to(b.dtype)
        return da, db, None


def emulated_dot_batched(a: torch.Tensor, b: torch.Tensor,
                         cfg: EmulationConfig = NATIVE) -> torch.Tensor:
    """a: (..., B, M, K) @ b: (..., B, K, N), matching leading axes ->
    (..., B, M, N) as ONE strided-batched launch; differentiable."""
    if _differentiated(a, b):
        return _EmulatedDotBatched.apply(a, b, cfg)
    return _batched(a, b, cfg)
