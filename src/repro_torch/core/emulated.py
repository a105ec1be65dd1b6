"""Emulated GEMM front end of the port (``repro.core.emulated``).

``emulated_dot(a, b, cfg)`` computes a @ b under the emulation selected by
``cfg``: 'native' is a plain matmul, 'ozaki1' the Scheme-I and 'ozaki2' the
Scheme-II emulation on the selected kernel backend. Leading batch dims of
``a`` flatten into M. Operands may be float64 or complex (Scheme II: 3M;
Scheme I: 4M).

Both front doors are differentiable through ``torch.autograd.Function``s
that mirror the reference's custom VJPs: dA = dC B^T and dB = A^T dC run
through the same emulated GEMM, at ``cfg.bwd_p`` slices (or moduli) when
it is set. With ``cfg.cache_weights`` (``+cached``) the forward prepares
B once (Scheme I: forward slices plus the K-transposed twin, from one
read; Scheme II: balanced residues of B and of B^T) and the backward's
dA consumes the twin. Only a, b and the twin's tensors are saved for the
backward, through ``save_for_backward``, so activation checkpointing
discards and recomputes them (the recompute prepares B again, as the
reference's remat does). :func:`emulated_dot_prepared` takes a weight
prepared once per optimizer step instead (``kernels.prepared.
StepPrepared``): its forward and dA consume the prep, which a recompute
does not build again, and dB reaches the float weight.

As in the reference, a call that is not differentiated (no grad mode, or
no operand requiring grad) runs the plain forward, which prepares
nothing: ``+cached`` only changes how a differentiated step runs, never
its bits.

A ``+guard`` config routes every 2-D product (``_dot_2d``: the forward
and both backward GEMMs) through the guard's ladder
(``repro_torch.guard``), and is never cached: the ladder may re-plan the
slice count, which a weight prepared up front would pin. The backward
re-enters the telemetry call site its forward ran under
(``telemetry.site_scope``), as the reference's rules carry it.

Complex gradients. The reference's VJP transposes without conjugating:
given the cotangent g it returns g B^T and A^T g, JAX's convention for a
holomorphic product. PyTorch's complex autograd passes and expects the
conjugate Wirtinger gradient, g B^H and A^H g. So for a complex problem
the backward runs the reference's VJP on conj(g) and conjugates what it
returns: the port's gradient is conj(ref_vjp(conj(g))), bit for bit
(conjugation is exact, and the same emulated GEMMs run on the same
operands). A real operand of a complex product takes the real part, as
the reference's cast to its type does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import NATIVE, EmulationConfig
from repro_torch.telemetry import record as _tele


def _out_dtype(cfg: EmulationConfig, a, b) -> torch.dtype:
    return (getattr(torch, cfg.out_dtype) if cfg.out_dtype
            else torch.promote_types(a.dtype, b.dtype))


def prepared_dot(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """x: (..., K) @ a prepared w (PreparedOperand or PreparedResidues):
    (K, N) -> (..., N)."""
    from repro_torch.kernels import prepared
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, torch.float32)
    lead = x.shape[:-1]
    out = prepared.matmul_prepared(x.reshape(-1, x.shape[-1]), w,
                                   out_dtype=out_dtype)
    return out.reshape(*lead, w.n)


def _cacheable(a, b, cfg: EmulationConfig) -> bool:
    # Scheme I caches int8 slices, Scheme II balanced residues; complex
    # problems run the 4M / 3M expansions, never a prepared operand. A
    # guarded call is never cached (module doc).
    return (cfg.scheme in ("ozaki1", "ozaki2") and cfg.cache_weights
            and cfg.guard is None and b.dim() == 2 and not a.is_complex()
            and not b.is_complex())


def _dot_2d(a: torch.Tensor, b: torch.Tensor,
            cfg: EmulationConfig) -> torch.Tensor:
    """Dispatch a single (M, K) @ (K, N) according to cfg."""
    if (cfg.guard is not None and cfg.scheme != "native"
            and not a.is_complex() and not b.is_complex()):
        # The guard seam of the front doors and both backward GEMMs: the
        # ladder re-enters _dot_2d with the guard stripped for every rung.
        from repro_torch.guard import ladder
        return ladder.guarded_dot_2d(a, b, cfg)
    if cfg.scheme == "native":
        out_dtype = _out_dtype(cfg, a, b)
        return torch.matmul(a.to(out_dtype), b.to(out_dtype))
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


def _save_with_twin(ctx, a, b, twin) -> None:
    """Save a, b and the twin's tensors through save_for_backward (so
    that activation checkpointing can drop them); the twin's metadata
    stays on ctx."""
    from repro_torch.kernels import prepared
    ctx.twin, tensors = prepared.split_tensors(twin)
    ctx.save_for_backward(a, b, *tensors)


def _as_grad(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A reference-convention cotangent ``x`` for an operand ``like``:
    conjugated when the problem is complex (module doc), in ``like``'s
    type (a real operand takes the real part)."""
    if x.is_complex():
        x = torch.conj_physical(x)
        if not like.is_complex():
            x = x.real
    return x.to(like.dtype)


def _bwd_core(ctx, g):
    """Shared backward (the reference's ``_bwd_core``): dA = dC B^T from
    the twin when one was saved, else through the emulated GEMM; dB =
    A^T dC; of a complex problem, conj(g) in and the results conjugated
    (module doc), under the forward's telemetry call site."""
    a, b, *twin_tensors = ctx.saved_tensors
    with _tele.site_scope(ctx.site):
        return _bwd_grads(ctx, a, b, twin_tensors, g)


def _bwd_grads(ctx, a, b, twin_tensors, g):
    from repro_torch.kernels import prepared
    if g.is_complex():
        g = torch.conj_physical(g)
    cfg = _bwd_cfg(ctx.cfg)
    a2 = a.reshape(-1, a.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    da = db = None
    if ctx.needs_input_grad[0]:
        if ctx.twin is not None:
            twin = prepared.join_tensors(ctx.twin, twin_tensors)
            da = prepared_dot(g2, twin, _out_dtype(cfg, g2, b))
        else:
            da = _dot_2d(g2, b.T, cfg)
        da = _as_grad(da.reshape(a.shape), a)
    if ctx.needs_input_grad[1]:
        db = _as_grad(_dot_2d(a2.T, g2, cfg), b)
    return da, db


class _EmulatedDot(torch.autograd.Function):
    """The reference's ``_emulated_dot`` custom VJP (``_fwd``, ``_bwd``,
    ``_bwd_core``)."""

    @staticmethod
    def forward(ctx, a, b, cfg):
        ctx.cfg, ctx.site = cfg, _tele.current_site()
        if not _cacheable(a, b, cfg):
            ctx.twin = None
            ctx.save_for_backward(a, b)
            return _flat_dot(a, b, cfg)
        # Encode the rhs once: forward layout + K-transposed twin.
        from repro_torch.kernels import prepared
        prep = prepared.prepare_rhs(b, cfg, with_twin=True)
        out = prepared_dot(a, prep, _out_dtype(cfg, a, b))
        _save_with_twin(ctx, a, b, prep.twin)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_bwd_core(ctx, g), None)


class _EmulatedDotPrepared(torch.autograd.Function):
    """The reference's ``_emulated_dot_prepared`` custom VJP: the forward
    from a prep built once per step, dA from its twin, dB to the float
    weight; the prep takes no gradient."""

    @staticmethod
    def forward(ctx, a, b, prep, cfg):
        ctx.cfg, ctx.site = cfg, _tele.current_site()
        out = prepared_dot(a, prep, _out_dtype(cfg, a, b))
        _save_with_twin(ctx, a, b, prep.twin)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_bwd_core(ctx, g), None, None)


def _differentiated(*xs) -> bool:
    """Will autograd record this call?"""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def emulated_dot(a: torch.Tensor, b: torch.Tensor,
                 cfg: EmulationConfig = NATIVE) -> torch.Tensor:
    """a: (..., K) float; b: (K, N) float -> (..., N)."""
    if _differentiated(a, b):
        return _EmulatedDot.apply(a, b, cfg)
    return _flat_dot(a, b, cfg)


def emulated_dot_prepared(a: torch.Tensor, b: torch.Tensor, prep,
                          cfg: EmulationConfig) -> torch.Tensor:
    """a: (..., K) @ b: (K, N), where ``prep`` is b's prepared operand
    (with its twin), built once per optimizer step: ``emulated_dot``
    under ``cfg.cache_weights`` without preparing again per microbatch
    or in the recompute."""
    if _differentiated(a, b):
        return _EmulatedDotPrepared.apply(a, b, prep, cfg)
    return prepared_dot(a, prep, _out_dtype(cfg, a, b))


# ---------------------------------------------------------------------------
# Strided-batched contractions: one launch over the whole stack.
# ---------------------------------------------------------------------------

def _batched(a, b, cfg):
    from repro_torch.kernels import dispatch
    if cfg.scheme != "native" and cfg.impl == "xla":
        return dispatch.emulated_matmul_batched(a, b, cfg=cfg,
                                                backend="torch")
    return dispatch.emulated_matmul_batched(a, b, cfg=cfg)


class _EmulatedDotBatched(torch.autograd.Function):
    """The reference's ``_emulated_dot_batched`` custom VJP: both backward
    GEMMs are again one strided-batched launch (the transposes are
    strided views, not copies)."""

    @staticmethod
    def forward(ctx, a, b, cfg):
        ctx.cfg, ctx.site = cfg, _tele.current_site()
        ctx.save_for_backward(a, b)
        return _batched(a, b, cfg)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        cfg = _bwd_cfg(ctx.cfg)
        if g.is_complex():
            g = torch.conj_physical(g)
        da = db = None
        with _tele.site_scope(ctx.site):
            if ctx.needs_input_grad[0]:
                da = _as_grad(_batched(g, b.transpose(-1, -2), cfg), a)
            if ctx.needs_input_grad[1]:
                db = _as_grad(_batched(a.transpose(-1, -2), g, cfg), b)
        return da, db, None


def emulated_dot_batched(a: torch.Tensor, b: torch.Tensor,
                         cfg: EmulationConfig = NATIVE) -> torch.Tensor:
    """a: (..., B, M, K) @ b: (..., B, K, N), matching leading axes ->
    (..., B, M, N) as ONE strided-batched launch; differentiable."""
    if _differentiated(a, b):
        return _EmulatedDotBatched.apply(a, b, cfg)
    return _batched(a, b, cfg)


def emulated_einsum_proj(x: torch.Tensor, w: torch.Tensor,
                         cfg: EmulationConfig = NATIVE) -> torch.Tensor:
    """Convenience for '...k,kn->...n' projections used by the model zoo."""
    return emulated_dot(x, w, cfg)
