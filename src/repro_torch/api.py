"""The port's precision front door (``repro.api``): specs, ambient scopes
and emulated einsum.

* :func:`precision` — a spec string (``"ozaki1-p4"``, ``"native"``, ...,
  the grammar of :meth:`EmulationConfig.parse`) or a config -> config.
* :func:`emulation` — a thread-local ambient scope; innermost wins.
* :func:`resolve_config` — THE resolver::

      explicit argument > innermost emulation() scope
                        > REPRO_TORCH_EMULATION env var > platform default

  The platform default is native.
* :func:`dot_general` / :func:`einsum` — emulated two-operand
  contractions, canonicalized (permute + reshape) onto the 2-D core or,
  with batch axes, onto the strided-batched core. Contractions the
  canonicalization cannot express (repeated labels, ellipses, summed
  free axes, broadcasting) raise. The rhs may be a prepared operand
  (``kernels.prepared``) of the config's scheme, in its fixed (K, N)
  layout: ``(((k,), (0,)), ((), ()))``, or ``'...k,kn->...n'``-shaped
  subscripts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import threading

import torch

from repro_torch.core.precision import NATIVE, EmulationConfig

__all__ = ["EMULATION_ENV_VAR", "precision", "emulation",
           "current_emulation", "resolve_config", "dot_general", "einsum"]

EMULATION_ENV_VAR = "REPRO_TORCH_EMULATION"


def precision(spec: str | EmulationConfig, /, **overrides) -> EmulationConfig:
    """Normalize a spec string or EmulationConfig into an EmulationConfig,
    with dataclass field ``overrides`` applied on top."""
    if isinstance(spec, EmulationConfig):
        cfg = spec
    elif isinstance(spec, str):
        cfg = EmulationConfig.parse(spec)
    else:
        raise TypeError("precision spec must be a str or EmulationConfig, "
                        f"got {type(spec).__name__}")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


_TLS = threading.local()


def _scope_stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


@functools.lru_cache(maxsize=32)
def _parse_env_spec(spec: str) -> EmulationConfig:
    return EmulationConfig.parse(spec)


@contextlib.contextmanager
def emulation(spec_or_cfg: str | EmulationConfig):
    """``with emulation("ozaki1-p4"): ...`` — every emulation-aware call
    inside that received no explicit config uses the scoped one."""
    cfg = precision(spec_or_cfg)
    stack = _scope_stack()
    stack.append(cfg)
    try:
        yield cfg
    finally:
        stack.pop()


def current_emulation() -> EmulationConfig | None:
    """The ambient config: innermost scope, else the env spec, else None."""
    stack = _scope_stack()
    if stack:
        return stack[-1]
    env = os.environ.get(EMULATION_ENV_VAR)
    if env:
        return _parse_env_spec(env)
    return None


def resolve_config(explicit: str | EmulationConfig | None = None, *,
                   default: str | EmulationConfig | None = None,
                   ) -> EmulationConfig:
    """The one emulation-config resolver (see the module doc)."""
    if explicit is not None:
        return precision(explicit)
    ambient = current_emulation()
    if ambient is not None:
        return ambient
    if default is not None:
        return precision(default)
    return NATIVE


# ---------------------------------------------------------------------------
# General contractions.
# ---------------------------------------------------------------------------

def _norm_dims(dims, ndim: int, what: str) -> tuple[int, ...]:
    out = tuple(int(d) % ndim for d in dims)
    if len(set(out)) != len(out):
        raise ValueError(f"repeated {what} dims {tuple(dims)}")
    return out


def _dot_general_prepared(a, b, dimension_numbers, cfg, out_dtype):
    """A prepared rhs: only (..., K) x prepared (K, N) exists, its layout
    fixed when it was prepared."""
    from repro_torch.core.emulated import prepared_dot
    from repro_torch.kernels.dispatch import check_prepared
    (lc, rc), (lb, rb) = dimension_numbers
    lc, rc, lb, rb = tuple(lc), tuple(rc), tuple(lb), tuple(rb)
    if lb or rb or rc != (0,) or len(lc) != 1:
        raise ValueError(
            "a prepared rhs supports only dimension_numbers "
            f"(((k,), (0,)), ((), ())); got {dimension_numbers} — "
            "prepare_rhs fixes the (K, N) layout")
    check_prepared(b, cfg)
    if not -a.dim() <= lc[0] < a.dim():
        raise ValueError(f"lhs contracting dim {lc[0]} out of range for "
                         f"rank-{a.dim()} operand")
    k_axis = lc[0] % a.dim()
    if a.shape[k_axis] != b.k:
        raise ValueError(f"lhs contracting dim {a.shape[k_axis]} vs "
                         f"prepared K={b.k}")
    a = a.movedim(k_axis, -1)
    if out_dtype is None and cfg.out_dtype is not None:
        out_dtype = getattr(torch, cfg.out_dtype)
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, torch.float32)
    return prepared_dot(a, b, out_dtype=out_dtype)


def dot_general(a: torch.Tensor, b, dimension_numbers, *,
                precision: str | EmulationConfig | None = None,
                out_dtype=None, backend: str | None = None) -> torch.Tensor:
    """Emulated ``lax.dot_general``: the output is laid out
    ``(*batch, *lhs_free, *rhs_free)``.

    The contraction canonicalizes to lhs (batch..., free..., K) and rhs
    (batch..., K, N); without batch axes it runs on the 2-D core, with
    them the lhs free axes fold into M and the whole stack runs as ONE
    strided-batched launch. A prepared ``b`` runs on the backend it was
    prepared for.
    """
    from repro_torch.core.emulated import emulated_dot, emulated_dot_batched
    from repro_torch.kernels.dispatch import _is_prepared
    cfg = resolve_config(precision)
    if _is_prepared(b):
        return _dot_general_prepared(a, b, dimension_numbers, cfg, out_dtype)
    if backend is not None:
        cfg = dataclasses.replace(cfg, backend=backend)
    if out_dtype is not None:
        cfg = dataclasses.replace(cfg, out_dtype=str(out_dtype).split(".")[-1])
    (lc, rc), (lb, rb) = dimension_numbers
    lc, lb = _norm_dims(lc, a.dim(), "lhs"), _norm_dims(lb, a.dim(), "lhs")
    rc, rb = _norm_dims(rc, b.dim(), "rhs"), _norm_dims(rb, b.dim(), "rhs")
    if len(lc) != len(rc) or len(lb) != len(rb):
        raise ValueError(f"dimension numbers {dimension_numbers} pair "
                         "unequal counts of lhs and rhs dims")
    for dl, dr in zip(lc + lb, rc + rb):
        if a.shape[dl] != b.shape[dr]:
            raise ValueError(f"lhs axis {dl} ({a.shape[dl]}) vs rhs axis "
                             f"{dr} ({b.shape[dr]})")
    a_free = tuple(d for d in range(a.dim()) if d not in lc and d not in lb)
    b_free = tuple(d for d in range(b.dim()) if d not in rc and d not in rb)
    batch_shape = tuple(a.shape[d] for d in lb)
    a_free_shape = tuple(a.shape[d] for d in a_free)
    b_free_shape = tuple(b.shape[d] for d in b_free)
    k = math.prod(a.shape[d] for d in lc)
    n = math.prod(b_free_shape)
    a2 = a.permute(lb + a_free + lc).reshape(batch_shape + a_free_shape + (k,))
    b2 = b.permute(rb + rc + b_free).reshape(batch_shape + (k, n))
    if not lb:
        out = emulated_dot(a2, b2, cfg)
    else:
        bsz = math.prod(batch_shape)
        out = emulated_dot_batched(a2.reshape(bsz, -1, k),
                                   b2.reshape(bsz, k, n), cfg)
    return out.reshape(batch_shape + a_free_shape + b_free_shape)


def _parse_einsum(subscripts: str, a_ndim: int, b_ndim: int):
    s = subscripts.replace(" ", "")
    ins, arrow, out = s.partition("->")
    parts = ins.split(",")
    if not arrow or len(parts) != 2 or "." in s:
        raise NotImplementedError(
            f"einsum {subscripts!r}: the port takes explicit two-operand "
            "subscripts without ellipses ('ab,bc->ac')")
    a_lab, b_lab, out_lab = parts[0], parts[1], out
    for lab, nd, what in ((a_lab, a_ndim, "lhs"), (b_lab, b_ndim, "rhs")):
        if len(lab) != nd:
            raise ValueError(f"{what} subscript {lab!r} names {len(lab)} "
                             f"axes for a rank-{nd} operand")
    for lab in (a_lab, b_lab, out_lab):
        if len(set(lab)) != len(lab):
            raise NotImplementedError(
                f"einsum {subscripts!r}: repeated labels are not supported")
    for lab in a_lab + b_lab:
        if lab not in out_lab and not (lab in a_lab and lab in b_lab):
            raise NotImplementedError(
                f"einsum {subscripts!r}: label {lab!r} is summed out of one "
                "operand only; the port contracts shared labels only")
    for lab in out_lab:
        if lab not in a_lab and lab not in b_lab:
            raise ValueError(f"output label {lab!r} of {subscripts!r} "
                             "appears in neither operand")
    return a_lab, b_lab, out_lab


def einsum(subscripts: str, a: torch.Tensor, b: torch.Tensor, *,
           precision: str | EmulationConfig | None = None,
           out_dtype=None, backend: str | None = None) -> torch.Tensor:
    """Emulated two-operand einsum through :func:`dot_general`.

    Shared labels kept in the output are batch axes, shared labels
    dropped from it are contracted, and every other label is a free
    axis; e.g. ``bqkgd,bjkd->bkgqj`` (attention scores) and
    ``bkgqj,bjkd->bkgqd`` (weighted values). A prepared ``b`` takes
    ``...k,kn->...n``-shaped subscripts.
    """
    from repro_torch.kernels.dispatch import _is_prepared
    if _is_prepared(b):
        a_lab, (k, n), out_lab = _parse_einsum(subscripts, a.dim(), 2)
        if not (k in a_lab and k not in out_lab and n in out_lab
                and n not in a_lab):
            raise ValueError(
                f"a prepared rhs supports only '...k,kn->...n'-shaped "
                f"subscripts (fixed (K, N) layout); got {subscripts!r}")
        out = dot_general(a, b, (((a_lab.index(k),), (0,)), ((), ())),
                          precision=precision, out_dtype=out_dtype)
        canon = [lab for lab in a_lab if lab != k] + [n]
        return out.permute(tuple(canon.index(x) for x in out_lab))
    a_lab, b_lab, out_lab = _parse_einsum(subscripts, a.dim(), b.dim())
    shared = [lab for lab in a_lab if lab in b_lab]
    batch = [lab for lab in shared if lab in out_lab]
    contract = [lab for lab in shared if lab not in out_lab]
    for lab in batch + contract:
        if a.shape[a_lab.index(lab)] != b.shape[b_lab.index(lab)]:
            raise NotImplementedError(
                f"einsum {subscripts!r}: label {lab!r} has sizes "
                f"{a.shape[a_lab.index(lab)]} and {b.shape[b_lab.index(lab)]}"
                " (broadcasting is not supported)")
    dnums = ((tuple(a_lab.index(x) for x in contract),
              tuple(b_lab.index(x) for x in contract)),
             (tuple(a_lab.index(x) for x in batch),
              tuple(b_lab.index(x) for x in batch)))
    out = dot_general(a, b, dnums, precision=precision, out_dtype=out_dtype,
                      backend=backend)
    canon = (batch + [x for x in a_lab if x not in shared]
             + [x for x in b_lab if x not in shared])
    if canon != list(out_lab):
        out = out.permute(tuple(canon.index(x) for x in out_lab))
    return out
