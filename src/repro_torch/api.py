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
  with batch axes, onto the strided-batched core. ``einsum`` takes what
  the reference's does: ellipses, an implicit output, free axes summed
  out of one operand (summed before the product) and size-1
  broadcasting; a label repeated within one operand (a diagonal) and
  more than two operands raise ``ValueError``. The rhs may be a prepared
  operand (``kernels.prepared``) of the config's scheme, in its fixed
  (K, N) layout: ``(((k,), (0,)), ((), ()))``, or ``'...k,kn->...n'``-
  shaped subscripts.
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


def _sharded_2d(a2, b, cfg, mesh):
    """(..., K) @ (K, N), both whole on every rank, partitioned over a
    live multi-device ``mesh`` (``parallel.shard_gemm.sharded_dense``)
    when the config emulates on the kernel route; None means not
    partitioned here, and the caller takes the unsharded route. A guard
    verifies each rank's tile, the ranks agreeing on every verdict
    (``guard.ladder.consensus``); a guarded prepared rhs, whose guard
    reconstructs the whole weight, runs unsharded."""
    if mesh is None:
        return None
    from repro_torch.kernels import dispatch
    if (not dispatch._shardable_mesh(mesh) or cfg.scheme == "native"
            or cfg.impl == "xla"
            or (cfg.guard is not None and dispatch._is_prepared(b))):
        return None
    from repro_torch.parallel import shard_gemm
    return shard_gemm.sharded_dense(a2, b, cfg, mesh)


def _dot_general_prepared(a, b, dimension_numbers, cfg, out_dtype,
                          mesh=None):
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
    out = _sharded_2d(a, b, cfg, mesh)
    if out is not None:
        return out.to(out_dtype)
    if cfg.guard is not None:
        # Guarded prepared consumption goes through the dispatcher's guard
        # seam (verification reconstructs the dense weight).
        from repro_torch.kernels import dispatch
        lead = a.shape[:-1]
        out = dispatch.emulated_matmul(a.reshape(-1, a.shape[-1]), b,
                                       cfg=cfg, out_dtype=out_dtype)
        return out.reshape(*lead, b.n)
    return prepared_dot(a, b, out_dtype=out_dtype)


def dot_general(a: torch.Tensor, b, dimension_numbers, *,
                precision: str | EmulationConfig | None = None,
                out_dtype=None, backend: str | None = None,
                mesh=None) -> torch.Tensor:
    """Emulated ``lax.dot_general``: the output is laid out
    ``(*batch, *lhs_free, *rhs_free)``.

    The contraction canonicalizes to lhs (batch..., free..., K) and rhs
    (batch..., K, N); without batch axes it runs on the 2-D core, with
    them the lhs free axes fold into M and the whole stack runs as ONE
    strided-batched launch. A prepared ``b`` runs on the backend it was
    prepared for. ``mesh`` (a live multi-device mesh, ``launch.mesh``,
    both operands whole on every rank) partitions the 2-D core over its
    ranks (``parallel.shard_gemm.sharded_dense``) where a mesh axis
    divides it.
    """
    from repro_torch.core.emulated import emulated_dot, emulated_dot_batched
    from repro_torch.kernels.dispatch import _is_prepared
    cfg = resolve_config(precision)
    if _is_prepared(b):
        return _dot_general_prepared(a, b, dimension_numbers, cfg, out_dtype,
                                     mesh)
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
        out = _sharded_2d(a2, b2, cfg, mesh)
        if out is None:
            out = emulated_dot(a2, b2, cfg)
    else:
        bsz = math.prod(batch_shape)
        out = emulated_dot_batched(a2.reshape(bsz, -1, k),
                                   b2.reshape(bsz, k, n), cfg)
    return out.reshape(batch_shape + a_free_shape + b_free_shape)


_EINSUM_HINT = ("repro_torch.einsum covers two-operand contractions "
                "without repeated in-operand labels; use torch.einsum for "
                "diagonals/traces and more than two operands")


def _expand_operand(part: str, ndim: int, what: str) -> list[str]:
    """One operand's subscript -> per-axis labels ('...<i>' for the
    ellipsis axes, right-aligned as numpy's)."""
    if part.count(".") not in (0, 3) or (".." in part and "..." not in part):
        raise ValueError(f"bad ellipsis in {what} subscript {part!r}")
    if "..." in part:
        head, _, tail = part.partition("...")
        n_ell = ndim - len(head) - len(tail)
        if n_ell < 0:
            raise ValueError(f"{what} subscript {part!r} names more axes "
                             f"than the rank-{ndim} operand has")
        labels = (list(head) + [f"...{i}" for i in range(-n_ell, 0)]
                  + list(tail))
    else:
        if len(part) != ndim:
            raise ValueError(f"{what} subscript {part!r} names {len(part)} "
                             f"axes for a rank-{ndim} operand")
        labels = list(part)
    for lab in labels:
        if len(lab) == 1 and not lab.isalpha():
            raise ValueError(f"bad label {lab!r} in {what} subscript "
                             f"{part!r}")
    single = [lab for lab in labels if len(lab) == 1]
    if len(set(single)) != len(single):
        raise ValueError(f"repeated label in {what} subscript {part!r} (a "
                         f"diagonal); {_EINSUM_HINT}")
    return labels


def _parse_einsum(subscripts: str, a_ndim: int, b_ndim: int):
    """'bik,bkj->bij' -> (a_labels, b_labels, out_labels), raising
    ``ValueError`` where the reference does."""
    s = subscripts.replace(" ", "")
    ins, arrow, out = s.partition("->")
    parts = ins.split(",")
    if len(parts) != 2:
        raise ValueError(f"einsum takes exactly two operands; got "
                         f"{len(parts)} in {subscripts!r} ({_EINSUM_HINT})")
    a_labels = _expand_operand(parts[0], a_ndim, "lhs")
    b_labels = _expand_operand(parts[1], b_ndim, "rhs")
    ell = [lab for lab in a_labels + b_labels if lab.startswith("...")]
    ell_out = sorted(set(ell), key=lambda lab: int(lab[3:]))
    if not arrow:
        # numpy's implicit output: the ellipsis axes, then the letters
        # that appear exactly once across both operands, in order.
        letters = [lab for lab in a_labels + b_labels
                   if not lab.startswith("...")]
        return a_labels, b_labels, ell_out + sorted(
            lab for lab in set(letters) if letters.count(lab) == 1)
    if "..." in out:
        head, _, tail = out.partition("...")
        out_labels = list(head) + ell_out + list(tail)
    else:
        if ell_out:
            raise ValueError(f"output subscript of {subscripts!r} drops "
                             f"ellipsis dims; {_EINSUM_HINT}")
        out_labels = list(out)
    if len(set(out_labels)) != len(out_labels):
        raise ValueError(f"repeated output label in {subscripts!r}")
    for lab in out_labels:
        if lab not in a_labels and lab not in b_labels:
            raise ValueError(f"output label {lab!r} of {subscripts!r} "
                             "appears in neither operand")
    return a_labels, b_labels, out_labels


def _presum(x: torch.Tensor, labels, other, out):
    """Sum out the free axes the output drops (``'ij,jk->k'`` sums i):
    they do not meet the contraction. The terms add one at a time in
    index order (row-major over the dropped axes), the order of the
    reference's reduction on the CPU, so the emulated product that
    follows gets the same operand bit for bit."""
    drop = [i for i, lab in enumerate(labels)
            if lab not in other and lab not in out]
    if not drop:
        return x, labels
    keep = [i for i in range(x.dim()) if i not in drop]
    kept = tuple(x.shape[i] for i in keep)
    total = torch.zeros(kept, dtype=x.dtype, device=x.device)
    for term in x.permute(drop + keep).reshape((-1,) + kept).unbind(0):
        total = total + term
    return total, [labels[i] for i in keep]


def einsum(subscripts: str, a: torch.Tensor, b, *,
           precision: str | EmulationConfig | None = None,
           out_dtype=None, backend: str | None = None,
           mesh=None) -> torch.Tensor:
    """Emulated two-operand einsum through :func:`dot_general`.

    Shared labels kept in the output are batch axes, shared labels
    dropped from it are contracted, free labels the output drops are
    summed out of their operand first, and a size-1 axis meeting a
    larger one under the same label broadcasts; e.g. ``bqkgd,bjkd->bkgqj``
    (attention scores), ``...k,kn->...n``, ``ij,jk`` (implicit output
    ``ik``). A prepared ``b`` takes ``...k,kn->...n``-shaped subscripts.
    ``mesh`` as in :func:`dot_general`.
    """
    from repro_torch.kernels.dispatch import _is_prepared
    prep = _is_prepared(b)
    a_labels, b_labels, out_labels = _parse_einsum(
        subscripts, a.dim(), 2 if prep else b.dim())
    a_set, b_set, out_set = set(a_labels), set(b_labels), set(out_labels)
    if prep:
        k, n = b_labels
        if not (k in a_set and k not in out_set and n in out_set
                and n not in a_set):
            raise ValueError(
                f"a prepared rhs supports only '...k,kn->...n'-shaped "
                f"subscripts (fixed (K, N) layout); got {subscripts!r}")
        a, a_labels = _presum(a, a_labels, b_set, out_set)
        out = dot_general(a, b, (((a_labels.index(k),), (0,)), ((), ())),
                          precision=precision, out_dtype=out_dtype,
                          backend=backend, mesh=mesh)
        canon = [lab for lab in a_labels if lab != k] + [n]
    else:
        a, a_labels = _presum(a, a_labels, b_set, out_set)
        b, b_labels = _presum(b, b_labels, a_set, out_set)
        shared = [lab for lab in a_labels if lab in b_labels]
        batch = [lab for lab in shared if lab in out_set]
        contract = [lab for lab in shared if lab not in out_set]
        lc = tuple(a_labels.index(lab) for lab in contract)
        rc = tuple(b_labels.index(lab) for lab in contract)
        lb = tuple(a_labels.index(lab) for lab in batch)
        rb = tuple(b_labels.index(lab) for lab in batch)
        # A size-1 axis meeting a larger one under the same label
        # broadcasts, as in einsum; dot_general stays strict.
        a_shape, b_shape = list(a.shape), list(b.shape)
        for dl, dr in zip(lb + lc, rb + rc):
            if a_shape[dl] == 1 and b_shape[dr] != 1:
                a_shape[dl] = b_shape[dr]
            elif b_shape[dr] == 1 and a_shape[dl] != 1:
                b_shape[dr] = a_shape[dl]
        if a_shape != list(a.shape):
            a = a.expand(a_shape).contiguous()
        if b_shape != list(b.shape):
            b = b.expand(b_shape).contiguous()
        out = dot_general(a, b, ((lc, rc), (lb, rb)), precision=precision,
                          out_dtype=out_dtype, backend=backend, mesh=mesh)
        canon = (batch + [lab for lab in a_labels if lab not in shared]
                 + [lab for lab in b_labels if lab not in shared])
    if canon != out_labels:
        out = out.permute(tuple(canon.index(lab) for lab in out_labels))
    return out
