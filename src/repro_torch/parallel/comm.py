"""The collectives of the port's explicit SPMD, and their gradients.

Every rank holds the whole activations (``parallel.shard_gemm``), so a
partitioned product is a local tile and one collective:

* :func:`gather` concatenates the ranks' tiles along a dim. Under NCCL,
  and under gloo on CPU tensors, it is an all-gather; gloo has no
  all-gather for CUDA tensors (ranks that share one card), so there it is
  an all-reduce of a zero-filled full buffer viewed as integers (int32, or
  bytes when the size is not a multiple of 4), which adds zeros to every
  rank's bit patterns and is therefore a copy. Both give the same bits.
* :func:`all_reduce` sums float partials (row partitions, data-parallel
  gradients).

Under autograd (a training step) the gradients are those of replicated
activations: every rank computes the same cotangent downstream, so the
backward of a gather takes the rank's own slice, that of a sum passes the
cotangent through, and the input of a column product sums its partial
gradients over the group (:func:`copy_to`). Nothing here catches a
collective's failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group, axis_index, axis_sizes


def _n(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def byte_route(t: torch.Tensor, group) -> bool:
    """Is the gather of ``t`` on ``group`` the all-reduce of bytes?"""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def gather_raw(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """Every rank's ``t`` (one shape) concatenated along ``dim`` in the
    order of their coordinate on ``axes``."""
    n = _n(mesh, axes)
    if n == 1:
        return t
    group = axis_group(mesh, axes)
    t = t.contiguous()
    if byte_route(t, group):
        shape = list(t.shape)
        shape[dim] *= n
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        step = t.shape[dim]
        full.narrow(dim, axis_index(mesh, axes) * step, step).copy_(t)
        flat = full.view(-1).view(torch.uint8)
        if flat.numel() % 4 == 0:
            flat = flat.view(torch.int32)
        dist.all_reduce(flat, group=group)
        return full
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def slice_raw(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` (a view)."""
    n = _n(mesh, axes)
    if n == 1:
        return t
    step = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axes) * step, step)


def sum_raw(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``axes`` (a new tensor)."""
    if _n(mesh, axes) == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, group=axis_group(mesh, axes))
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return gather_raw(t, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return slice_raw(g, *ctx.args).contiguous(), None, None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return slice_raw(t, dim, mesh, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_raw(g, *ctx.args), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return sum_raw(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t

    @staticmethod
    def backward(ctx, g):
        return sum_raw(g, *ctx.args), None, None


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def gather(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """:func:`gather_raw`; its gradient is the rank's own slice."""
    if _n(mesh, axes) == 1:
        return t
    return _Gather.apply(t, dim, mesh, axes) if _grad(t) \
        else gather_raw(t, dim, mesh, axes)


def local_slice(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """:func:`slice_raw`; its gradient is gathered (every rank's slice)."""
    if _n(mesh, axes) == 1:
        return t
    return _Slice.apply(t, dim, mesh, axes) if _grad(t) \
        else slice_raw(t, dim, mesh, axes)


def all_reduce(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:func:`sum_raw`; its gradient is the cotangent itself."""
    if _n(mesh, axes) == 1:
        return t
    return _Sum.apply(t, mesh, axes) if _grad(t) else sum_raw(t, mesh, axes)


def copy_to(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` as it is; its gradient is summed over ``axes`` (the input of
    a product whose columns are split over them)."""
    if _n(mesh, axes) == 1 or not _grad(t):
        return t
    return _CopyTo.apply(t, mesh, axes)
