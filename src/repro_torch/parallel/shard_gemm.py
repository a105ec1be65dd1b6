"""Tensor- and data-parallel emulated GEMMs of the port
(``repro.parallel.shard_gemm``), in explicit SPMD.

The reference runs its fused GEMM per shard under ``jax.shard_map`` with
the collectives written out. Eager PyTorch has no partitioner, so the
port runs one process a rank: every rank holds the whole activations,
takes its tile of the problem, runs the port's own emulated GEMM on it
(K1's encodes and plane GEMM on a card, K3 for a prepared rhs) and joins
the tiles with one collective (``parallel.comm``):

* **column** (N on 'model'): each rank computes N / tp output columns
  over the full K and the columns are gathered. A gather is a copy, so
  the result is the unsharded product bit for bit, as in the reference.
* **row** (K on 'model', N does not divide): each rank contracts K / tp
  and the float partials are summed over 'model', with Scheme I's beta
  pinned to the global K (:func:`_pin_row_cfg`); allclose, not
  bit-identical, to the unsharded product.
* **batch**: the leading (row) dim splits over the data axes when it
  divides, and the rows are gathered.

:func:`gemm_partition` picks the partition as the reference does.
:func:`sharded_matmul` and :func:`sharded_dense` take global operands
(the reference's contract: each rank slices its own tile, a view) and
return ``None`` when nothing divides, so that the caller goes on
unsharded. :func:`tile_dense` is the model path's entry: there each rank
stores only its tile of every dense weight (``sharding.tile_pspecs``),
so the tile comes in instead of the global weight. A prepared rhs
(``+cached``) is consumed column-parallel: a global one is localized
(:func:`_localize_prepared`), a tile prepared where it lives.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import telemetry
from repro_torch.guard import ladder as guard_ladder
from repro_torch.kernels.prepared import (_REF_ALIGN, PreparedOperand,
                                          PreparedResidues, StepPrepared)
from repro_torch.launch.mesh import axis_index, axis_sizes
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.telemetry import record as _tele


def _record_partition(part: "GemmPartition", cfg, mesh_shape,
                      m: int, k: int, n: int) -> int:
    """Record the partition choice; return the modeled collective bytes
    a device of the psum (0 unless a row partition under telemetry)."""
    if not telemetry.enabled():
        return 0
    telemetry.record_event(_tele.SHARD_PARTITION, {
        "kind": part.kind, "mesh_shape": _tele.mesh_label(mesh_shape)})
    if part.kind != "row":
        return 0
    try:
        from repro_torch.core import traffic
        p = (len(cfg.resolved_moduli()) if cfg.scheme == "ozaki2"
             else cfg.p)
        t = traffic.sharded_gemm_traffic(
            traffic.GemmShape(int(m), int(n), int(k)), p, mesh_shape,
            partition="row", scheme=cfg.scheme)
        return int(t["collective_bytes_per_device"])
    except Exception:
        return 0


def _record_gather(mesh_shape, out: torch.Tensor, n_dev: int) -> None:
    """The port's column gather, which the reference leaves to GSPMD: a
    ring all-gather of the output's global bytes."""
    if telemetry.enabled() and n_dev > 1:
        from repro_torch.core import traffic
        telemetry.record_collective("all_gather", mesh_shape,
                                    traffic.all_gather_bytes(
                                        out.numel() * out.element_size(),
                                        n_dev))


@dataclasses.dataclass(frozen=True)
class GemmPartition:
    """How one (lead..., K) @ (K, N) splits over the mesh.

    ``kind`` is 'column' (N on the model axis), 'row' (K on the model
    axis, a sum over partials) or 'batch' (data-parallel only).
    ``batch_axes`` is the data-axes tuple the leading dim splits over
    (None: every rank computes every row), ``model_axis`` the TP axis
    name (None for 'batch').
    """
    kind: str
    batch_axes: tuple | None
    model_axis: str | None

    @property
    def reduce_axes(self) -> tuple:
        """Axes the partials are summed over (K-contracted tiles)."""
        return (self.model_axis,) if self.kind == "row" else ()

    def specs(self, x_ndim: int):
        """(x_spec, w_spec, out_spec) for (lead..., K) @ (K, N)."""
        P = shd.PartitionSpec
        mid = [None] * (x_ndim - 2)
        if self.kind == "column":
            return (P(self.batch_axes, *mid, None),
                    P(None, self.model_axis),
                    P(self.batch_axes, *mid, self.model_axis))
        if self.kind == "row":
            return (P(self.batch_axes, *mid, self.model_axis),
                    P(self.model_axis, None),
                    P(self.batch_axes, *mid, None))
        return (P(self.batch_axes, *mid, None),
                P(None, None),
                P(self.batch_axes, *mid, None))


def _model_axis(mesh) -> str | None:
    return "model" if axis_sizes(mesh).get("model", 1) > 1 else None


def gemm_partition(lead: int, k: int, n: int, mesh,
                   *, allow_row: bool = True) -> GemmPartition | None:
    """Pick the partitioning of a (lead..., K) @ (K, N) on ``mesh``, as
    the reference does: column parallel (N on 'model') when N divides,
    else row parallel (K on 'model'); the leading dim over the data axes
    when it divides. None when nothing divides (the caller goes on
    unsharded)."""
    bax = shd._fit(lead, shd.data_axes(mesh), mesh)
    mdl = _model_axis(mesh)
    if mdl is not None and shd._fit(n, mdl, mesh):
        return GemmPartition("column", bax, mdl)
    if allow_row and mdl is not None and shd._fit(k, mdl, mesh):
        return GemmPartition("row", bax, mdl)
    if bax is not None:
        return GemmPartition("batch", bax, None)
    return None


def _pin_row_cfg(cfg, k_global: int):
    """Pin K-global numerics before a row-parallel (K-split) product.

    Scheme I derives beta from the contraction length; each rank sees
    only K / tp, so an unpinned config would slice at the looser local
    beta. Pinning the beta of the global K (the port's unsharded route
    takes it from the logical K, unpadded) reproduces the single-device
    slice budget; what is left is the float summation order of the sum.
    Scheme II derives its budget from the local K inside the kernel, a
    larger product bound than the global run, still exact per rank."""
    if cfg.scheme == "ozaki1" and cfg.beta is None:
        return dataclasses.replace(cfg, beta=cfg.resolved_beta(k_global))
    return cfg


def _mesh_shape(mesh):
    from repro_torch.kernels import dispatch
    return dispatch._mesh_shape_tuple(mesh)


def _slice_cols(t: torch.Tensor, dim: int, tp: int, idx: int):
    step = t.shape[dim] // tp
    return t.narrow(dim, idx * step, step).contiguous()


def _localize_prepared(prep, mesh):
    """This rank's columns of a global prepared rhs, or None.

    The reference shards the slice / residue stack and the scale on their
    last (N) dim. The port's layouts hold N where they hold it: dim 1 of
    the (p, N, Kp) 'planes' of B^T, the last dim of the 'interleaved'
    (p * Kp, N) slices and of the 'stacked' (p, K16, N16) residues, and
    the last dim of every (1, N) scale; each is sliced there, ``n``
    becomes the rank's width and the twin (the backward layout, whose N is
    dA's contraction) is dropped. Refused, as in the reference, when the
    padded width does not divide the model axis (``n_indivisible``) or
    the operand was prepared under another mesh (``mesh_mismatch``)."""
    tp = axis_sizes(mesh).get("model", 1)
    if tp <= 1:
        return None
    # The reference's padded width: 128 for a Scheme-I operand (the port
    # pads nothing, but keeps the refusal), 16 for Scheme-II residues.
    padded_n = getattr(prep, "padded_n", None) or \
        -(-prep.n // _REF_ALIGN) * _REF_ALIGN
    if prep.n != padded_n or prep.n % tp:
        telemetry.record_event(_tele.PREPARED_REFUSALS,
                               {"reason": "n_indivisible"})
        return None
    pinned = getattr(prep, "mesh_shape", None)
    if pinned is not None and pinned != _mesh_shape(mesh):
        telemetry.record_event(_tele.PREPARED_REFUSALS,
                               {"reason": "mesh_mismatch"})
        return None
    idx = axis_index(mesh, "model")
    data = prep.slices if isinstance(prep, PreparedOperand) \
        else prep.residues
    n_dim = 1 if prep.layout == "planes" else data.dim() - 1
    fields = {prep.TENSORS[0]: _slice_cols(data, n_dim, tp, idx),
              "scale": _slice_cols(prep.scale, 1, tp, idx)}
    return dataclasses.replace(prep, n=prep.n // tp, twin=None, **fields)


def _run(x, part: GemmPartition, cfg, mesh, k: int, n: int, product):
    """``product(x_tile)``, this rank's tile of the product of whole
    activations ``x`` (its rows over the batch axes, its K over 'model'
    for a row partition), joined into the whole output: the row partials
    summed, the column tiles and the row blocks gathered."""
    mesh_shape = _mesh_shape(mesh)
    lead = x.numel() // max(1, x.shape[-1])
    coll_bytes = _record_partition(part, cfg, mesh_shape, lead, k, n)
    xl = x
    if part.batch_axes is not None:
        xl = comm.local_slice(xl, 0, mesh, part.batch_axes)
    if part.kind == "column":
        xl = comm.copy_to(xl, mesh, "model")
    elif part.kind == "row":
        xl = comm.local_slice(xl, -1, mesh, "model")
    with guard_ladder.consensus(mesh):
        out = product(xl)
    for ax in part.reduce_axes:
        out = comm.all_reduce(out, mesh, ax)
    telemetry.record_collective("psum", mesh_shape, coll_bytes)
    if part.kind == "column":
        out = comm.gather(out, -1, mesh, "model")
        _record_gather(mesh_shape, out, axis_sizes(mesh)["model"])
    if part.batch_axes is not None:
        out = comm.gather(out, 0, mesh, part.batch_axes)
    return out


def _dense_product(w, part: GemmPartition, cfg, k: int, prep=None):
    """The local product of a dense call: against this rank's tile ``w``
    (``emulated_dot``, under autograd too), its ``StepPrepared`` prep, or
    a bare prepared tile (``w`` None)."""
    from repro_torch.core.emulated import (emulated_dot,
                                           emulated_dot_prepared,
                                           prepared_dot)
    if prep is not None and w is None:
        return lambda xl: prepared_dot(xl, prep)
    if prep is not None:
        return lambda xl: emulated_dot_prepared(xl, w, prep, cfg)
    body_cfg = _pin_row_cfg(cfg, k) if part.kind == "row" else cfg
    return lambda xl: emulated_dot(xl, w, body_cfg)


def _tile(w: torch.Tensor, part: GemmPartition, mesh) -> torch.Tensor:
    """This rank's tile of a global (K, N) weight (a view)."""
    if part.kind == "column":
        return comm.local_slice(w, 1, mesh, "model")
    if part.kind == "row":
        return comm.local_slice(w, 0, mesh, "model")
    return w


def sharded_matmul(a: torch.Tensor, b: torch.Tensor, cfg, mesh, *,
                   out_dtype=None) -> torch.Tensor | None:
    """2-D a: (M, K) @ b: (K, N), both whole on every rank, partitioned
    over ``mesh``: the column layout (bit-identical to
    ``dispatch.emulated_matmul`` on one device) when N divides, else the
    row layout (float partials summed). None when no mesh axis divides
    the problem. Complex operands ride along through the dispatcher's
    4M / 3M routes."""
    if a.dim() != 2 or getattr(b, "dim", lambda: 0)() != 2:
        return None
    from repro_torch.kernels import dispatch
    part = gemm_partition(a.shape[0], a.shape[1], b.shape[1], mesh)
    if part is None:
        return None
    k, n = b.shape
    body_cfg = cfg if part.kind != "row" else _pin_row_cfg(cfg, k)
    b_tile = _tile(b, part, mesh)
    return _run(a, part, cfg, mesh, k, n, lambda al: dispatch.emulated_matmul(
        al, b_tile, cfg=body_cfg, out_dtype=out_dtype,
        mesh_shape=_mesh_shape(mesh)))


def sharded_dense(x: torch.Tensor, w, cfg, mesh) -> torch.Tensor | None:
    """x: (..., K) @ w: (K, N), ``w`` whole on every rank: a float weight,
    a ``StepPrepared`` pair (the rank's tile is prepared again where it
    lives: bit-identical, since a column tile's K is the global K) or a
    bare ``PreparedOperand`` / ``PreparedResidues`` (localized). The
    rank cuts its tile as :func:`gemm_partition` says and runs
    :func:`tile_dense` on it. Differentiable (the collectives carry their
    gradients, ``parallel.comm``). None whenever this module cannot
    partition: the caller goes on unsharded."""
    if x.is_complex():
        return None
    if isinstance(w, (PreparedOperand, PreparedResidues)):
        local = _localize_prepared(w, mesh)
        return None if local is None else tile_dense(
            x, local, cfg, mesh, GemmPartition("column", None, "model"))
    weight = w.w if isinstance(w, StepPrepared) else w
    if getattr(weight, "ndim", 0) != 2 or weight.is_complex():
        return None
    part = gemm_partition(x.shape[0], *weight.shape, mesh)
    if part is None:
        return None
    return tile_dense(x, _tile(weight, part, mesh), cfg, mesh, part)


def _stored_partition(k: int, k_l: int, n_l: int, bax, mesh):
    """How the model path cut a (k_l, n_l) tile of a weight of K = ``k``
    (``sharding.tile_kind``), and the weight's N; None for a whole weight
    whose rows do not split either."""
    tp = axis_sizes(mesh).get("model", 1)
    if tp > 1 and k_l != k:
        if k_l * tp != k:
            raise ValueError(f"a ({k_l}, {n_l}) tile is not a row tile of "
                             f"lhs K={k} on {tp} ranks")
        return GemmPartition("row", bax, "model")
    if shd.tile_kind(k, n_l * tp, mesh) == "column":
        return GemmPartition("column", bax, "model")
    if bax is not None:
        return GemmPartition("batch", bax, None)
    return None


def tile_dense(x: torch.Tensor, w, cfg, mesh,
               part: GemmPartition | None = None) -> torch.Tensor | None:
    """x: (..., K) @ this rank's tile of a (K, N) weight. ``part`` says
    how the tile was cut (:func:`sharded_dense`); None reads it off the
    tile as the model path stores it (``sharding.tile_pspecs``): (K, N /
    tp) column tiles, (K / tp, N) row tiles, or the whole weight where K
    does not divide the model axis (``sharding.tile_kind``). ``w`` may be
    the tile, its ``StepPrepared`` pair (prepared where it lives) or its
    bare prepared operand (a column tile's). The leading dim splits over
    the data axes when it divides. None for a whole weight whose rows do
    not divide either: the caller goes on unsharded."""
    if x.is_complex():
        return None
    tp = axis_sizes(mesh).get("model", 1)
    k = x.shape[-1]
    bax = shd._fit(x.shape[0], shd.data_axes(mesh), mesh)
    if isinstance(w, (PreparedOperand, PreparedResidues)):
        pinned = getattr(w, "mesh_shape", None)
        if pinned is not None and pinned != _mesh_shape(mesh):
            raise ValueError(f"a tile prepared on mesh {pinned} is consumed "
                             f"on {_mesh_shape(mesh)}")
        if part is None and (shd.tile_kind(k, w.n * tp, mesh) != "column"
                             or w.k != k):
            raise ValueError(f"a prepared tile is a column tile; got K="
                             f"{w.k}, N={w.n} for lhs K={k} on {tp} ranks")
        part = GemmPartition("column", bax, "model")     # the data axes
        return _run(x, part, cfg, mesh, k, w.n * tp,
                    _dense_product(None, part, cfg, k, w))
    weight, prep = ((w.w, w.prep) if isinstance(w, StepPrepared)
                    else (w, None))
    k_l, n_l = weight.shape
    if part is None:
        part = _stored_partition(k, k_l, n_l, bax, mesh)
        if part is None:
            return None
    if part.kind == "row":
        prep = None            # the row tile's prep is of K / tp: unused
    n = n_l * tp if part.kind == "column" else n_l
    return _run(x, part, cfg, mesh, k, n,
                _dense_product(weight, part, cfg, k, prep))


def tied_head(emb: torch.Tensor, mesh) -> torch.Tensor:
    """The tied head's tile, ``emb.T`` as :func:`tile_dense` reads it: the
    rank's rows (or, for a row tile, columns) of the (V, D) table,
    transposed. The table stays whole on every rank for the lookup; under
    autograd the slice's gradient is gathered, so every rank's table gets
    every rank's head gradient."""
    v, d = emb.shape
    kind = shd.tile_kind(d, v, mesh)
    if kind is None:
        return emb.T
    return comm.local_slice(emb, 0 if kind == "column" else 1, mesh,
                            "model").T
