"""Sharding rules of the port (``repro.parallel.sharding``): parameter /
optimizer / cache PartitionSpecs, and the per-rank slices they give.

Axes convention (``launch/mesh.py``):
  * data axes ``('pod', 'data')`` (multi-pod) or ``('data',)``: batch and
    FSDP parameter sharding;
  * ``'model'``: tensor parallelism (attention heads / FFN width / experts
    / padded vocab).

The rules are the reference's, name and shape driven with divisibility
fallbacks: a dim that does not divide its mesh axis stays unsharded.
Layer-stacked parameters get a leading ``None`` for the group axis. They
read a mesh only through its axis sizes, so a device-free mesh and a
live one give the same specs.

:class:`PartitionSpec` is the port's own: a tuple with one entry a
tensor dimension, each ``None``, an axis name or a tuple of axis names;
a one-name tuple normalises to the name, as the reference's installed
``jax.sharding.PartitionSpec`` does (ROADMAP.md § 3 R3).
:func:`shard_tree` gives each rank its slices of a tree under a tree of
specs, :func:`to_placements` maps a spec to DTensor placements, and
:func:`tile_pspecs` is the layout the model path stores its dense
weights in (``parallel.shard_gemm``), which differs from
:func:`param_pspecs`, the reference's storage rule, where the reference
re-shards at every call (ROADMAP.md § 3).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import axis_index, axis_sizes


class PartitionSpec(tuple):
    """One entry a tensor dimension: None, an axis name, or a tuple of
    axis names (a one-name tuple is stored as the name)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# Trees of specs: PartitionSpec is a tuple, so it is a leaf here.
# ---------------------------------------------------------------------------

def _items(tree):
    if isinstance(tree, PartitionSpec):
        return None
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten_with_path(tree, path=()):
    items = _items(tree)
    if items is None:
        return [(path, tree)]
    out = []
    for k, v in items:
        out += _flatten_with_path(v, path + (str(k),))
    return out


def _map(fn, tree, *rest):
    """``fn`` leaf by leaf over trees of one structure, specs as leaves."""
    items = _items(tree)
    if items is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in items}
    return type(tree)(_map(fn, v, *(r[i] for r in rest)) for i, v in items)


def _unflatten(like, leaves):
    it = iter(leaves)
    return _map(lambda _: next(it), like)


def _map_with_path(fn, tree):
    flat = _flatten_with_path(tree)
    return _unflatten(tree, [fn(path, leaf) for path, leaf in flat])


# ---------------------------------------------------------------------------
# The reference's rules.
# ---------------------------------------------------------------------------

def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fit(dim: int, axes, mesh):
    """axes if dim divides their product else None (unsharded fallback)."""
    return axes if axes and dim % _axes_size(mesh, axes) == 0 else None


def data_axes(mesh):
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes) or None


def batch_pspec(mesh, extra_dims: int = 1) -> PartitionSpec:
    return P(data_axes(mesh), *([None] * extra_dims))


# Projections whose *output* dim carries TP ("column parallel") ...
_UP = {"wq", "wk", "wv", "wi", "wi_gate", "wi_up", "w_y", "w_gate", "w_in",
       "wq_b", "wkv_b", "w_r", "w_i", "proj"}
# ... and whose *input* dim carries TP ("row parallel", after a TP output).
_DOWN = {"wo", "w_out"}
# Low-rank down-projections: keep the small latent dim replicated.
_LATENT = {"wq_a", "wkv_a", "frontend_proj"}


def _param_rule(path: tuple[str, ...], shape, mesh, fsdp: bool,
                attn_sp: bool = False):
    mdl = "model"
    dp = data_axes(mesh) if fsdp else None
    name = path[-1]
    stacked = "layers" in path          # layer-stacked: leading group axis
    core = shape[1:] if stacked else shape
    rank = len(core)

    def spec(*parts):
        parts = list(parts) + [None] * (rank - len(parts))
        if stacked:
            parts = [None] + parts
        return P(*parts)

    if name == "emb":
        return spec(_fit(core[0], mdl, mesh), _fit(core[1], dp, mesh))
    if name == "head":
        return spec(_fit(core[0], dp, mesh), _fit(core[1], mdl, mesh))
    if name == "router":
        return spec(None, None)
    if name in ("conv_w",):
        return spec(None, _fit(core[1], mdl, mesh))
    if rank == 3 and name in ("wi_gate", "wi_up"):      # experts (E, D, F)
        return spec(_fit(core[0], mdl, mesh), _fit(core[1], dp, mesh), None)
    if rank == 3 and name == "wo":                      # experts (E, F, D)
        return spec(_fit(core[0], mdl, mesh), None, _fit(core[2], dp, mesh))
    if rank == 2 and name in _LATENT:
        return spec(_fit(core[0], dp, mesh), None)
    if attn_sp and "mixer" in path and name in ("wq", "wk", "wv", "wo"):
        # Sequence-parallel attention: the reference's activations carry
        # the model axis along S, so its attention weights shard over the
        # data axes instead, whatever fsdp says.
        dpa = data_axes(mesh)
        return spec(_fit(core[0], dpa, mesh), None)
    if rank == 2 and name in _UP:
        out_ax = _fit(core[1], mdl, mesh)
        if out_ax is None:  # fall back to sharding the contraction dim
            return spec(_fit(core[0], mdl, mesh), None)
        return spec(_fit(core[0], dp, mesh), out_ax)
    if rank == 2 and name in _DOWN:
        in_ax = _fit(core[0], mdl, mesh)
        if in_ax is None:
            return spec(None, _fit(core[1], mdl, mesh))
        return spec(in_ax, _fit(core[1], dp, mesh))
    return spec()                                        # norms, biases, 1-D


def param_pspecs(params, mesh, fsdp: bool = False, attn_sp: bool = False):
    """Tree of PartitionSpec matching ``params`` (tensors, meta included)."""
    return _map_with_path(
        lambda path, leaf: _param_rule(path, tuple(leaf.shape), mesh, fsdp,
                                       attn_sp), params)


def add_dp_to_spec(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """ZeRO-2: shard the first unsharded, divisible dim over the data
    axes (applied to optimizer states and the gradient accumulator).
    No-op if the spec already uses the data axes."""
    dp = data_axes(mesh)
    used = {a for part in spec if part
            for a in ((part,) if isinstance(part, str) else part)}
    if dp and any(a in used for a in dp):
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and _fit(dim, dp, mesh):
            parts[i] = dp
            return P(*parts)
    return spec


def grad_pspecs(params, params_specs, mesh, zero2: bool):
    if not zero2:
        return params_specs
    return _map(lambda p, s: add_dp_to_spec(s, tuple(p.shape), mesh),
                params, params_specs)


def opt_pspecs(opt_state, params_specs, mesh, zero2: bool = False):
    """Optimizer states mirror parameter specs (plus data-axis sharding
    under ZeRO-2); Adafactor's factored statistics drop the corresponding
    parameter axis."""
    def moment(sub):
        if not zero2:
            return _map(lambda s: s, params_specs)
        return grad_pspecs(sub, params_specs, mesh, True)

    out = {}
    for k, v in opt_state.items():
        if k == "step":
            out[k] = P()
        elif k in ("m", "v"):
            out[k] = moment(v)
        elif k == "vr":      # param spec minus last axis
            out[k] = _map(lambda s: P(*s[:-1]) if len(s) else P(),
                          params_specs)
        elif k == "vc":      # param spec minus second-to-last axis
            out[k] = _map(lambda s: P(*(s[:-2] + s[-1:])) if len(s) >= 2
                          else P(), params_specs)
        else:
            out[k] = _map(lambda _: P(), v)
    return out


def _cache_rule(path: tuple[str, ...], shape, mesh):
    dp = data_axes(mesh)
    mdl = "model"
    name = path[-1]
    stacked = "layers" in path
    core = shape[1:] if stacked else shape
    rank = len(core)

    def spec(*parts):
        parts = list(parts) + [None] * (rank - len(parts))
        if stacked:
            parts = [None] + parts
        return P(*parts)

    if name in ("k", "v", "k_scale", "v_scale"):   # (B, S, KVH, HD)
        b_ax = _fit(core[0], dp, mesh)
        kvh_ax = _fit(core[2], mdl, mesh)
        if kvh_ax is not None:
            return spec(b_ax, None, kvh_ax, None)
        return spec(b_ax, _fit(core[1], mdl, mesh), None, None)
    if name in ("c_kv", "k_pe"):                   # MLA latent (B, S, L)
        return spec(_fit(core[0], dp, mesh), _fit(core[1], mdl, mesh), None)
    if name == "h":                                # RG-LRU state (B, W)
        return spec(_fit(core[0], dp, mesh), _fit(core[1], mdl, mesh))
    if name == "conv":                             # (B, k-1, W)
        return spec(_fit(core[0], dp, mesh), None,
                    _fit(core[2], mdl, mesh))
    if name == "ssm":                              # (B, H, P, N)
        return spec(_fit(core[0], dp, mesh), _fit(core[1], mdl, mesh),
                    None, None)
    return spec(_fit(core[0], dp, mesh))


def cache_pspecs(cache, mesh):
    return _map_with_path(
        lambda path, leaf: _cache_rule(path, tuple(leaf.shape), mesh), cache)


def shardings(specs, mesh):
    return _map(lambda s: NamedSharding(mesh, s), specs)


# ---------------------------------------------------------------------------
# Per-rank slices.
# ---------------------------------------------------------------------------

def local_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """The shape of one rank's slice of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is not None:
            out[i] //= _axes_size(mesh, axes)
    return tuple(out)


def shard_leaf(x, spec: PartitionSpec, mesh):
    """This rank's slice of ``x`` under ``spec``: a copy of its own, so
    that the whole tensor can be freed (a meta tensor stays meta)."""
    if not isinstance(x, torch.Tensor) or not any(a is not None
                                                  for a in spec):
        return x
    out = x
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        n = _axes_size(mesh, axes)
        if out.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not divide "
                             f"{axes}={n}")
        step = out.shape[i] // n
        out = out.narrow(i, axis_index(mesh, axes) * step, step)
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh):
    """Each leaf's slice for this rank under its spec (the layout GSPMD
    gives the reference's arrays, held as ordinary per-rank tensors)."""
    return _map(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


def to_placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec``: for each mesh dimension, in order,
    ``Shard(i)`` if tensor dim i is sharded over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in axis_sizes(mesh):
        dims = [i for i, part in enumerate(spec) if part is not None
                and ax in ((part,) if isinstance(part, str) else part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# The model path's layout of its dense weights.
# ---------------------------------------------------------------------------

# Weights the model consumes through models.common.dense (the prepared
# path's DENSE_WEIGHT_NAMES and multi-token prediction's 'proj'); a core
# rank of 2 leaves out the expert stacks, which are raw einsums.
TILE_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a",
    "wi", "wi_gate", "wi_up", "w_y", "w_gate", "w_out", "w_in",
    "head", "proj"})


def tile_kind(k: int, n: int, mesh) -> str | None:
    """How the model path stores a (K, N) dense weight on ``mesh``:
    'column' (N / tp columns each) when K and N divide the model axis,
    'row' (K / tp rows) when only K does, None (whole) otherwise.
    ``shard_gemm.gemm_partition`` prefers column whenever N divides; the
    stored layout also asks K to divide, so that a rank can tell a column
    tile from a whole weight by its K alone (ROADMAP.md § 3)."""
    tp = axis_sizes(mesh).get("model", 1)
    if tp <= 1 or k % tp:
        return None
    return "column" if n % tp == 0 else "row"


def tile_pspecs(params, mesh):
    """Specs of the model path's per-rank layout: each dense weight in
    :data:`TILE_NAMES` split as :func:`tile_kind` says (a layer stack on
    its last two dims), everything else whole on every rank."""
    def rule(path, leaf):
        shape = tuple(leaf.shape)
        stacked = "layers" in path
        core = shape[1:] if stacked else shape
        lead = [None] * (len(shape) - 2)
        if path[-1] not in TILE_NAMES or len(core) != 2 \
                or not leaf.is_floating_point():
            return P(*([None] * len(shape)))
        kind = tile_kind(shape[-2], shape[-1], mesh)
        if kind == "column":
            return P(*lead, None, "model")
        if kind == "row":
            return P(*lead, "model", None)
        return P(*([None] * len(shape)))
    return _map_with_path(rule, params)


def tile_params(params, mesh):
    """``params`` (whole) as this rank holds them on the model path: the
    tiles of :func:`tile_pspecs`, everything else whole."""
    return shard_tree(params, tile_pspecs(params, mesh), mesh)


def tile_cuts(params, mesh) -> dict:
    """{id(leaf): (dim, start, length)}: the block of each of a tiled
    leaf's 2-D matrices that this rank keeps under :func:`tile_pspecs`
    (dim 0 for a row tile, 1 for a column tile), for the leaves that are
    tiled (``models.model.init_rank_params``)."""
    out = {}
    for (_, leaf), (_, spec) in zip(_flatten_with_path(params),
                                    _flatten_with_path(tile_pspecs(params,
                                                                   mesh))):
        for dim in (0, 1):
            if spec[len(spec) - 2 + dim] is not None:
                step = leaf.shape[len(spec) - 2 + dim] // axis_sizes(
                    mesh)["model"]
                out[id(leaf)] = (dim, axis_index(mesh, "model") * step, step)
    return out


def unshard_leaf(x, spec: PartitionSpec, mesh):
    """The whole tensor of which ``x`` is this rank's slice under ``spec``
    (every rank calls it; the inverse of :func:`shard_leaf`)."""
    from repro_torch.parallel import comm
    if not isinstance(x, torch.Tensor):
        return x
    for i, axes in enumerate(spec):
        if axes is not None:
            x = comm.gather_raw(x, i, mesh, axes)
    return x


def unshard_tree(tree, specs, mesh):
    return _map(lambda x, s: unshard_leaf(x, s, mesh), tree, specs)
