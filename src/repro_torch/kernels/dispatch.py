"""Emulated-GEMM dispatch of the port: backend routing, block cache, plans.

The torch counterpart of ``repro.kernels.dispatch``:

* :func:`select_blocks` — the backend's ``choose_blocks`` memoized per
  (shape, p, out type, batch, scheme) key in a per-backend cache
  (``block_cache_info`` / ``block_cache_clear``);
* :func:`plan_emulated` / :func:`plan_emulated_batched` — one (backend,
  out type, blocks) resolution per GEMM;
* :func:`emulated_matmul` / :func:`emulated_matmul_batched` — the entry
  points for a 2-D and a strided-batched emulated GEMM;
* :func:`auto_fused_matmul` — the 'auto' hook of ``emulated_dot``.

A ``+guard`` config (``repro_torch.guard``) wraps the 2-D entry point in
the guard's ladder (sanitize, run, verify, escalate), which re-enters it
with the guard stripped for every rung; a guarded batched call runs the
unguarded batched launch once and verifies, masks and counts each batch
element (``guard.ladder.guarded_matmul_batched``). With telemetry enabled
(``repro_torch.telemetry``) every call records its plan and execution
counters (``record_gemm``), block-cache lookups and batched launches, and
runs under a profiler scope while a profiler runs.

Both backends take every shape as it is: the CUDA kernel zero-fills
ragged edges in the kernel, so nothing is padded (the reference pads to
its backend's alignment), and 'auto' never sends a CUDA tensor to the
plain version.

Complex operands run with a real interior: the output type of a complex
problem is the real type of its parts, and the backend assembles the
complex result (Scheme II: the 3M plane route, block-cache key
'ozaki2-3m'; Scheme I: 4M, four real launches). A batched complex problem
under Scheme II runs as one batched 3M plane route (two encodes and one
plane GEMM with the batch as their batch coordinate), under Scheme I as
one 4M route per batch element; both compute what the reference's vmap
fallback computes, bit for bit (it has no batched 3M kernel).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import warnings

import torch

from repro_torch import telemetry
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import backends
from repro_torch.kernels.common import Blocks
from repro_torch.telemetry import record as _tele

BLOCK_CACHE_MAXSIZE = 4096


class _BlockCache:
    """One backend's memoized block selections (FIFO-bounded)."""

    __slots__ = ("data", "hits", "misses")

    def __init__(self) -> None:
        self.data: dict = {}
        self.hits = 0
        self.misses = 0

    def put(self, key, blocks) -> None:
        if len(self.data) >= BLOCK_CACHE_MAXSIZE:
            self.data.pop(next(iter(self.data)))
        self.data[key] = blocks


_BLOCK_CACHES: dict[str, _BlockCache] = {}

BlockCacheInfo = collections.namedtuple(
    "BlockCacheInfo", ["hits", "misses", "maxsize", "currsize", "per_backend"])


def select_blocks(m: int, n: int, k: int, p: int, out_bytes: int,
                  backend: str, batch: int = 1,
                  scheme: str = "ozaki1",
                  mesh_shape: tuple | None = None) -> Blocks | None:
    """Cached block selection through the backend registry; ``p`` is the
    slice count (Scheme I) or the modulus count (Scheme II), and
    ``scheme`` keys the cache as in the reference. ``mesh_shape`` is the
    launch mesh's ((axis, size), ...) when (m, n, k) are a rank's local
    dims of a partitioned GEMM: the same local shape on two meshes keys
    two entries (None on one device)."""
    cache = _BLOCK_CACHES.setdefault(backend, _BlockCache())
    key = (m, n, k, p, out_bytes, batch, scheme, mesh_shape)
    if key in cache.data:
        cache.hits += 1
        telemetry.record_event(_tele.BLOCK_CACHE,
                               {"backend": backend, "result": "hit"})
        return cache.data[key]
    cache.misses += 1
    telemetry.record_event(_tele.BLOCK_CACHE,
                           {"backend": backend, "result": "miss"})
    blocks = backends.get_backend(backend).choose_blocks(m, n, k, p,
                                                         scheme=scheme)
    cache.put(key, blocks)
    return blocks


def block_cache_info(backend: str | None = None) -> BlockCacheInfo:
    caches = ({backend: _BLOCK_CACHES.get(backend, _BlockCache())}
              if backend is not None else dict(sorted(_BLOCK_CACHES.items())))
    per = {name: (c.hits, c.misses, len(c.data)) for name, c in caches.items()}
    return BlockCacheInfo(sum(c.hits for c in caches.values()),
                          sum(c.misses for c in caches.values()),
                          BLOCK_CACHE_MAXSIZE,
                          sum(len(c.data) for c in caches.values()), per)


def block_cache_clear(backend: str | None = None) -> None:
    if backend is not None:
        _BLOCK_CACHES.pop(backend, None)
    else:
        _BLOCK_CACHES.clear()


# ---------------------------------------------------------------------------
# Plans.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmPlan:
    cfg: EmulationConfig
    m: int
    n: int
    k: int
    out_dtype: torch.dtype
    blocks: Blocks | None
    backend: str
    batch: int = 1
    probe: object = None     # guard.sentinel.SentinelProbe when asked for
    # The launch mesh's ((axis, size), ...) when (m, n, k) are a rank's
    # local dims of a partitioned GEMM (keys the block cache; None on one
    # device).
    mesh_shape: tuple | None = None


def _complex(a, b) -> bool:
    return a.is_complex() or b.is_complex()


def _scheme_key(cfg: EmulationConfig, a, b) -> str:
    """The block-cache key: 'ozaki2-3m' for a complex problem under
    Scheme II, whose kernel has its own tile, else the scheme."""
    if cfg.scheme == "ozaki2" and _complex(a, b):
        return "ozaki2-3m"
    return cfg.scheme


def _p_eff(cfg: EmulationConfig) -> int:
    """The residue count the tiles budget for: slices (Scheme I) or
    moduli (Scheme II; an explicit tuple may disagree with cfg.p)."""
    return (len(cfg.resolved_moduli()) if cfg.scheme == "ozaki2"
            else cfg.p)


def _promoted(cfg: EmulationConfig, a, b, out_dtype) -> torch.dtype:
    if out_dtype is None and cfg.out_dtype is not None:
        out_dtype = getattr(torch, cfg.out_dtype)
    return out_dtype or torch.promote_types(a.dtype, b.dtype)


def _out_dtype(cfg: EmulationConfig, a, b, out_dtype) -> torch.dtype:
    """The emulated output type; for a complex problem the real type of
    its parts (its interior is real and the complex result is assembled
    at the end)."""
    out_dtype = _promoted(cfg, a, b, out_dtype)
    if _complex(a, b):
        out_dtype = torch.empty((), dtype=out_dtype).real.dtype
    return out_dtype


def plan_emulated(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
                  out_dtype=None, backend: str | None = None,
                  mesh_shape: tuple | None = None,
                  probe: bool = False) -> GemmPlan:
    """Backend, output type and cached blocks for one 2-D GEMM.

    ``mesh_shape`` marks (a, b) as a rank's tiles of a partitioned GEMM
    (:func:`select_blocks`). ``probe=True`` also runs the guard's input
    sentinel (finite masks and the exponent-spread estimate, O(MK + KN)
    elementwise) and attaches it as ``GemmPlan.probe``: the pre-dispatch
    leg of the ``+guard`` pipeline."""
    m, k = a.shape
    n = b.shape[1]
    out_dtype = _out_dtype(cfg, a, b, out_dtype)
    name = backends.resolve_backend_name(backend, cfg, a.device)
    blocks = select_blocks(m, n, k, _p_eff(cfg), out_dtype.itemsize, name,
                           scheme=_scheme_key(cfg, a, b),
                           mesh_shape=mesh_shape)
    sentinel_probe = None
    if probe:
        from repro_torch.guard import sentinel
        sentinel_probe = sentinel.probe_operands(a, b)
    return GemmPlan(cfg, m, n, k, out_dtype, blocks, name,
                    probe=sentinel_probe, mesh_shape=mesh_shape)


def plan_emulated_batched(a: torch.Tensor, b: torch.Tensor,
                          cfg: EmulationConfig, out_dtype=None,
                          backend: str | None = None) -> GemmPlan:
    """Backend, output type and blocks for one (B, M, K) @ (B, K, N) of
    real operands, or of complex ones under Scheme II."""
    batch, m, k = a.shape
    n = b.shape[-1]
    out_dtype = _out_dtype(cfg, a, b, out_dtype)
    name = backends.resolve_backend_name(backend, cfg, a.device)
    blocks = select_blocks(m, n, k, _p_eff(cfg), out_dtype.itemsize, name,
                           batch, _scheme_key(cfg, a, b))
    return GemmPlan(cfg, m, n, k, out_dtype, blocks, name, batch)


def _scope_scheme(cfg: EmulationConfig, cplx: bool) -> tuple[str, int]:
    """(scheme tag, residue count) of one call, for its labels."""
    if cfg.scheme == "ozaki2":
        return ("ozaki2-3m" if cplx else "ozaki2",
                len(cfg.resolved_moduli()))
    return ("ozaki1-4m" if cplx else cfg.scheme, cfg.p)


def _run_plan(plan: GemmPlan, a, b) -> torch.Tensor:
    """The plan's backend on (a, b): the telemetry record (a no-op unless
    enabled) and a profiler scope (only while a profiler runs)."""
    scheme, count = _scope_scheme(plan.cfg, _complex(a, b))
    impl = "kernel" if plan.backend == "cuda" else "torch"
    if telemetry.enabled():
        batch = plan.batch if a.dim() == 3 else None
        if batch is not None:
            telemetry.record_event(_tele.BATCHED_LAUNCHES, {
                "backend": plan.backend, "scheme": scheme,
                "shape_class": _tele.shape_class(plan.m, plan.k, plan.n,
                                                 batch=batch)})
        telemetry.record_gemm(
            scheme=scheme, count=count, backend=plan.backend, impl=impl,
            m=plan.m, k=plan.k, n=plan.n, mesh_shape=plan.mesh_shape,
            out_bytes=plan.out_dtype.itemsize, batch=batch,
            in_bytes=a.element_size())
    with telemetry.gemm_scope(scheme, count, plan.backend, impl):
        return backends.get_backend(plan.backend).matmul(
            a, b, plan.cfg, plan.out_dtype, plan.blocks)


def _guarded(cfg: EmulationConfig, a, b) -> bool:
    """The reference's guard seam condition: a guarded emulation config
    on real operands (invalid shapes fall through to the usual
    refusals)."""
    return (cfg.guard is not None and cfg.scheme != "native"
            and not a.is_complex()
            and (_is_prepared(b) or not b.is_complex()))


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def _resolve_cfg(cfg, scheme=None, precision=None) -> EmulationConfig:
    """This call's config through ``api.resolve_config``; ``scheme=`` /
    ``precision=`` are the reference's deprecated pre-spec kwargs, which
    keep working with a DeprecationWarning."""
    from repro_torch import api
    if scheme is not None or precision is not None:
        if cfg is not None:
            raise TypeError("pass either cfg= or the deprecated "
                            "scheme=/precision= kwargs, not both")
        warnings.warn(
            "emulated_matmul(scheme=..., precision=...) is deprecated; "
            "pass cfg=repro_torch.precision('<scheme>-p<N>') or wrap the "
            "call in `with repro_torch.emulation(...)`",
            DeprecationWarning, stacklevel=3)
        return EmulationConfig(
            scheme=scheme if scheme is not None else "ozaki1",
            p=precision if precision is not None else 4)
    return api.resolve_config(cfg, default=_LEGACY_DEFAULT)


# Historical no-argument behavior of emulated_matmul: Scheme I at p=4,
# ranked below the ambient scope and env in the resolver.
_LEGACY_DEFAULT = EmulationConfig(scheme="ozaki1", p=4)


def _is_prepared(b) -> bool:
    from repro_torch.kernels.prepared import PreparedOperand, PreparedResidues
    return isinstance(b, (PreparedOperand, PreparedResidues))


def check_prepared(b, cfg: EmulationConfig) -> None:
    """A prepared rhs is the emulation data of one scheme: raise unless
    ``cfg`` is that scheme (the reference's refusals)."""
    from repro_torch.kernels.prepared import PreparedResidues
    if cfg.scheme == "native":
        raise ValueError(
            "a prepared rhs is pre-decomposed emulation data; it cannot be "
            "consumed under a 'native' config (pass the float weight "
            "instead)")
    residues = isinstance(b, PreparedResidues)
    if residues and cfg.scheme != "ozaki2":
        raise ValueError(
            "a PreparedResidues rhs is Scheme-II (ozaki2) data; it cannot be "
            f"consumed under scheme={cfg.scheme!r} (pass the float weight, "
            "or prepare under the matching config)")
    if not residues and cfg.scheme == "ozaki2":
        raise ValueError(
            "a PreparedOperand rhs is Scheme-I (ozaki1) data; it cannot be "
            "consumed under scheme='ozaki2' (pass the float weight, or "
            "prepare under the matching config)")


def emulated_matmul(a: torch.Tensor, b, *, cfg=None, out_dtype=None,
                    backend: str | None = None, scheme: str | None = None,
                    precision: int | None = None,
                    mesh_shape: tuple | None = None) -> torch.Tensor:
    """Emulated (M, K) @ (K, N) on the selected backend (argument >
    ``REPRO_TORCH_BACKEND`` > ``cfg.backend`` > the operands' device).

    ``b`` may be a prepared operand of the config's scheme: its finished
    encode streams as it is, on the backend pinned when it was prepared,
    and only the lhs is carved. ``scheme`` / ``precision`` are the
    reference's deprecated kwargs (:func:`_resolve_cfg`). ``mesh_shape``
    (the launch mesh's axis sizes) marks the operands as a rank's tiles
    of a partitioned GEMM; it keys the block cache and the telemetry
    labels."""
    cfg = _resolve_cfg(cfg, scheme, precision)
    if (_guarded(cfg, a, b) and a.dim() == 2
            and (_is_prepared(b) or b.dim() == 2)):
        # The guard pipeline wraps this entry point and re-enters it with
        # the guard stripped for every ladder rung.
        from repro_torch import guard
        return guard.guarded_matmul(a, b, cfg, out_dtype=out_dtype,
                                    backend=backend, mesh_shape=mesh_shape)
    if _is_prepared(b):
        from repro_torch.kernels import prepared
        check_prepared(b, cfg)
        if a.dim() != 2:
            raise ValueError(
                f"emulated_matmul is strictly 2-D; got lhs {tuple(a.shape)}"
                " — use repro_torch.api.dot_general / einsum for higher "
                "ranks")
        out_dtype = (out_dtype or (getattr(torch, cfg.out_dtype)
                                   if cfg.out_dtype else None)
                     or torch.promote_types(a.dtype, torch.float32))
        return prepared.matmul_prepared(a, b, out_dtype=out_dtype)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            f"emulated_matmul is strictly 2-D; got {tuple(a.shape)} @ "
            f"{tuple(b.shape)} — use repro_torch.api.einsum or "
            "emulated_matmul_batched")
    if cfg.scheme == "native":
        out = _promoted(cfg, a, b, out_dtype)
        return torch.matmul(a.to(out), b.to(out))
    return _run_plan(plan_emulated(a, b, cfg, out_dtype, backend,
                                   mesh_shape), a, b)


def emulated_matmul_batched(a: torch.Tensor, b: torch.Tensor, *, cfg=None,
                            out_dtype=None, backend: str | None = None,
                            mesh_shape: tuple | None = None
                            ) -> torch.Tensor:
    """Batched emulated GEMM.

    * ``b`` 2-D: leading dims of ``a`` flatten into M — one 2-D launch;
    * matching leading axes: ONE strided-batched launch over the
      collapsed leading axes (complex operands under Scheme II: the
      batched 3M plane route); complex operands under Scheme I, one 2-D
      4M route per batch element;
    * under a ``mesh_shape`` (a rank's tiles), one 2-D dispatch per batch
      element, as the reference's shard-local tiles dispatch.
    """
    if b.dim() == 2:
        lead = a.shape[:-1]
        out = emulated_matmul(a.reshape(-1, a.shape[-1]), b, cfg=cfg,
                              out_dtype=out_dtype, backend=backend,
                              mesh_shape=mesh_shape)
        return out.reshape(*lead, b.shape[-1])
    if a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(
            f"emulated_matmul_batched needs matching leading (batch) axes; "
            f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    cfg = _resolve_cfg(cfg)
    lead = a.shape[:-2]
    a3 = a.reshape((-1,) + tuple(a.shape[-2:]))
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    if mesh_shape is not None:
        out = torch.stack([emulated_matmul(x, y, cfg=cfg, out_dtype=out_dtype,
                                           backend=backend,
                                           mesh_shape=mesh_shape)
                           for x, y in zip(a3, b3)])
        return out.reshape(*lead, out.shape[-2], out.shape[-1])
    if _guarded(cfg, a3, b3):
        # The reference vmaps the 2-D dispatch under a guard: the traced
        # (counting) semantics, each element verified and counted.
        from repro_torch.guard import ladder
        out = ladder.guarded_matmul_batched(a3, b3, cfg, out_dtype=out_dtype,
                                            backend=backend)
        return out.reshape(*lead, out.shape[-2], out.shape[-1])
    if cfg.scheme == "native":
        out = _promoted(cfg, a, b, out_dtype)
        return torch.matmul(a3.to(out), b3.to(out)).reshape(
            *lead, a.shape[-2], b.shape[-1])
    if _complex(a3, b3) and cfg.scheme != "ozaki2":
        out = torch.stack([emulated_matmul(x, y, cfg=cfg, out_dtype=out_dtype,
                                           backend=backend)
                           for x, y in zip(a3, b3)])
        return out.reshape(*lead, out.shape[-2], out.shape[-1])
    out = _run_plan(plan_emulated_batched(a3, b3, cfg, out_dtype, backend),
                    a3, b3)
    return out.reshape(*lead, out.shape[-2], out.shape[-1])


# Fallback RuntimeWarnings are deduped by (reason, shape class) on the
# telemetry registry's one-shot store (always active, whether or not
# telemetry is enabled), under keys namespaced "fallback". The port falls
# back silently nowhere; the guard's spread and native-fallback warnings
# use this machinery.


def fallback_warnings_clear() -> None:
    """Forget which fallback warnings fired (tests/log hygiene)."""
    telemetry.REGISTRY.forget_once("fallback")


def _warn_fallback_once(reason: tuple, shape_class: tuple, message: str,
                        stacklevel: int = 3) -> None:
    if not telemetry.REGISTRY.once(("fallback", reason, shape_class)):
        return
    warnings.warn(message, RuntimeWarning, stacklevel=stacklevel)


def auto_fused_matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig):
    """'auto'-impl hook: the emulated GEMM on the selected backend for a
    2-D problem, else None (native configs). Unlike the reference, which
    sends a complex Scheme-I problem to its XLA expansion, a CUDA tensor
    never goes to a plain version here: 4M runs as four EmuGEMM-I
    launches (equal, bit for bit, to ``scheme1.matmul_complex_4m``)."""
    if a.dim() != 2 or b.dim() != 2 or cfg.scheme == "native":
        return None
    return emulated_matmul(a, b, cfg=cfg)


def maybe_emulated_matmul(a: torch.Tensor, b, cfg: EmulationConfig):
    """Deprecated name for :func:`auto_fused_matmul`."""
    warnings.warn(
        "maybe_emulated_matmul is deprecated; call auto_fused_matmul "
        "(or the repro_torch.dot_general/einsum front door)",
        DeprecationWarning, stacklevel=2)
    return auto_fused_matmul(a, b, cfg)


# ---------------------------------------------------------------------------
# Launch-layer policy resolution.
# ---------------------------------------------------------------------------

def _mesh_devices(mesh) -> int:
    """Device count of a launch mesh: a live ``DeviceMesh`` (its
    ``size()``), a device-free mesh (``.size``), or anything with a
    ``shape`` mapping ({axis: size}) or tuple of sizes; None means this
    process's world (1 without a process group)."""
    if mesh is None:
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1
    size = getattr(mesh, "size", None)
    if callable(size):                       # DeviceMesh.size()
        return int(size())
    if size is not None:
        return int(size)
    shape = getattr(mesh, "shape", None)
    if hasattr(shape, "values"):
        return math.prod(int(s) for s in shape.values())
    if shape is not None:
        try:
            return math.prod(int(s) for s in shape)
        except (TypeError, ValueError):
            pass
    return 1


def _mesh_shape_tuple(mesh) -> tuple | None:
    """((axis, size), ...) of a mesh, or None: the hashable mesh identity
    the block cache and prepared-operand pinning key on."""
    if mesh is None:
        return None
    names = getattr(mesh, "mesh_dim_names", None)
    shape = getattr(mesh, "shape", None)
    if names is not None and shape is not None:          # DeviceMesh
        return tuple((str(a), int(s)) for a, s in zip(names, shape))
    if hasattr(shape, "items"):
        return tuple((str(a), int(s)) for a, s in shape.items())
    if shape is not None:
        try:
            return tuple((str(i), int(s)) for i, s in enumerate(shape))
        except (TypeError, ValueError):
            return None
    return None


def _shardable_mesh(mesh) -> bool:
    """Can emulated call sites run per rank on this mesh? A live mesh
    (process groups behind named axes) of more than one device; a
    device-free mesh (the dry run) has no ranks to run on."""
    from repro_torch.launch.mesh import is_live
    return (is_live(mesh) and _mesh_devices(mesh) > 1
            and bool(_mesh_shape_tuple(mesh)))


def resolve_policy(policy, mesh=None):
    """Check a model ``GemmPolicy`` against the launch target.

    An unset default materializes the ambient config now, as the
    reference does. On a live mesh of more than one device (``launch.
    mesh``) the mesh is recorded on the returned policy
    (``GemmPolicy.mesh``), whatever the sites emulate (the reference
    records it only for a fused site): ``models.common.dense`` then runs
    each projection partitioned over its ranks (``parallel.shard_gemm``),
    which is the only route that reads the ranks' weight tiles. On a device-free mesh of several devices
    (the dry run, which executes nothing) the emulated sites rewrite to
    ``impl='xla'``, the reference's clamp; one device changes nothing.
    """
    from repro_torch import api
    if policy.default is None:
        default = api.resolve_config()
        if default.scheme != "native":
            policy = dataclasses.replace(policy, default=default)
    if mesh is None or _mesh_devices(mesh) <= 1:
        return policy
    if _shardable_mesh(mesh):
        # Recorded whatever the sites emulate: on a live mesh the weights
        # are each rank's tiles, which only the partitioned dense reads.
        return dataclasses.replace(policy, mesh=mesh)

    def fix(cfg):
        if cfg is None or cfg.scheme == "native" or cfg.impl == "xla":
            return cfg
        return dataclasses.replace(cfg, impl="xla")

    return dataclasses.replace(
        policy, default=fix(policy.default),
        overrides=tuple((s, fix(c)) for s, c in policy.overrides))
