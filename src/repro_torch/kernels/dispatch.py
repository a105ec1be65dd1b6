"""Emulated-GEMM dispatch of the port: backend routing, block cache, plans.

The torch counterpart of ``repro.kernels.dispatch``:

* :func:`select_blocks` — the backend's ``choose_blocks`` memoized per
  (shape, p, out type, batch) key in a per-backend cache
  (``block_cache_info`` / ``block_cache_clear``);
* :func:`plan_emulated` / :func:`plan_emulated_batched` — one (backend,
  out type, blocks) resolution per GEMM;
* :func:`emulated_matmul` / :func:`emulated_matmul_batched` — the entry
  points for a 2-D and a strided-batched emulated GEMM;
* :func:`auto_fused_matmul` — the 'auto' hook of ``emulated_dot``.

Both backends take every shape as it is: the CUDA kernel zero-fills
ragged edges in the kernel, so nothing is padded (the reference pads to
its backend's alignment), and 'auto' never sends a CUDA tensor to the
plain version.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import backends
from repro_torch.kernels.common import Blocks

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
                  backend: str, batch: int = 1) -> Blocks | None:
    """Cached block selection through the backend registry."""
    cache = _BLOCK_CACHES.setdefault(backend, _BlockCache())
    key = (m, n, k, p, out_bytes, batch)
    if key in cache.data:
        cache.hits += 1
        return cache.data[key]
    cache.misses += 1
    blocks = backends.get_backend(backend).choose_blocks(m, n, k, p)
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

def _refuse_outside_slice(cfg: EmulationConfig, a, b) -> None:
    if cfg.guard is not None:
        raise NotImplementedError(
            "'+guard' is not ported yet (ROADMAP.md § 1 item 5)")
    if a.is_complex() or b.is_complex():
        raise NotImplementedError(
            "complex emulated GEMMs are not ported yet (ROADMAP.md § 1 "
            "item 3)")


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


def _out_dtype(cfg: EmulationConfig, a, b, out_dtype) -> torch.dtype:
    if out_dtype is None and cfg.out_dtype is not None:
        out_dtype = getattr(torch, cfg.out_dtype)
    return out_dtype or torch.promote_types(a.dtype, b.dtype)


def plan_emulated(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig,
                  out_dtype=None, backend: str | None = None) -> GemmPlan:
    """Backend, output type and cached blocks for one 2-D GEMM."""
    _refuse_outside_slice(cfg, a, b)
    m, k = a.shape
    n = b.shape[1]
    out_dtype = _out_dtype(cfg, a, b, out_dtype)
    name = backends.resolve_backend_name(backend, cfg, a.device)
    blocks = select_blocks(m, n, k, cfg.p, out_dtype.itemsize, name)
    return GemmPlan(cfg, m, n, k, out_dtype, blocks, name)


def plan_emulated_batched(a: torch.Tensor, b: torch.Tensor,
                          cfg: EmulationConfig, out_dtype=None,
                          backend: str | None = None) -> GemmPlan:
    """Backend, output type and blocks for one (B, M, K) @ (B, K, N)."""
    _refuse_outside_slice(cfg, a, b)
    batch, m, k = a.shape
    n = b.shape[-1]
    out_dtype = _out_dtype(cfg, a, b, out_dtype)
    name = backends.resolve_backend_name(backend, cfg, a.device)
    blocks = select_blocks(m, n, k, cfg.p, out_dtype.itemsize, name, batch)
    return GemmPlan(cfg, m, n, k, out_dtype, blocks, name, batch)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def _resolve_cfg(cfg) -> EmulationConfig:
    from repro_torch import api
    return api.resolve_config(cfg, default=_LEGACY_DEFAULT)


# Historical no-argument behavior of emulated_matmul: Scheme I at p=4,
# ranked below the ambient scope and env in the resolver.
_LEGACY_DEFAULT = EmulationConfig(scheme="ozaki1", p=4)


def emulated_matmul(a: torch.Tensor, b: torch.Tensor, *, cfg=None,
                    out_dtype=None, backend: str | None = None
                    ) -> torch.Tensor:
    """Emulated (M, K) @ (K, N) on the selected backend (argument >
    ``REPRO_TORCH_BACKEND`` > ``cfg.backend`` > the operands' device)."""
    cfg = _resolve_cfg(cfg)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            f"emulated_matmul is strictly 2-D; got {tuple(a.shape)} @ "
            f"{tuple(b.shape)} — use repro_torch.api.einsum or "
            "emulated_matmul_batched")
    if cfg.scheme == "native":
        out = _out_dtype(cfg, a, b, out_dtype)
        return torch.matmul(a.to(out), b.to(out))
    plan = plan_emulated(a, b, cfg, out_dtype, backend)
    return backends.get_backend(plan.backend).matmul(
        a, b, cfg, plan.out_dtype, plan.blocks)


def emulated_matmul_batched(a: torch.Tensor, b: torch.Tensor, *, cfg=None,
                            out_dtype=None, backend: str | None = None
                            ) -> torch.Tensor:
    """Batched emulated GEMM.

    * ``b`` 2-D: leading dims of ``a`` flatten into M — one 2-D launch;
    * matching leading axes: ONE strided-batched launch over the
      collapsed leading axes.
    """
    if b.dim() == 2:
        lead = a.shape[:-1]
        out = emulated_matmul(a.reshape(-1, a.shape[-1]), b, cfg=cfg,
                              out_dtype=out_dtype, backend=backend)
        return out.reshape(*lead, b.shape[-1])
    if a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(
            f"emulated_matmul_batched needs matching leading (batch) axes; "
            f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    cfg = _resolve_cfg(cfg)
    lead = a.shape[:-2]
    a3 = a.reshape((-1,) + tuple(a.shape[-2:]))
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    if cfg.scheme == "native":
        out = _out_dtype(cfg, a, b, out_dtype)
        return torch.matmul(a3.to(out), b3.to(out)).reshape(
            *lead, a.shape[-2], b.shape[-1])
    plan = plan_emulated_batched(a3, b3, cfg, out_dtype, backend)
    out = backends.get_backend(plan.backend).matmul(
        a3, b3, cfg, plan.out_dtype, plan.blocks)
    return out.reshape(*lead, out.shape[-2], out.shape[-1])


def auto_fused_matmul(a: torch.Tensor, b: torch.Tensor, cfg: EmulationConfig):
    """'auto'-impl hook: the emulated GEMM on the selected backend for a
    real 2-D problem, else None (native configs)."""
    if a.dim() != 2 or b.dim() != 2 or cfg.scheme == "native":
        return None
    return emulated_matmul(a, b, cfg=cfg)


def resolve_policy(policy):
    """Check a model ``GemmPolicy`` against what the port runs.

    The single-card slice has nothing to clamp (the reference's mesh and
    GSPMD clamps do not apply). An unset default materializes the
    ambient config now, as the reference does, and every site's config
    that the port cannot run raises here, before any weight is touched.
    """
    from repro_torch import api
    if policy.default is None:
        default = api.resolve_config()
        if default.scheme != "native":
            policy = dataclasses.replace(policy, default=default)
    for cfg in [policy.default] + [c for _, c in policy.overrides]:
        if cfg is None or cfg.scheme == "native":
            continue
        if cfg.scheme != "ozaki1":
            raise NotImplementedError(
                f"{cfg.scheme} is not ported yet (ROADMAP.md § 1 item 3)")
        if cfg.guard is not None:
            raise NotImplementedError(
                "'+guard' is not ported yet (ROADMAP.md § 1 item 5)")
    return policy
