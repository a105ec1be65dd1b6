"""Paged KV cache of the port (``repro.serving.kv_cache``): fixed-size
pages, free-list allocator, block tables.

Every model cache leaf (n_layers, B, S, *rest: an attention layer's
(KVH, D), D 1 for the scales of an int8 cache; an MLA layer's latent
width) is re-laid-out into a **pool** (n_layers, num_pages * page_size,
*rest) whose token axis is physical slots; each request owns an ordered
page list recorded in a block table. A serving step then

  gather  — block table -> contiguous per-lane views in the exact layout
            of :func:`repro_torch.models.model.init_cache`;
  scatter — the chunk of freshly written slots copied back from the views
            into the pools at ``table[pos // page] * page + pos % page``.

Page 0 is a scratch page that is never allocated: padded table entries
and invalid writes land there, and the causal mask never reads it.

The reference discovers each leaf's batch and sequence axes with
``jax.eval_shape`` and refuses a leaf with no sequence axis; the port's
only pageable layouts are the global attention and MLA blocks', whose
axes are fixed (batch 1, sequence 2), and :class:`PagedKVCache` refuses
every other up front with ``NotImplementedError``: a rec / ssd state and
a window layer's ring are lane-bound, and a stub front end has no ragged
token path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import model as M

SCRATCH_PAGE = 0


def check_pageable(mcfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every cache leaf of ``mcfg`` is a
    global attention layer's k / v (or scales), and its inputs are token
    ids."""
    lane_bound = sorted(set(mcfg.block_pattern) - {"attn"})
    if lane_bound or mcfg.attn_window:
        what = (f"{'/'.join(lane_bound)} state" if lane_bound
                else "the local-attention window ring")
        raise NotImplementedError(
            f"{mcfg.name}: {what} has no sequence axis; its cache is "
            "lane-bound (rec/ssd/window ring) and cannot be paged; "
            "repro_torch.serving pages attention-family caches only (use "
            "LockstepEngine)")
    if mcfg.frontend != "none":
        raise NotImplementedError(
            f"{mcfg.name}: serving steps take token ids only; stub "
            f"frontends ({mcfg.frontend!r}) have no ragged chunk path")


class PageAllocator:
    """Free-list page allocator over ``num_pages`` physical pages.

    Page 0 (scratch) is reserved at construction. Allocation is
    all-or-nothing per request; double-frees, foreign frees and leaks
    are hard errors."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least one page beyond scratch")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> low pages
        self._owner: dict[int, int] = {}                 # page -> rid
        self.high_water = 0
        self.alloc_failures = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._owner)

    def alloc(self, n: int, rid: int) -> list[int] | None:
        if n < 0:
            raise ValueError("negative page count")
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = rid
        self.high_water = max(self.high_water, len(self._owner))
        return pages

    def free(self, pages: list[int], rid: int) -> None:
        for p in pages:
            if p == SCRATCH_PAGE:
                raise ValueError("attempt to free the scratch page")
            owner = self._owner.get(p)
            if owner is None:
                raise ValueError(f"double free of page {p}")
            if owner != rid:
                raise ValueError(
                    f"request {rid} freeing page {p} owned by {owner}")
            del self._owner[p]
            self._free.append(p)

    def owned_by(self, rid: int) -> list[int]:
        return [p for p, o in self._owner.items() if o == rid]

    def check_leaks(self, live_rids: set[int]) -> None:
        leaked = {p: o for p, o in self._owner.items() if o not in live_rids}
        if leaked:
            raise AssertionError(f"leaked pages (page -> rid): {leaked}")

    def stats(self) -> dict:
        return {"num_pages": self.num_pages, "used": self.used_pages,
                "free": self.free_pages, "high_water": self.high_water,
                "alloc_failures": self.alloc_failures,
                "occupancy": self.used_pages / max(1, self.num_pages - 1)}


class PagedKVCache:
    """Pools + block tables for one serving session on ``device``."""

    def __init__(self, mcfg: ModelConfig, *, page_size: int, num_pages: int,
                 max_seq: int, chunk: int, device="cuda"):
        if page_size < 1 or chunk < 1:
            raise ValueError("page_size and chunk must be >= 1")
        check_pageable(mcfg)
        self.mcfg = mcfg
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_seq = max_seq
        self.chunk = chunk
        self.device = M.resolve_device(device)
        # Views cover max start (max_seq - 1) + chunk tokens, so every
        # per-lane chunk write stays in bounds.
        self.view_pages = math.ceil((max_seq - 1 + chunk) / page_size)
        self.view_tokens = self.view_pages * page_size
        self.allocator = PageAllocator(num_pages)
        self._tables: dict[int, list[int]] = {}

    # ---- host-side page accounting -------------------------------------

    def pages_needed(self, total_tokens: int) -> int:
        return math.ceil(total_tokens / self.page_size)

    def ensure(self, rid: int, total_tokens: int) -> bool:
        """Grow ``rid``'s page list to cover ``total_tokens``; False if
        the allocator cannot satisfy it (caller keeps prior pages)."""
        have = self._tables.get(rid, [])
        need = self.pages_needed(total_tokens) - len(have)
        if need <= 0:
            return True
        if need > self.view_pages - len(have):
            return False
        got = self.allocator.alloc(need, rid)
        if got is None:
            return False
        self._tables[rid] = have + got
        return True

    def release(self, rid: int) -> None:
        pages = self._tables.pop(rid, [])
        if pages:
            self.allocator.free(pages, rid)

    def table_row(self, rid: int) -> np.ndarray:
        row = np.full((self.view_pages,), SCRATCH_PAGE, dtype=np.int32)
        pages = self._tables.get(rid, [])
        row[:len(pages)] = pages
        return row

    def tables_for(self, rids: list[int | None]) -> torch.Tensor:
        """(len(rids), view_pages) block table; None lanes -> all-scratch."""
        rows = [self.table_row(r) if r is not None
                else np.full((self.view_pages,), SCRATCH_PAGE, np.int32)
                for r in rids]
        return torch.from_numpy(np.stack(rows)).to(self.device)

    def live_rids(self) -> set[int]:
        return set(self._tables)

    def stats(self) -> dict:
        return self.allocator.stats()

    # ---- device-side pools ---------------------------------------------

    def init_pools(self):
        """{"layers": {"b0": {...}}}: a pool (n_layers, num_pages *
        page_size, *rest) for each leaf of the block's cache (batch,
        seq, *rest), in the leaf's type: "k", "v" (n_kv_heads, head_dim)
        in the model's type, or int8 with float32 "k_scale", "v_scale"
        (n_kv_heads, 1); an MLA block's "c_kv" (kv_lora_rank) and "k_pe"
        (qk_rope_dim). Every pool starts at zero, so a stale or scratch
        row of an int8 pool dequantizes to zero."""
        m = self.mcfg
        slots = self.num_pages * self.page_size
        leaves = B.init_block_cache("attn", m, 1, 1, getattr(torch, m.dtype),
                                    "meta")
        return {"layers": {"b0": {
            name: torch.zeros((m.n_layers, slots) + tuple(leaf.shape[2:]),
                              dtype=leaf.dtype, device=self.device)
            for name, leaf in leaves.items()}}}

    def gather(self, pools, tables: torch.Tensor):
        """Pools + (B, view_pages) tables -> per-lane contiguous views."""
        ps = self.page_size
        b = tables.shape[0]
        flat = (tables.long()[:, :, None] * ps
                + torch.arange(ps, device=tables.device)[None, None, :]
                ).reshape(b, -1)                       # (B, view_tokens)
        return {"layers": {"b0": {name: pool[:, flat]
                                  for name, pool in
                                  pools["layers"]["b0"].items()}}}

    def scatter(self, pools, tables, views, start, n_new, chunk: int):
        """Copy each lane's freshly written view slots
        ``[start, start + chunk)`` back into the pools, in place. Columns
        past ``n_new`` (and positions without an allocated page) land on
        the scratch page."""
        ps = self.page_size
        tables = tables.long()
        cols = torch.arange(chunk, device=tables.device)
        pos = start.long()[:, None] + cols[None, :]               # (B, C)
        valid = cols[None, :] < n_new.long()[:, None]
        pidx = torch.clamp(pos // ps, 0, tables.shape[1] - 1)
        page = torch.gather(tables, 1, pidx)
        dest = torch.where(valid & (page != SCRATCH_PAGE),
                           page * ps + pos % ps, cols[None, :] % ps)
        flat = dest.reshape(-1)                                   # (B*C,)
        # The views' chunk starts clamp like lax.dynamic_slice.
        src_len = next(iter(views["layers"]["b0"].values())).shape[2]
        st = torch.clamp(start.long(), 0, src_len - chunk)
        rows = torch.arange(tables.shape[0], device=tables.device)[:, None]
        src = (st[:, None] + cols[None, :])
        for name, pool in pools["layers"]["b0"].items():
            fresh = views["layers"]["b0"][name][:, rows, src]     # (L, B, C, ..)
            pool[:, flat] = fresh.reshape(
                (fresh.shape[0], -1) + tuple(fresh.shape[3:]))
        return pools
