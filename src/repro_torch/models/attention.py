"""Grouped-query attention of the port: the serving step
(``repro.models.attention``: ``_project_qkv``, ``_store_step``,
``attention_step``).

The train, prefill and single-token decode paths of the reference, and
its chunked ``flash_attention``, come with the training slice (ROADMAP.md
§ 1 item 2); int8 and ring-buffer KV caches with the model zoo (item 4).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import common
from repro_torch.models.common import GemmPolicy, dense, he_init, policy_einsum

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    causal: bool = True
    window: int | None = None
    rope_theta: float = 10000.0
    use_rope: bool = True
    softmax_scale: float | None = None
    cache_int8: bool = False

    @property
    def scale(self) -> float:
        return self.softmax_scale or 1.0 / math.sqrt(self.head_dim)


def init_attention(gen, cfg: AttnConfig, dtype, device, lead: tuple = ()):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {
        "wq": he_init(gen, lead + (d, h * hd), dtype, device),
        "wk": he_init(gen, lead + (d, kvh * hd), dtype, device),
        "wv": he_init(gen, lead + (d, kvh * hd), dtype, device),
        "wo": he_init(gen, lead + (h * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd),
                            ("bv", kvh * hd)):
            params[name] = torch.zeros(lead + (width,), dtype=dtype,
                                       device=device)
    return params


def _project_qkv(params, cfg: AttnConfig, x, positions, policy: GemmPolicy):
    b, s, _ = x.shape
    q = dense(x, params["wq"], policy, "attn", params.get("bq"))
    k = dense(x, params["wk"], policy, "attn", params.get("bk"))
    v = dense(x, params["wv"], policy, "attn", params.get("bv"))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def init_cache(cfg: AttnConfig, batch: int, max_seq: int, dtype, device,
               lead: tuple = ()):
    shape = lead + (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _store_step(cache, k, v, start):
    """Write each lane's fresh k/v (B, C, KVH, D) at its own ``start``.

    Updates the per-lane views in place (they are the engine's gathered
    copies, not its pools). Starts clamp so the chunk stays in bounds,
    as ``lax.dynamic_update_slice`` does.
    """
    b, c = k.shape[:2]
    length = cache["k"].shape[1]
    st = torch.clamp(start.long(), 0, length - c)
    rows = torch.arange(b, device=k.device)[:, None]
    cols = st[:, None] + torch.arange(c, device=k.device)[None, :]
    cache["k"][rows, cols] = k
    cache["v"][rows, cols] = v
    return cache


def attention_step(params, cfg: AttnConfig, x, start, n_new, cache,
                   policy: GemmPolicy):
    """Ragged mixed prefill/decode step over a per-lane cache view.

    x: (B, C, D), each lane's next chunk of fresh tokens, left-aligned;
    start: (B,) absolute position of each lane's first fresh token;
    n_new: (B,) valid counts. cache: {"k", "v"} per-lane (B, L, KVH, D)
    views. Per-lane results depend only on that lane's tokens and cache
    rows. Returns (out (B, C, D), updated cache view).
    """
    if cfg.cache_int8 or cfg.window is not None:
        raise NotImplementedError(
            "int8 and ring-buffer KV caches are not ported yet (ROADMAP.md "
            "§ 1 item 4)")
    b, c, _ = x.shape
    positions = start[:, None] + torch.arange(c, dtype=torch.int32,
                                              device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    cache = _store_step(cache, k, v, start)
    ck, cv = cache["k"], cache["v"]
    clen = ck.shape[1]
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(b, c, kvh, g, cfg.head_dim)
    s = policy_einsum("bqkgd,bjkd->bkgqj", qh, ck, policy, "attn_qk",
                      pet=torch.float32) * cfg.scale
    # Causal against the lane's own timeline: keys past its fresh
    # frontier exceed every valid query position.
    k_pos = torch.arange(clen, dtype=torch.int32, device=x.device)
    mask = k_pos[None, None, :] <= positions[:, :, None]          # (B, C, L)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    # Zero the value rows past each lane's frontier (start + n_new - 1).
    # Every valid query row weighs them exactly 0 (padding query rows,
    # whose outputs are discarded, may not), but an emulated attn_av
    # scales each value column by its max over every row, so stale rows
    # and the scratch page (written by other lanes) would change how the
    # valid rows are sliced, and a request's tokens would depend on its
    # cohort.
    # The reference keeps them (ROADMAP.md § 3 R5); native results are
    # unchanged either way.
    frontier = (start + n_new - 1)[:, None]                       # (B, 1)
    live = (k_pos[None, :] <= frontier)[:, :, None, None]         # (B, L, 1, 1)
    cv = torch.where(live, cv, torch.zeros((), dtype=cv.dtype,
                                           device=cv.device))
    out = policy_einsum("bkgqj,bjkd->bkgqd", w.to(cv.dtype), cv, policy,
                        "attn_av", pet=torch.float32)
    out = out.permute(0, 3, 1, 2, 4).reshape(
        b, c, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return dense(out, params["wo"], policy, "attn"), cache
