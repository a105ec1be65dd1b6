"""Grouped-query attention of the port (``repro.models.attention``): the
chunked online-softmax ``flash_attention`` and ``attention_train`` of
the training path, and the serving step (``_project_qkv``,
``_store_step``, ``attention_step``).

``flash_attention`` is plain torch, as the reference's is plain JAX (its
Pallas flash kernel is not on this path). The reference's prefill and
single-token decode paths come with serving's remaining items
(ROADMAP.md § 1 item 2); int8 and ring-buffer KV caches and sequence
parallelism with the model zoo and multi-device items (4, 8).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import common
from repro_torch.models.common import (NATIVE_POLICY, GemmPolicy, dense,
                                       he_init, policy_einsum)

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
    q_chunk: int = 1024
    kv_chunk: int = 1024

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


def _chunk_mask(cfg: AttnConfig, q_pos, k_pos):
    """(bq, bk) boolean validity mask from absolute positions."""
    rel = q_pos[:, None] - k_pos[None, :]
    mask = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if cfg.causal:
        mask &= rel >= 0
    if cfg.window is not None:
        mask &= rel < cfg.window
    return mask


def _pad_seq(x, mult: int, value=0):
    """Pad axis 1 up to a multiple of ``mult``."""
    extra = (-x.shape[1]) % mult
    if not extra:
        return x
    pad = x.new_full((x.shape[0], extra) + tuple(x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


def flash_attention(cfg: AttnConfig, q, k, v, q_positions, k_positions,
                    kv_valid_len=None, policy: GemmPolicy = NATIVE_POLICY):
    """Exact chunked attention with an online softmax in float32.

    q: (B, Sq, H, D); k/v: (B, Sk, KVH, D); *_positions: (Sq,)/(Sk,)
    int32. kv_valid_len: keys at index >= it are masked. ``policy``
    selects the config of the two inner contractions ('attn_qk',
    'attn_av'). Ragged lengths pad to the chunk grid with a position
    sentinel that fails every mask; with causal self-attention the kv
    chunks past each q chunk's diagonal are skipped. Returns (B, Sq, H, D).
    """
    b, sq0, h, d = q.shape
    sk0 = k.shape[1]
    kvh = cfg.n_kv_heads
    g = h // kvh
    bq = min(cfg.q_chunk, sq0)
    bk = min(cfg.kv_chunk, sk0)
    q = _pad_seq(q, bq)
    k = _pad_seq(k, bk)
    v = _pad_seq(v, bk)
    q_positions = _pad_seq(q_positions[None], bq, 2 ** 30)[0]
    k_positions = _pad_seq(k_positions[None], bk, 2 ** 30)[0]
    sq, sk = q.shape[1], k.shape[1]
    if sk != sk0 and kv_valid_len is None:
        kv_valid_len = sk0
    n_q, n_k = sq // bq, sk // bk
    qc = q.reshape(b, n_q, bq, kvh, g, d)
    kc = k.reshape(b, n_k, bk, kvh, d)
    vc = v.reshape(b, n_k, bk, kvh, d)
    outs = []
    for i in range(n_q):
        qi = qc[:, i]
        q_pos = q_positions[i * bq:(i + 1) * bq]
        acc = torch.zeros((b, kvh, g, bq, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kvh, g, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, bq), dtype=torch.float32,
                        device=q.device)
        if cfg.causal and sq == sk and kv_valid_len is None:
            # Static diagonal bound: kv chunks covering rows < (i+1)*bq.
            hi = min(n_k, ((i + 1) * bq + bk - 1) // bk)
            lo = 0 if cfg.window is None else max(
                0, (i * bq - cfg.window + 1) // bk)
        else:
            lo, hi = 0, n_k
        for j in range(lo, hi):
            kj, vj = kc[:, j], vc[:, j]
            k_pos = k_positions[j * bk:(j + 1) * bk]
            s_ij = policy_einsum("bqkgd,bjkd->bkgqj", qi, kj, policy,
                                 "attn_qk", pet=torch.float32) * cfg.scale
            mask = _chunk_mask(cfg, q_pos, k_pos)
            if kv_valid_len is not None:
                kidx = j * bk + torch.arange(bk, device=q.device)
                mask &= (kidx < kv_valid_len)[None, :]
            s_ij = torch.where(mask[None, None, None], s_ij,
                               torch.full_like(s_ij, NEG_INF))
            m_new = torch.maximum(m, s_ij.amax(-1))
            p = torch.exp(s_ij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + policy_einsum(
                "bkgqj,bjkd->bkgqd", p.to(vj.dtype), vj, policy, "attn_av",
                pet=torch.float32)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, bq, h, d))
    return torch.cat(outs, dim=1)[:, :sq0].to(q.dtype)


def attention_train(params, cfg: AttnConfig, x, positions,
                    policy: GemmPolicy):
    """x: (B, S, D) -> (B, S, D); no cache."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    pos1d = positions[0]
    out = flash_attention(cfg, q, k, v, pos1d, pos1d, policy=policy)
    return dense(out.reshape(b, s, -1), params["wo"], policy, "attn")


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
