"""Grouped-query attention of the port (``repro.models.attention``): the
chunked online-softmax ``flash_attention`` and ``attention_train`` of
the training path, the ragged serving step of the continuous engine
(``_project_qkv``, ``_store_step``, ``attention_step``), and the
whole-batch prefill and single-token decode against a contiguous cache
(``_store``, ``attention_prefill``, ``attention_decode``).

The cache holds k and v in the model's type or, with ``cache_int8``, as
int8 with a float32 scale per (token, head) (``quantize_kv``): the
stores quantize, and the step and the decode read the whole view
dequantized, while the prefill attends with its fresh, unquantized k
and v, as in the reference.

A local-attention layer (``window``) keeps a ring buffer of
min(max_seq, window) rows: the prefill stores the prompt's last rows
rolled so that position p sits at slot p % length, and the decode writes
slot pos % length and rebuilds each slot's absolute position for the
mask, as the reference does. The ragged serving step takes global
layers only (the continuous engine refuses a ring).

``flash_attention`` is plain torch, as the reference's is plain JAX (its
Pallas flash kernel is not on this path). ``AttnConfig.sp`` is the reference's sequence-parallel flag (an arch
with ``attn_sharding="sp"``): carried, and a no-op, since every rank of
the port holds the whole activations and the reference's sharding
constraints then change nothing it computes (ROADMAP.md § 3).
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
    q_chunk: int = 1024
    kv_chunk: int = 1024
    softmax_scale: float | None = None
    cache_int8: bool = False
    sp: bool = False               # sequence parallel: carried, a no-op

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


def cache_shape(cfg: AttnConfig, batch: int, max_seq: int):
    """Local-window layers allocate a ring buffer of window size."""
    length = min(max_seq, cfg.window) if cfg.window else max_seq
    return (batch, length, cfg.n_kv_heads, cfg.head_dim)


def cache_leaves(cfg: AttnConfig, dtype) -> dict:
    """The cache's leaves, name -> (dtype, last dim): k and v in
    ``dtype``, or int8 k and v with float32 scales (last dim 1)."""
    hd = cfg.head_dim
    if cfg.cache_int8:
        return {"k": (torch.int8, hd), "v": (torch.int8, hd),
                "k_scale": (torch.float32, 1), "v_scale": (torch.float32, 1)}
    return {"k": (dtype, hd), "v": (dtype, hd)}


def init_cache(cfg: AttnConfig, batch: int, max_seq: int, dtype, device,
               lead: tuple = ()):
    shape = lead + cache_shape(cfg, batch, max_seq)[:-1]
    return {name: torch.zeros(shape + (last,), dtype=t, device=device)
            for name, (t, last) in cache_leaves(cfg, dtype).items()}


def quantize_kv(x):
    """Per-(token, head) symmetric int8 quantization (B, S, KVH, D):
    (int8 values, float32 scales (B, S, KVH, 1)); the max is taken in
    x's type, the rest in float32 IEEE arithmetic, as the reference
    does. The 127 is a tensor on x's device: a CUDA division by a Python
    scalar multiplies by its rounded reciprocal instead."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True).to(torch.float32)
    scale = torch.clamp(scale, min=1e-8) / scale.new_full((), 127.0)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _fresh(cfg: AttnConfig, k, v) -> dict:
    """The cache leaves of fresh k / v: themselves, or quantized."""
    if cfg.cache_int8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _read(cfg: AttnConfig, cache, dtype):
    """The whole cache view's k and v, dequantized into ``dtype`` when
    the cache is int8."""
    if cfg.cache_int8:
        return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
                dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def _store(cfg: AttnConfig, cache, k, v, slot):
    """Write fresh k/v (B, S, KVH, D), quantized with an int8 cache, at
    ``slot`` along every lane's sequence axis, in place. The slot clamps
    so the write stays in bounds, as ``lax.dynamic_update_slice`` does."""
    s, length = k.shape[1], cache["k"].shape[1]
    slot = min(max(int(slot), 0), length - s)
    for name, val in _fresh(cfg, k, v).items():
        cache[name][:, slot:slot + s] = val
    return cache


def attention_prefill(params, cfg: AttnConfig, x, positions,
                      policy: GemmPolicy, cache):
    """Forward over the prompt: x (B, S, D) -> (out (B, S, D), cache
    filled to S). ``cache`` is the contiguous {"k", "v"} (B, L, KVH, D)
    view to fill in place (one layer of the model's cache). A window
    layer's ring shorter than the prompt keeps the prompt's last L rows,
    rolled so that position p sits at slot p % L (the decode's
    contract)."""
    b, s, _ = x.shape
    clen = cache["k"].shape[1]
    if s > clen and cfg.window is None:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{clen}")
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    pos1d = positions[0]
    out = flash_attention(cfg, q, k, v, pos1d, pos1d, policy=policy)
    if clen >= s:
        cache = _store(cfg, cache, k, v, 0)
    else:
        shift = (s - clen) % clen
        cache = _store(cfg, cache, torch.roll(k[:, s - clen:], shift, 1),
                       torch.roll(v[:, s - clen:], shift, 1), 0)
    return dense(out.reshape(b, s, -1), params["wo"], policy, "attn"), cache


def attention_decode(params, cfg: AttnConfig, x, pos, cache,
                     policy: GemmPolicy):
    """One-token step. x: (B, 1, D); pos: the int absolute position every
    lane takes. A global layer writes row ``pos``, a window layer's ring
    row ``pos % L``. Updates the contiguous (B, L, KVH, ...) cache in
    place and attends to all of it (dequantized when int8); returns
    (out (B, 1, D), cache)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    clen = cache["k"].shape[1]
    slot = pos % clen if cfg.window else pos
    cache = _store(cfg, cache, k, v, slot)
    ck, cv = _read(cfg, cache, x.dtype)
    idx = torch.arange(clen, dtype=torch.int32, device=x.device)
    if cfg.window and pos >= clen:
        # A wrapped ring: the absolute position of slot i given the write
        # position.
        k_positions = torch.where(idx <= slot, pos - slot + idx,
                                  pos - slot - clen + idx)
    else:
        k_positions = idx
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(b, kvh, g, cfg.head_dim)
    s = policy_einsum("bkgd,bjkd->bkgj", qh, ck, policy, "attn_qk",
                      pet=torch.float32) * cfg.scale
    mask = _chunk_mask(cfg, positions[0], k_positions)[0]        # (clen,)
    if not cfg.window:
        # With a window, unwritten ring rows fail the causal mask by their
        # positions (the reference's expression masks by ``valid`` only
        # without one).
        mask &= idx < pos + 1
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = policy_einsum("bkgj,bjkd->bkgd", w.to(cv.dtype), cv, policy,
                        "attn_av", pet=torch.float32)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return dense(out, params["wo"], policy, "attn"), cache


def _store_step(cfg: AttnConfig, cache, k, v, start):
    """Write each lane's fresh k/v (B, C, KVH, D), quantized with an
    int8 cache, at its own ``start``.

    Updates the per-lane views in place (they are the engine's gathered
    copies, not its pools). Starts clamp so the chunk stays in bounds,
    as ``lax.dynamic_update_slice`` does.
    """
    b, c = k.shape[:2]
    length = cache["k"].shape[1]
    st = torch.clamp(start.long(), 0, length - c)
    rows = torch.arange(b, device=k.device)[:, None]
    cols = st[:, None] + torch.arange(c, device=k.device)[None, :]
    for name, val in _fresh(cfg, k, v).items():
        cache[name][rows, cols] = val
    return cache


def attention_step(params, cfg: AttnConfig, x, start, n_new, cache,
                   policy: GemmPolicy):
    """Ragged mixed prefill/decode step over a per-lane cache view.

    x: (B, C, D), each lane's next chunk of fresh tokens, left-aligned;
    start: (B,) absolute position of each lane's first fresh token;
    n_new: (B,) valid counts. cache: per-lane (B, L, KVH, ...) views of
    k and v, with their scales when int8: the fresh chunk is stored
    first, then the whole view is read (dequantized), so a prefill chunk
    attends to its own tokens as the cache holds them. Per-lane results
    depend only on that lane's tokens and cache rows. A window layer's
    ring has no per-lane paged layout: the continuous engine refuses
    such architectures, and the step masks causally only, as the
    reference's does. Returns (out (B, C, D), updated cache view).
    """
    b, c, _ = x.shape
    positions = start[:, None] + torch.arange(c, dtype=torch.int32,
                                              device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    cache = _store_step(cfg, cache, k, v, start)
    ck, cv = _read(cfg, cache, x.dtype)
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
