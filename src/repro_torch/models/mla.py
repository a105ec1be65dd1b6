"""Multi-head Latent Attention of the port (``repro.models.mla``,
DeepSeek-V3).

Queries and keys/values are low-rank compressed; the KV cache stores only
the latent ``c_kv`` (kv_lora_rank wide) and the shared, headless RoPE key
``k_pe`` (qk_rope_dim wide) per token.

* train / prefill (``_mla_full``): a causal online softmax over KV chunks,
  each chunk decompressed from ``c_kv`` through the 'mla_latent' policy
  site, so the (S, H, nope + v) key and value tensors never exist whole.
  The chunk sizes and the ``s % bq`` refusal are the reference's, so an
  emulated 'mla_latent' call sees the reference's shapes.
* step / decode: the absorbed form. W_UK is folded into the query and
  W_UV into the output, so attention runs against the latent cache with
  kv_lora_rank-wide per-head scores, and nothing is decompressed.

The score and output contractions are plain einsums in the reference,
not policy sites, and stay ``torch.einsum`` here; where the reference
asks for a float32 result of bf16 operands (``preferred_element_type``),
the einsum runs on float32 copies (exact products, float32 sums). The
prefill, the step and the decode write the caller's cache view in place,
as ``models.attention`` does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models import common
from repro_torch.models.common import (GemmPolicy, apply_norm, dense,
                                       he_init, init_norm, policy_einsum)

NEG_INF = -1e30


def init_mla(gen, d_model: int, n_heads: int, cfg: MLAConfig,
             dtype=torch.float32, device="cuda", lead: tuple = ()):
    """The mixer's parameters, stacked on ``lead`` (layer) axes."""
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq_a": he_init(gen, lead + (d_model, cfg.q_lora_rank), dtype,
                        device),
        "q_norm": init_norm("rms", cfg.q_lora_rank, dtype, device, lead),
        "wq_b": he_init(gen, lead + (cfg.q_lora_rank, n_heads * qk_dim),
                        dtype, device),
        "wkv_a": he_init(gen, lead + (d_model, cfg.kv_lora_rank
                                      + cfg.qk_rope_dim), dtype, device),
        "kv_norm": init_norm("rms", cfg.kv_lora_rank, dtype, device, lead),
        "wkv_b": he_init(gen, lead + (cfg.kv_lora_rank,
                                      n_heads * (cfg.qk_nope_dim
                                                 + cfg.v_dim)),
                         dtype, device),
        "wo": he_init(gen, lead + (n_heads * cfg.v_dim, d_model), dtype,
                      device),
    }


def init_mla_cache(cfg: MLAConfig, batch: int, max_seq: int,
                   dtype=torch.float32, device="cuda", lead: tuple = ()):
    """{"c_kv": (B, S, kv_lora_rank), "k_pe": (B, S, qk_rope_dim)} in
    ``dtype``, stacked on ``lead`` axes."""
    shape = lead + (batch, max_seq)
    return {"c_kv": torch.zeros(shape + (cfg.kv_lora_rank,), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros(shape + (cfg.qk_rope_dim,), dtype=dtype,
                                device=device)}


def _f32_einsum(eq: str, x, y):
    """``jnp.einsum(..., preferred_element_type=jnp.float32)``."""
    return torch.einsum(eq, x.float(), y.float())


def _queries(params, cfg: MLAConfig, n_heads, x, positions, policy):
    """(q_nope (B, S, H, nope), q_pe (B, S, H, rope) rotated)."""
    b, s, _ = x.shape
    q_lat = dense(x, params["wq_a"], policy, "attn")
    q_lat = apply_norm("rms", params["q_norm"], q_lat)
    q = dense(q_lat, params["wq_b"], policy, "attn")
    q = q.reshape(b, s, n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_pe = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, common.apply_rope(q_pe, positions)


def _latents(params, cfg: MLAConfig, x, positions, policy):
    """(c_kv (B, S, kv_lora_rank) normed, k_pe (B, S, rope) rotated)."""
    kv = dense(x, params["wkv_a"], policy, "attn")
    c_kv = apply_norm("rms", params["kv_norm"], kv[..., :cfg.kv_lora_rank])
    k_pe = common.apply_rope(kv[..., None, cfg.kv_lora_rank:],
                             positions)[:, :, 0]
    return c_kv, k_pe


def _wkv_b_split(params, cfg: MLAConfig, n_heads):
    """(W_UK (L, H, nope), W_UV (L, H, v)), views of ``wkv_b``."""
    w = params["wkv_b"].reshape(cfg.kv_lora_rank, n_heads,
                                cfg.qk_nope_dim + cfg.v_dim)
    return w[..., :cfg.qk_nope_dim], w[..., cfg.qk_nope_dim:]


def _scale(cfg: MLAConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_train(params, cfg: MLAConfig, n_heads, x, positions,
              policy: GemmPolicy, kv_chunk: int = 1024):
    """Full-sequence MLA attention: x (B, S, D) -> (B, S, D)."""
    out, _, _ = _mla_full(params, cfg, n_heads, x, positions, policy,
                          kv_chunk)
    return out


def mla_prefill(params, cfg: MLAConfig, n_heads, x, positions,
                policy: GemmPolicy, cache, kv_chunk: int = 1024):
    """Forward over the prompt: (out (B, S, D), cache) with the prompt's
    latents written into rows 0..S-1 of ``cache``, the contiguous {"c_kv",
    "k_pe"} view of one layer, in place."""
    s, clen = x.shape[1], cache["c_kv"].shape[1]
    if s > clen:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{clen}")
    out, c_kv, k_pe = _mla_full(params, cfg, n_heads, x, positions, policy,
                                kv_chunk)
    cache["c_kv"][:, :s] = c_kv
    cache["k_pe"][:, :s] = k_pe
    return out, cache


def _mla_full(params, cfg: MLAConfig, n_heads, x, positions, policy,
              kv_chunk):
    """Causal flash attention with on-the-fly KV decompression: (out,
    c_kv, k_pe)."""
    b, s, _ = x.shape
    q_nope, q_pe = _queries(params, cfg, n_heads, x, positions, policy)
    c_kv, k_pe = _latents(params, cfg, x, positions, policy)
    w_uk, w_uv = _wkv_b_split(params, cfg, n_heads)
    scale = _scale(cfg)
    bq = bk = min(kv_chunk, s)
    if s % bq:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {bq}")
    pos1d = positions[0]
    outs = []
    for i in range(s // bq):
        qn = q_nope[:, i * bq:(i + 1) * bq]
        qp = q_pe[:, i * bq:(i + 1) * bq]
        qpos = pos1d[i * bq:(i + 1) * bq]
        acc = torch.zeros((b, n_heads, bq, cfg.v_dim), dtype=torch.float32,
                          device=x.device)
        m = torch.full((b, n_heads, bq), NEG_INF, dtype=torch.float32,
                       device=x.device)
        l = torch.zeros((b, n_heads, bq), dtype=torch.float32,
                        device=x.device)
        for j in range(i + 1):
            cj = c_kv[:, j * bk:(j + 1) * bk]                   # (B, bk, L)
            pj = k_pe[:, j * bk:(j + 1) * bk]                   # (B, bk, R)
            kpos = pos1d[j * bk:(j + 1) * bk]
            # Decompress just this chunk: (B, bk, H, nope) and (B, bk, H, v).
            k_nope = policy_einsum("blc,chd->blhd", cj, w_uk, policy,
                                   "mla_latent")
            vj = policy_einsum("blc,chd->blhd", cj, w_uv, policy,
                               "mla_latent")
            s_ij = (_f32_einsum("bqhd,bjhd->bhqj", qn, k_nope)
                    + _f32_einsum("bqhr,bjr->bhqj", qp, pj)) * scale
            mask = (qpos[:, None] - kpos[None, :]) >= 0
            s_ij = torch.where(mask[None, None], s_ij,
                               torch.full_like(s_ij, NEG_INF))
            m_new = torch.maximum(m, s_ij.amax(-1))
            pij = torch.exp(s_ij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + pij.sum(-1)
            acc = acc * alpha[..., None] + _f32_einsum(
                "bhqj,bjhd->bhqd", pij.to(vj.dtype), vj)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).reshape(b, bq, -1))
    out = torch.cat(outs, dim=1).to(x.dtype)
    return dense(out, params["wo"], policy, "attn"), c_kv, k_pe


def _absorbed(params, cfg: MLAConfig, n_heads, q_nope, q_pe, ck, pk, mask,
              dtype):
    """Attention against the latent cache in the absorbed form: scores
    from W_UK folded into the query, the latent context mapped out by
    W_UV. q (B, C, H, *), cache views (B, S, *), mask (B, C, S) ->
    (B, C, H * v)."""
    b, c = q_nope.shape[:2]
    w_uk, w_uv = _wkv_b_split(params, cfg, n_heads)
    q_abs = torch.einsum("bqhd,chd->bqhc", q_nope, w_uk)
    scores = (_f32_einsum("bqhc,bsc->bhqs", q_abs, ck)
              + _f32_einsum("bqhr,bsr->bhqs", q_pe, pk)) * _scale(cfg)
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    ctx = _f32_einsum("bhqs,bsc->bqhc", w.to(ck.dtype), ck)
    out = torch.einsum("bqhc,chd->bqhd", ctx.to(dtype), w_uv)
    return out.reshape(b, c, -1)


def mla_step(params, cfg: MLAConfig, n_heads, x, start, n_new, cache,
             policy: GemmPolicy):
    """Ragged mixed prefill/decode step against per-lane latent views.

    x (B, C, D) fresh tokens, start (B,) each lane's absolute position of
    the first, n_new (B,) valid counts (see attention.attention_step for
    the padding contract). ``cache`` holds per-lane views {c_kv (B, L,
    lora), k_pe (B, L, rope)} (the engine's gathered copies): the fresh
    latents are written at each lane's start, clamped so the chunk stays
    in bounds as ``lax.dynamic_update_slice`` clamps, then the whole view
    is read. Returns (out (B, C, D), the updated view)."""
    b, c, _ = x.shape
    positions = start[:, None] + torch.arange(c, dtype=torch.int32,
                                              device=x.device)
    q_nope, q_pe = _queries(params, cfg, n_heads, x, positions, policy)
    c_new, p_new = _latents(params, cfg, x, positions, policy)
    length = cache["c_kv"].shape[1]
    st = torch.clamp(start.long(), 0, length - c)
    rows = torch.arange(b, device=x.device)[:, None]
    cols = st[:, None] + torch.arange(c, device=x.device)[None, :]
    cache["c_kv"][rows, cols] = c_new
    cache["k_pe"][rows, cols] = p_new
    k_pos = torch.arange(length, dtype=torch.int32, device=x.device)
    mask = k_pos[None, None, :] <= positions[:, :, None]          # (B, C, L)
    out = _absorbed(params, cfg, n_heads, q_nope, q_pe, cache["c_kv"],
                    cache["k_pe"], mask, x.dtype)
    return dense(out, params["wo"], policy, "attn"), cache


def mla_decode(params, cfg: MLAConfig, n_heads, x, pos, cache,
               policy: GemmPolicy):
    """Absorbed one-token step at the int position ``pos`` every lane
    takes. x: (B, 1, D); cache: the contiguous {c_kv (B, S, L), k_pe
    (B, S, R)} view, row ``pos`` (clamped into bounds) written in place.
    Returns (out (B, 1, D), cache)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _queries(params, cfg, n_heads, x, positions, policy)
    c_new, p_new = _latents(params, cfg, x, positions, policy)
    length = cache["c_kv"].shape[1]
    slot = min(max(pos, 0), length - 1)
    cache["c_kv"][:, slot:slot + 1] = c_new
    cache["k_pe"][:, slot:slot + 1] = p_new
    valid = torch.arange(length, device=x.device) <= pos
    out = _absorbed(params, cfg, n_heads, q_nope, q_pe, cache["c_kv"],
                    cache["k_pe"], valid.expand(b, 1, length), x.dtype)
    return dense(out, params["wo"], policy, "attn"), cache
