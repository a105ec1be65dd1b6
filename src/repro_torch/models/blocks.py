"""Residual blocks of the port (``repro.models.blocks``): the attention
block, pre-norm attention + pre-norm dense FFN, in its training forward
(``block_train``) and its serving step (``block_step``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.attention import AttnConfig
from repro_torch.models.common import (GemmPolicy, apply_ffn, apply_norm,
                                       init_ffn, init_norm)


def attn_config(mcfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=mcfg.d_model, n_heads=mcfg.n_heads,
        n_kv_heads=mcfg.n_kv_heads, head_dim=mcfg.resolved_head_dim,
        qkv_bias=mcfg.qkv_bias, causal=mcfg.causal,
        window=mcfg.attn_window, rope_theta=mcfg.rope_theta,
        use_rope=mcfg.causal, q_chunk=mcfg.q_chunk, kv_chunk=mcfg.kv_chunk,
        cache_int8=mcfg.kv_cache_dtype == "int8")


def check_supported(mcfg: ModelConfig) -> None:
    """Raise for anything of the reference's block zoo outside the slice."""
    if (set(mcfg.block_pattern) != {"attn"} or mcfg.moe is not None
            or mcfg.mla is not None or mcfg.frontend != "none" or mcfg.mtp):
        raise NotImplementedError(
            f"{mcfg.name}: only dense attention blocks are ported yet "
            "(ROADMAP.md § 1 item 4)")


def init_block(gen, mcfg: ModelConfig, dtype, device, lead: tuple = ()):
    d = mcfg.d_model
    return {
        "ln1": init_norm(mcfg.norm, d, dtype, device),
        "mixer": attention.init_attention(gen, attn_config(mcfg), dtype,
                                          device, lead),
        "ln2": init_norm(mcfg.norm, d, dtype, device),
        "ffn": init_ffn(gen, d, mcfg.d_ff, mcfg.act, dtype, device, lead),
    }


def _ffn_part(params, mcfg: ModelConfig, x, policy: GemmPolicy):
    h = apply_norm(mcfg.norm, params["ln2"], x)
    return x + apply_ffn(params["ffn"], h, mcfg.act, policy)


def block_train(params, kind: str, mcfg: ModelConfig, x, positions,
                policy: GemmPolicy):
    """One block's training forward; returns (x, aux loss). Only the
    dense attention block is ported (``check_supported``)."""
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md § 1 item 4)")
    h = apply_norm(mcfg.norm, params["ln1"], x)
    x = x + attention.attention_train(params["mixer"], attn_config(mcfg), h,
                                      positions, policy)
    return _ffn_part(params, mcfg, x, policy), 0.0


def block_step(params, mcfg: ModelConfig, x, start, n_new, cache,
               policy: GemmPolicy):
    """Ragged serving step of one attention block (see
    ``attention.attention_step``)."""
    h = apply_norm(mcfg.norm, params["ln1"], x)
    mix, cache = attention.attention_step(params["mixer"], attn_config(mcfg),
                                          h, start, n_new, cache, policy)
    return _ffn_part(params, mcfg, x + mix, policy), cache
