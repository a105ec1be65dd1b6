"""Residual blocks of the port (``repro.models.blocks``): the attention
block, pre-norm attention + pre-norm dense FFN or MoE (``models.moe``,
softmax routing), in its training forward
(``block_train``), its ragged serving step (``block_step``), and its
whole-batch prefill and single-token decode against a contiguous cache
(``init_block_cache``, ``block_prefill``, ``block_decode``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe
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
    if (set(mcfg.block_pattern) != {"attn"} or mcfg.mla is not None
            or mcfg.frontend != "none" or mcfg.mtp):
        raise NotImplementedError(
            f"{mcfg.name}: only attention blocks with a dense FFN or a "
            "softmax-routed MoE are ported yet (ROADMAP.md § 1 item 4)")
    if mcfg.moe is not None and mcfg.moe.scoring != "softmax":
        raise NotImplementedError(
            f"{mcfg.name}: {mcfg.moe.scoring} MoE scoring is not ported yet "
            "(ROADMAP.md § 1 item 4.6)")


def init_block(gen, mcfg: ModelConfig, dtype, device, lead: tuple = ()):
    d = mcfg.d_model
    p = {
        "ln1": init_norm(mcfg.norm, d, dtype, device, lead),
        "mixer": attention.init_attention(gen, attn_config(mcfg), dtype,
                                          device, lead),
        "ln2": init_norm(mcfg.norm, d, dtype, device, lead),
    }
    if mcfg.moe is not None:
        p["moe"] = moe.init_moe(gen, d, mcfg.moe, mcfg.act, dtype, device,
                                lead)
    else:
        p["ffn"] = init_ffn(gen, d, mcfg.d_ff, mcfg.act, dtype, device, lead)
    return p


def _ffn_part(params, mcfg: ModelConfig, x, policy: GemmPolicy):
    """The pre-norm FFN or MoE residual: (x, aux loss)."""
    h = apply_norm(mcfg.norm, params["ln2"], x)
    if "moe" in params:
        out, aux = moe.apply_moe(params["moe"], h, mcfg.moe, mcfg.act, policy)
    else:
        out, aux = apply_ffn(params["ffn"], h, mcfg.act, policy), 0.0
    return x + out, aux


def _check_kind(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md § 1 item 4)")


def block_train(params, kind: str, mcfg: ModelConfig, x, positions,
                policy: GemmPolicy):
    """One block's training forward; returns (x, aux loss). Only the
    attention block is ported (``check_supported``)."""
    _check_kind(kind)
    h = apply_norm(mcfg.norm, params["ln1"], x)
    x = x + attention.attention_train(params["mixer"], attn_config(mcfg), h,
                                      positions, policy)
    return _ffn_part(params, mcfg, x, policy)


def block_step(params, mcfg: ModelConfig, x, start, n_new, cache,
               policy: GemmPolicy):
    """Ragged serving step of one attention block (see
    ``attention.attention_step``)."""
    h = apply_norm(mcfg.norm, params["ln1"], x)
    mix, cache = attention.attention_step(params["mixer"], attn_config(mcfg),
                                          h, start, n_new, cache, policy)
    return _ffn_part(params, mcfg, x + mix, policy)[0], cache


def init_block_cache(kind: str, mcfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device, lead: tuple = ()):
    """A block's contiguous KV cache, stacked on ``lead`` (layer) axes."""
    _check_kind(kind)
    return attention.init_cache(attn_config(mcfg), batch, max_seq, dtype,
                                device, lead)


def block_prefill(params, kind: str, mcfg: ModelConfig, x, positions,
                  policy: GemmPolicy, cache):
    """One block over the whole prompt; fills ``cache`` (one layer's
    contiguous {"k", "v"} view) in place."""
    _check_kind(kind)
    h = apply_norm(mcfg.norm, params["ln1"], x)
    mix, cache = attention.attention_prefill(params["mixer"],
                                             attn_config(mcfg), h, positions,
                                             policy, cache)
    return _ffn_part(params, mcfg, x + mix, policy)[0], cache


def block_decode(params, kind: str, mcfg: ModelConfig, x, pos, cache,
                 policy: GemmPolicy):
    """One block's single-token step at position ``pos``."""
    _check_kind(kind)
    h = apply_norm(mcfg.norm, params["ln1"], x)
    mix, cache = attention.attention_decode(params["mixer"],
                                            attn_config(mcfg), h, pos, cache,
                                            policy)
    return _ffn_part(params, mcfg, x + mix, policy)[0], cache
