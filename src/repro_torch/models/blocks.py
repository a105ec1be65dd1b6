"""Residual blocks of the port (``repro.models.blocks``): (pre-norm
mixer) + (pre-norm FFN or MoE), per block kind:

  attn — GQA attention (global, or local over a ring-buffer cache), or
         MLA (``models.mla``, when ``mcfg.mla`` is set), + a dense FFN or
         ``models.moe``'s MoE
  rec  — RG-LRU recurrent mixer (``models.rglru``) + a dense FFN
  ssd  — Mamba-2 SSD mixer (``models.ssd``), no separate FFN

in the training forward (``block_train``), the ragged serving step
(``block_step``, attention only), and the whole-batch prefill and
single-token decode against a contiguous cache (``init_block_cache``,
``block_prefill``, ``block_decode``). The prefill and the decode write
the caller's cache view in place: an attention block's k / v rows, a
MLA block's latents, a recurrent block's state."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, mla, moe, rglru, ssd
from repro_torch.models.attention import AttnConfig
from repro_torch.models.common import (GemmPolicy, apply_ffn, apply_norm,
                                       init_ffn, init_norm)


def attn_config(mcfg: ModelConfig, local: bool = False) -> AttnConfig:
    return AttnConfig(
        d_model=mcfg.d_model, n_heads=mcfg.n_heads,
        n_kv_heads=mcfg.n_kv_heads, head_dim=mcfg.resolved_head_dim,
        qkv_bias=mcfg.qkv_bias, causal=mcfg.causal,
        window=mcfg.attn_window if local or mcfg.attn_window else None,
        rope_theta=mcfg.rope_theta, use_rope=mcfg.causal,
        q_chunk=mcfg.q_chunk, kv_chunk=mcfg.kv_chunk,
        cache_int8=mcfg.kv_cache_dtype == "int8",
        sp=mcfg.attn_sharding == "sp")


def init_block(gen, kind: str, mcfg: ModelConfig, dtype, device,
               lead: tuple = ()):
    d = mcfg.d_model
    p = {"ln1": init_norm(mcfg.norm, d, dtype, device, lead)}
    if kind == "attn":
        if mcfg.mla is not None:
            p["mixer"] = mla.init_mla(gen, d, mcfg.n_heads, mcfg.mla, dtype,
                                      device, lead)
        else:
            p["mixer"] = attention.init_attention(gen, attn_config(mcfg),
                                                  dtype, device, lead)
        p["ln2"] = init_norm(mcfg.norm, d, dtype, device, lead)
        if mcfg.moe is not None:
            p["moe"] = moe.init_moe(gen, d, mcfg.moe, mcfg.act, dtype,
                                    device, lead)
        else:
            p["ffn"] = init_ffn(gen, d, mcfg.d_ff, mcfg.act, dtype, device,
                                lead)
    elif kind == "rec":
        p["mixer"] = rglru.init_rglru(gen, d, mcfg.rglru, dtype, device,
                                      lead)
        p["ln2"] = init_norm(mcfg.norm, d, dtype, device, lead)
        p["ffn"] = init_ffn(gen, d, mcfg.d_ff, mcfg.act, dtype, device, lead)
    elif kind == "ssd":
        p["mixer"] = ssd.init_ssd(gen, d, mcfg.ssd, dtype, device, lead)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return p


def _ffn_part(params, mcfg: ModelConfig, x, policy: GemmPolicy):
    """The pre-norm FFN or MoE residual: (x, aux loss)."""
    h = apply_norm(mcfg.norm, params["ln2"], x)
    if "moe" in params:
        out, aux = moe.apply_moe(params["moe"], h, mcfg.moe, mcfg.act, policy)
    else:
        out, aux = apply_ffn(params["ffn"], h, mcfg.act, policy,
                             sp=mcfg.attn_sharding == "sp"), 0.0
    return x + out, aux


def block_train(params, kind: str, mcfg: ModelConfig, x, positions,
                policy: GemmPolicy):
    """One block's training forward; returns (x, aux loss)."""
    h = apply_norm(mcfg.norm, params["ln1"], x)
    if kind == "attn":
        if mcfg.mla is not None:
            mix = mla.mla_train(params["mixer"], mcfg.mla, mcfg.n_heads, h,
                                positions, policy, mcfg.kv_chunk)
        else:
            mix = attention.attention_train(params["mixer"],
                                            attn_config(mcfg), h, positions,
                                            policy)
        return _ffn_part(params, mcfg, x + mix, policy)
    if kind == "rec":
        x = x + rglru.rglru_block_train(params["mixer"], mcfg.rglru, h,
                                        policy)
        return _ffn_part(params, mcfg, x, policy)
    if kind == "ssd":
        return x + ssd.ssd_block_train(params["mixer"], mcfg.d_model,
                                       mcfg.ssd, h, policy), 0.0
    raise ValueError(kind)


def block_step(params, kind: str, mcfg: ModelConfig, x, start, n_new, cache,
               policy: GemmPolicy):
    """Ragged serving step of one attention block (see
    ``attention.attention_step``). Only attention blocks have a paged
    per-lane cache: rec / ssd state caches are refused by the serving
    engine up front."""
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} has no ragged serving step: rec/ssd state "
            "caches are lane-bound, not paged (repro_torch.serving supports "
            "attention-family architectures)")
    h = apply_norm(mcfg.norm, params["ln1"], x)
    if mcfg.mla is not None:
        mix, cache = mla.mla_step(params["mixer"], mcfg.mla, mcfg.n_heads, h,
                                  start, n_new, cache, policy)
    else:
        mix, cache = attention.attention_step(
            params["mixer"], attn_config(mcfg), h, start, n_new, cache,
            policy)
    return _ffn_part(params, mcfg, x + mix, policy)[0], cache


def init_block_cache(kind: str, mcfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device, lead: tuple = ()):
    """A block's contiguous cache, stacked on ``lead`` (layer) axes: an
    attention block's k / v (a window's ring of min(max_seq, window)
    rows), an MLA block's {"c_kv", "k_pe"}, a rec block's {"h", "conv"},
    an ssd block's {"conv", "ssm"}."""
    if kind == "attn":
        if mcfg.mla is not None:
            return mla.init_mla_cache(mcfg.mla, batch, max_seq, dtype,
                                      device, lead)
        return attention.init_cache(attn_config(mcfg), batch, max_seq, dtype,
                                    device, lead)
    if kind == "rec":
        return rglru.init_rglru_cache(mcfg.rglru, mcfg.d_model, batch, dtype,
                                      device, lead)
    if kind == "ssd":
        return ssd.init_ssd_cache(mcfg.ssd, mcfg.d_model, batch, dtype,
                                  device, lead)
    raise ValueError(kind)


def _write(view: dict, new: dict) -> dict:
    """Copy a recurrent block's new state into its cache view."""
    for name, leaf in new.items():
        view[name].copy_(leaf)
    return view


def block_prefill(params, kind: str, mcfg: ModelConfig, x, positions,
                  policy: GemmPolicy, cache):
    """One block over the whole prompt; fills ``cache`` (one layer's
    contiguous view of :func:`init_block_cache`) in place."""
    h = apply_norm(mcfg.norm, params["ln1"], x)
    if kind == "attn":
        if mcfg.mla is not None:
            mix, cache = mla.mla_prefill(params["mixer"], mcfg.mla,
                                         mcfg.n_heads, h, positions, policy,
                                         cache, mcfg.kv_chunk)
        else:
            mix, cache = attention.attention_prefill(
                params["mixer"], attn_config(mcfg), h, positions, policy,
                cache)
        return _ffn_part(params, mcfg, x + mix, policy)[0], cache
    if kind == "rec":
        mix, new = rglru.rglru_block_prefill(params["mixer"], mcfg.rglru, h,
                                             policy)
        return _ffn_part(params, mcfg, x + mix, policy)[0], _write(cache, new)
    if kind == "ssd":
        mix, new = ssd.ssd_block_prefill(params["mixer"], mcfg.d_model,
                                         mcfg.ssd, h, policy)
        return x + mix, _write(cache, new)
    raise ValueError(kind)


def block_decode(params, kind: str, mcfg: ModelConfig, x, pos, cache,
                 policy: GemmPolicy):
    """One block's single-token step at position ``pos``; updates
    ``cache`` in place."""
    h = apply_norm(mcfg.norm, params["ln1"], x)
    if kind == "attn":
        if mcfg.mla is not None:
            mix, cache = mla.mla_decode(params["mixer"], mcfg.mla,
                                        mcfg.n_heads, h, pos, cache, policy)
        else:
            mix, cache = attention.attention_decode(
                params["mixer"], attn_config(mcfg), h, pos, cache, policy)
        return _ffn_part(params, mcfg, x + mix, policy)[0], cache
    if kind == "rec":
        mix, new = rglru.rglru_block_decode(params["mixer"], mcfg.rglru, h,
                                            cache, policy)
        return _ffn_part(params, mcfg, x + mix, policy)[0], _write(cache, new)
    if kind == "ssd":
        mix, new = ssd.ssd_block_decode(params["mixer"], mcfg.d_model,
                                        mcfg.ssd, h, cache, policy)
        return x + mix, _write(cache, new)
    raise ValueError(kind)
