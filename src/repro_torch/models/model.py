"""Top-level language model of the port (``repro.models.model``):
embeddings -> stacked blocks -> head, for the serving step.

Parameters keep the reference's pytree layout: ``params["layers"]["b0"]``
holds each block weight stacked on a leading layer axis, and the
reference's ``lax.scan`` over it becomes a Python loop over that axis.

Entry points: ``init_params``, ``init_cache``, ``forward_step``,
``logits_from_hidden``. They run on ``device="cuda"`` unless the caller
asks for the CPU, and raise when CUDA is asked for and absent.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.attention import init_cache as attn_init_cache
from repro_torch.models.common import (GemmPolicy, NATIVE_POLICY, apply_norm,
                                       dense, emb_init, he_init, init_norm,
                                       pad_vocab)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present if asked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on "
            "the CPU (its kernels then run their plain versions)")
    return device


def layer(params, i: int):
    """Layer ``i``'s block parameters, sliced from the stacked leaves."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"]["b0"])


def init_params(mcfg: ModelConfig, seed: int = 0, device="cuda"):
    """Seeded random parameters in the reference's layout (a
    ``torch.Generator`` draws them on ``device``; the numbers differ
    from ``jax.random``'s — use :mod:`repro_torch.convert` to carry JAX
    parameters over)."""
    B.check_supported(mcfg)
    device = resolve_device(device)
    dtype = getattr(torch, mcfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"emb": emb_init(gen, (pad_vocab(mcfg.vocab), mcfg.d_model),
                              dtype, device),
              "ln_f": init_norm(mcfg.norm, mcfg.d_model, dtype, device)}
    if not mcfg.tie_embeddings:
        params["head"] = he_init(gen, (mcfg.d_model, pad_vocab(mcfg.vocab)),
                                 dtype, device)
    params["layers"] = {"b0": B.init_block(gen, mcfg, dtype, device,
                                           lead=(mcfg.n_layers,))}
    return params


def init_cache(mcfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Per-lane KV cache views: {"layers": {"b0": {"k", "v"}}}, each
    (n_layers, batch, max_seq, n_kv_heads, head_dim)."""
    B.check_supported(mcfg)
    device = resolve_device(device)
    return {"layers": {"b0": attn_init_cache(
        B.attn_config(mcfg), batch, max_seq, getattr(torch, mcfg.dtype),
        device, lead=(mcfg.n_layers,))}}


def logits_from_hidden(params, mcfg: ModelConfig, x, policy: GemmPolicy):
    x = apply_norm(mcfg.norm, params["ln_f"], x)
    # emb.T is a strided view: the kernel reads it in place.
    w = params["emb"].T if mcfg.tie_embeddings else params["head"]
    return dense(x, w, policy, "logits")


def forward_step(params, mcfg: ModelConfig, tokens, start, n_new, cache,
                 policy: GemmPolicy = NATIVE_POLICY):
    """Ragged mixed prefill/decode step for the continuous-batching engine.

    tokens: (B, C) int32, each lane's next chunk of fresh ids, left-aligned
    and zero-padded; start: (B,) absolute position of each lane's first
    fresh token; n_new: (B,) valid counts. cache: per-lane views (the
    pytree of :func:`init_cache`), updated in place. Returns (logits
    (B, vocab_padded) at each lane's last valid fresh position, cache).
    """
    B.check_supported(mcfg)
    b, c = tokens.shape
    x = params["emb"][tokens.long()]
    kv = cache["layers"]["b0"]
    for i in range(mcfg.n_layers):
        view = {"k": kv["k"][i], "v": kv["v"][i]}
        x, _ = B.block_step(layer(params, i), mcfg, x, start, n_new, view,
                            policy)
    idx = torch.clamp(n_new.long() - 1, 0, c - 1)
    x_last = x[torch.arange(b, device=x.device), idx][:, None]    # (B, 1, D)
    logits = logits_from_hidden(params, mcfg, x_last, policy)
    return logits[:, 0], cache
