"""Top-level language model of the port (``repro.models.model``):
embeddings -> stacked blocks -> head, for the training forward, the
ragged serving step, and the whole-batch prefill and single-token decode.

Parameters keep the reference's pytree layout: ``params["layers"]["b0"]``
holds each block weight stacked on a leading layer axis, and the
reference's ``lax.scan`` over it becomes a Python loop over that axis.

Entry points: ``init_params``, ``init_cache``, ``forward_train``,
``forward_step``, ``forward_prefill``, ``forward_decode``,
``logits_from_hidden``, ``param_count``. They run on ``device="cuda"``
unless the caller asks for the CPU, and raise when CUDA is asked for and
absent.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.prepared import StepPrepared
from repro_torch.models import blocks as B
from repro_torch.models.common import (GemmPolicy, NATIVE_POLICY, apply_norm,
                                       dense, emb_init, he_init, init_norm,
                                       pad_vocab)
from repro_torch.utils.tree import tree_leaves


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present if asked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on "
            "the CPU (its kernels then run their plain versions)")
    return device


def unstack_layers(params, n_layers: int) -> list:
    """Every layer's block parameters, views from one ``unbind`` of each
    stacked leaf (in training, one gradient buffer per leaf, not one per
    layer); a once-per-step ``StepPrepared`` stack splits into per-layer
    pairs of weight view and prep."""
    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        if isinstance(tree, StepPrepared):
            return tree.unbind()
        return torch.unbind(tree)
    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]
    parts = split(params["layers"]["b0"])
    return [pick(parts, i) for i in range(n_layers)]


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
    (n_layers, batch, max_seq, n_kv_heads, head_dim), in the model's
    type; an int8 cache (``kv_cache_dtype="int8"``) holds int8 k and v
    and their float32 scales "k_scale", "v_scale" (..., n_kv_heads, 1)."""
    B.check_supported(mcfg)
    device = resolve_device(device)
    return {"layers": {"b0": B.init_block_cache(
        "attn", mcfg, batch, max_seq, getattr(torch, mcfg.dtype), device,
        lead=(mcfg.n_layers,))}}


def embed_inputs(params, mcfg: ModelConfig, inputs: dict):
    """Token front end: (embeddings (B, S, D), positions (B, S) int32)."""
    if mcfg.frontend != "none":
        raise NotImplementedError(
            f"the {mcfg.frontend} front end is not ported yet (ROADMAP.md "
            "§ 1 item 4)")
    ids = inputs["tokens"]
    b, s = ids.shape
    x = params["emb"][ids.long()]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def forward_train(params, mcfg: ModelConfig, inputs: dict,
                  policy: GemmPolicy = NATIVE_POLICY, remat: bool = True):
    """Training forward: (logits (B, S, vocab_padded), mtp logits (None),
    aux loss). With ``remat`` each layer runs under a non-reentrant
    activation checkpoint, as the reference wraps each scanned group in
    ``jax.checkpoint``: only the layer inputs stay alive, and the
    backward recomputes each layer, its weight preparation included."""
    B.check_supported(mcfg)
    x, positions = embed_inputs(params, mcfg, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params, mcfg.n_layers):
        if remat:
            x, a = checkpoint(B.block_train, lp, "attn", mcfg, x, positions,
                              policy, use_reentrant=False)
        else:
            x, a = B.block_train(lp, "attn", mcfg, x, positions, policy)
        aux = aux + a
    return logits_from_hidden(params, mcfg, x, policy), None, aux


def logits_from_hidden(params, mcfg: ModelConfig, x, policy: GemmPolicy):
    x = apply_norm(mcfg.norm, params["ln_f"], x)
    # emb.T is a strided view: the kernel reads it in place. An untied
    # head may be a session's prepared operand (prepare_params), which
    # dense() consumes as it is.
    w = params["emb"].T if mcfg.tie_embeddings else params["head"]
    return dense(x, w, policy, "logits")


def forward_prefill(params, mcfg: ModelConfig, inputs: dict, max_seq: int,
                    policy: GemmPolicy = NATIVE_POLICY):
    """Whole-batch prefill: (logits (B, 1, vocab_padded) at the last
    prompt position, the contiguous cache of :func:`init_cache` filled
    with the prompt's keys and values)."""
    B.check_supported(mcfg)
    x, positions = embed_inputs(params, mcfg, inputs)
    cache = init_cache(mcfg, x.shape[0], max_seq, x.device)
    kv = cache["layers"]["b0"]
    for i, lp in enumerate(unstack_layers(params, mcfg.n_layers)):
        view = {name: leaf[i] for name, leaf in kv.items()}
        x, _ = B.block_prefill(lp, "attn", mcfg, x, positions, policy, view)
    return logits_from_hidden(params, mcfg, x[:, -1:], policy), cache


def forward_decode(params, mcfg: ModelConfig, token, pos, cache,
                   policy: GemmPolicy = NATIVE_POLICY):
    """token: (B, 1) int32, each lane's next id; pos: the int position
    they all take. The cache is updated in place. Returns (logits (B, 1,
    vocab_padded), cache)."""
    B.check_supported(mcfg)
    x = params["emb"][token.long()]
    kv = cache["layers"]["b0"]
    for i, lp in enumerate(unstack_layers(params, mcfg.n_layers)):
        view = {name: leaf[i] for name, leaf in kv.items()}
        x, _ = B.block_decode(lp, "attn", mcfg, x, pos, view, policy)
    return logits_from_hidden(params, mcfg, x, policy), cache


def param_count(params) -> int:
    """Elements of every parameter tensor of a float parameter tree."""
    return sum(leaf.numel() for leaf in tree_leaves(params))


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
    for i, lp in enumerate(unstack_layers(params, mcfg.n_layers)):
        view = {name: leaf[i] for name, leaf in kv.items()}
        x, _ = B.block_step(lp, mcfg, x, start, n_new, view, policy)
    idx = torch.clamp(n_new.long() - 1, 0, c - 1)
    x_last = x[torch.arange(b, device=x.device), idx][:, None]    # (B, 1, D)
    logits = logits_from_hidden(params, mcfg, x_last, policy)
    return logits[:, 0], cache
