"""Top-level language model of the port (``repro.models.model``):
embeddings -> grouped blocks -> head, for the training forward, the
ragged serving step, and the whole-batch prefill and single-token decode.

Layers are grouped by the (possibly heterogeneous) ``block_pattern``, as
in the reference: ``params["layers"]`` holds ``{"b0", ..., "b{k-1}"}``,
one per pattern entry, each leaf stacked on a leading ``n_groups`` axis,
and ``params["tail"]`` the list of the ``n_layers % k`` trailing blocks,
unstacked (recurrentgemma-2b: (rec, rec, attn) x 8 + (rec, rec)), and
with ``mtp`` (deepseek-v3-671b) ``params["mtp"]``, the multi-token
prediction group {"proj", "block", "ln"} that only training reads. The
reference's ``lax.scan`` over the groups becomes a Python loop: group by
group, each group's blocks in pattern order, then the tail. The cache
follows the same layout.

Front ends: token ids, the audio stub ((B, S, F) frames projected by
``frontend_proj``) and the vision stub (token ids, with projected
``image_embeds`` written over the first ``n_image_tokens`` positions).

Entry points: ``init_params``, ``init_cache``, ``forward_train``,
``forward_step``, ``forward_prefill``, ``forward_decode``,
``embed_inputs``, ``logits_from_hidden``, ``param_count``. They run on
``device="cuda"`` unless the caller asks for the CPU, and raise when
CUDA is asked for and absent.
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


def _groups(mcfg: ModelConfig):
    """(pattern, n_groups, tail kinds), as the reference groups layers."""
    pat = list(mcfg.block_pattern)
    n_groups = mcfg.n_layers // len(pat)
    tail = mcfg.pattern_for_layers()[n_groups * len(pat):]
    return pat, n_groups, tail


def _split(tree):
    """Each stacked leaf of a group as its list of per-group views (one
    ``unbind``: in training one gradient buffer per leaf, not per layer);
    a once-per-step ``StepPrepared`` stack as per-group pairs."""
    if isinstance(tree, dict):
        return {k: _split(v) for k, v in tree.items()}
    if isinstance(tree, StepPrepared):
        return tree.unbind()
    return torch.unbind(tree)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_layers(params, mcfg: ModelConfig) -> list:
    """Every layer's block parameters in execution order (group by group,
    each in pattern order, then the tail), views of the stacked leaves;
    ``mcfg.pattern_for_layers()`` gives their kinds. Works on a cache
    tree of the same layout too."""
    pat, n_groups, tail = _groups(mcfg)
    out = []
    if n_groups:
        parts = [_split(params["layers"][f"b{j}"]) for j in range(len(pat))]
        for g in range(n_groups):
            out += [_pick(part, g) for part in parts]
    if tail:
        out += list(params["tail"])
    return out


def init_params(mcfg: ModelConfig, seed: int = 0, device="cuda"):
    """Seeded random parameters in the reference's layout (a
    ``torch.Generator`` draws them on ``device``; the numbers differ
    from ``jax.random``'s — use :mod:`repro_torch.convert` to carry JAX
    parameters over). On ``device="meta"`` nothing is drawn and no memory
    is touched: the tree holds meta tensors of the reference's shapes and
    dtypes (``launch.steps.abstract_params``)."""
    device = resolve_device(device)
    dtype = getattr(torch, mcfg.dtype)
    pat, n_groups, tail = _groups(mcfg)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    params = {"emb": emb_init(gen, (pad_vocab(mcfg.vocab), mcfg.d_model),
                              dtype, device),
              "ln_f": init_norm(mcfg.norm, mcfg.d_model, dtype, device)}
    if not mcfg.tie_embeddings:
        params["head"] = he_init(gen, (mcfg.d_model, pad_vocab(mcfg.vocab)),
                                 dtype, device)
    if mcfg.frontend in ("audio_stub", "vision_stub"):
        params["frontend_proj"] = he_init(
            gen, (mcfg.frontend_dim, mcfg.d_model), dtype, device)
    if n_groups:
        params["layers"] = {
            f"b{j}": B.init_block(gen, kind, mcfg, dtype, device,
                                  lead=(n_groups,))
            for j, kind in enumerate(pat)}
    if tail:
        params["tail"] = [B.init_block(gen, kind, mcfg, dtype, device)
                          for kind in tail]
    if mcfg.mtp:
        d = mcfg.d_model
        params["mtp"] = {
            "proj": he_init(gen, (2 * d, d), dtype, device),
            "block": B.init_block(gen, "attn", mcfg, dtype, device),
            "ln": init_norm(mcfg.norm, d, dtype, device),
        }
    return params


def init_cache(mcfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """The contiguous cache: {"layers": {"b0": ..., ...}} stacked on
    n_groups as the parameters are, and a "tail" list. An attention
    block's leaves are k and v (batch, L, n_kv_heads, head_dim) in the
    model's type, L = max_seq, or a window's ring of min(max_seq,
    window) rows, an MLA block's c_kv (batch, L, kv_lora_rank) and k_pe
    (batch, L, qk_rope_dim); an int8 cache (``kv_cache_dtype="int8"``)
    holds int8 k and v and their float32 scales "k_scale", "v_scale"
    (..., 1). A rec block holds {"h" float32, "conv"}, an ssd block
    {"conv", "ssm" float32}."""
    device = resolve_device(device)
    dtype = getattr(torch, mcfg.dtype)
    pat, n_groups, tail = _groups(mcfg)
    cache = {}
    if n_groups:
        cache["layers"] = {
            f"b{j}": B.init_block_cache(kind, mcfg, batch, max_seq, dtype,
                                        device, lead=(n_groups,))
            for j, kind in enumerate(pat)}
    if tail:
        cache["tail"] = [B.init_block_cache(kind, mcfg, batch, max_seq,
                                            dtype, device) for kind in tail]
    return cache


def _project(x, w):
    """``jnp.einsum("...f,fd->...d", x, w)``: in the promoted type."""
    t = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(t), w.to(t))


def embed_inputs(params, mcfg: ModelConfig, inputs: dict):
    """The front end: (embeddings (B, S, D), positions (B, S) int32).

    The audio stub projects (B, S, F) frames (``inputs["tokens"]``) with
    ``frontend_proj``; token ids are looked up in ``emb``, and the vision
    stub writes the projected ``image_embeds`` (B, n, F), cast to the
    embeddings' type, over positions 0..n-1."""
    if mcfg.frontend == "audio_stub":
        x = _project(inputs["tokens"], params["frontend_proj"])
        b, s = x.shape[:2]
    else:
        ids = inputs["tokens"]
        b, s = ids.shape
        x = params["emb"][ids.long()]
        if mcfg.frontend == "vision_stub" and "image_embeds" in inputs:
            img = _project(inputs["image_embeds"],
                           params["frontend_proj"]).to(x.dtype)
            n = min(img.shape[1], s)
            x = torch.cat([img[:, :n], x[:, n:]], dim=1)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def forward_train(params, mcfg: ModelConfig, inputs: dict,
                  policy: GemmPolicy = NATIVE_POLICY, remat: bool = True):
    """Training forward: (logits (B, S, vocab_padded), mtp logits (B, S,
    vocab_padded) or None, aux loss). With ``remat`` each block runs under
    a non-reentrant activation checkpoint, as the reference wraps each
    scanned group in ``jax.checkpoint``: only the block inputs stay alive,
    and the backward recomputes each block, its weight preparation
    included. An encoder (``causal=False``) attends bidirectionally.

    With ``mtp`` (DeepSeek-V3 multi-token prediction) one more attention
    block, outside the checkpoints as in the reference, sees the final
    hidden state, normed, fused with the embedding of the *next* token,
    and predicts token t + 2 through the shared head; its aux loss is
    dropped."""
    x, positions = embed_inputs(params, mcfg, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in zip(mcfg.pattern_for_layers(),
                        unstack_layers(params, mcfg)):
        if remat:
            x, a = checkpoint(B.block_train, lp, kind, mcfg, x, positions,
                              policy, use_reentrant=False)
        else:
            x, a = B.block_train(lp, kind, mcfg, x, positions, policy)
        aux = aux + a
    mtp_logits = None
    if mcfg.mtp:
        mtp = params["mtp"]
        h = apply_norm(mcfg.norm, mtp["ln"], x)
        e = params["emb"][torch.roll(inputs["tokens"], -1, dims=1).long()]
        fused = dense(torch.cat([h, e], dim=-1), mtp["proj"], policy, "ffn")
        fused, _ = B.block_train(mtp["block"], "attn", mcfg, fused,
                                 positions, policy)
        mtp_logits = logits_from_hidden(params, mcfg, fused, policy)
    return logits_from_hidden(params, mcfg, x, policy), mtp_logits, aux


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
    with the prompt's keys and values and the recurrent blocks' states)."""
    x, positions = embed_inputs(params, mcfg, inputs)
    cache = init_cache(mcfg, x.shape[0], max_seq, x.device)
    for kind, lp, view in zip(mcfg.pattern_for_layers(),
                              unstack_layers(params, mcfg),
                              unstack_layers(cache, mcfg)):
        x, _ = B.block_prefill(lp, kind, mcfg, x, positions, policy, view)
    return logits_from_hidden(params, mcfg, x[:, -1:], policy), cache


def forward_decode(params, mcfg: ModelConfig, token, pos, cache,
                   policy: GemmPolicy = NATIVE_POLICY):
    """token: (B, 1) int32, each lane's next id (the audio stub: (B, 1, F)
    frames); pos: the int position they all take. The cache is updated
    in place. Returns (logits (B, 1, vocab_padded), cache)."""
    if mcfg.frontend == "audio_stub":
        x = _project(token, params["frontend_proj"])
    else:
        x = params["emb"][token.long()]
    for kind, lp, view in zip(mcfg.pattern_for_layers(),
                              unstack_layers(params, mcfg),
                              unstack_layers(cache, mcfg)):
        x, _ = B.block_decode(lp, kind, mcfg, x, pos, view, policy)
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
    Token ids only: a stub front end raises, and so does a rec / ssd
    block (``blocks.block_step``).
    """
    if mcfg.frontend != "none":
        raise NotImplementedError(
            "serving steps take token ids only; stub frontends "
            f"({mcfg.frontend!r}) have no ragged chunk path")
    b, c = tokens.shape
    x = params["emb"][tokens.long()]
    for kind, lp, view in zip(mcfg.pattern_for_layers(),
                              unstack_layers(params, mcfg),
                              unstack_layers(cache, mcfg)):
        x, _ = B.block_step(lp, kind, mcfg, x, start, n_new, view, policy)
    idx = torch.clamp(n_new.long() - 1, 0, c - 1)
    x_last = x[torch.arange(b, device=x.device), idx][:, None]    # (B, 1, D)
    logits = logits_from_hidden(params, mcfg, x_last, policy)
    return logits[:, 0], cache
