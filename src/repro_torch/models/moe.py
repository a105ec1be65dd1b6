"""Mixture-of-Experts layer of the port (``repro.models.moe``): GShard-style
grouped einsum dispatch.

Tokens are reshaped into ``n_groups`` groups; dispatch and combine are
one-hot einsums with a per-group capacity, and the expert FFN is three
strided-batched einsums over the (E, G*C, D) stacks (site 'moe_expert'),
the router one 2-D product (site 'moe_gate'). Every expert computes every
slot of its stack, as in the reference: the dense dispatch is kept.

Both of the reference's routing styles: qwen2-moe's softmax top-k with
gated shared experts, and deepseek-v3's sigmoid scores with a float32
``router_bias`` that shifts which experts are selected but not their
weights (the aux-loss-free balancing hook), and an ungated shared expert.

Where the reference's ops have no order that torch promises, the port
spells out the reference's: ``jax.lax.top_k`` takes the lower index
first among equal scores, so the experts are picked by a stable
descending sort; the selected weights are one-hot products (exact: one
nonzero term a sum), not a gather whose backward scatters; capacity
ranks are integer cumsums. So a step runs under
``torch.use_deterministic_algorithms(True)`` on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import (NATIVE_POLICY, GemmPolicy, apply_ffn,
                                       he_init, init_ffn, policy_einsum)


def padded_experts(cfg: MoEConfig) -> int:
    """Experts padded up to a multiple of ``pad_multiple`` (qwen2-moe: 60
    -> 64). Padding experts carry -1e30 router logits and never receive
    tokens."""
    mult = cfg.pad_multiple
    if not mult:
        return cfg.n_experts
    return ((cfg.n_experts + mult - 1) // mult) * mult


def init_moe(gen, d_model: int, cfg: MoEConfig, act: str, dtype, device,
             lead: tuple = ()):
    """The layer's parameters, stacked on ``lead`` (layer) axes. The router
    is float32 in a model of any dtype, and so is sigmoid scoring's
    zero-initialized ``router_bias`` (e,). The reference draws ``wi_gate``
    and ``wi_up`` with its ``he_init``'s default fan, the first axis of
    (e, d, f), i.e. the expert count (ROADMAP.md § 3 R8): kept, with the
    fan passed explicitly."""
    e, f = padded_experts(cfg), cfg.d_ff_expert
    params = {
        "router": he_init(gen, lead + (d_model, e), torch.float32, device),
        "wi_gate": he_init(gen, lead + (e, d_model, f), dtype, device, e),
        "wi_up": he_init(gen, lead + (e, d_model, f), dtype, device, e),
        "wo": he_init(gen, lead + (e, f, d_model), dtype, device, f),
    }
    if cfg.scoring == "sigmoid":
        params["router_bias"] = torch.zeros(lead + (e,), dtype=torch.float32,
                                            device=device)
    if cfg.n_shared:
        params["shared"] = init_ffn(gen, d_model, cfg.d_ff_shared, act,
                                    dtype, device, lead)
        if cfg.shared_gate:
            params["shared_gate"] = he_init(gen, lead + (d_model, 1), dtype,
                                            device)
    return params


def _route(params, cfg: MoEConfig, x_f32: torch.Tensor,
           policy: GemmPolicy = NATIVE_POLICY):
    """x: (G, T, D) -> (weights (G, T, K), idx (G, T, K), scores
    (G, T, E))."""
    logits = policy_einsum("gtd,de->gte", x_f32, params["router"], policy,
                           "moe_gate")
    e_pad = padded_experts(cfg)
    if e_pad != cfg.n_experts:             # mask padding experts out
        dead = torch.arange(e_pad, device=logits.device) >= cfg.n_experts
        logits = logits.masked_fill(dead, -1e30)
    if cfg.scoring == "sigmoid":           # deepseek-v3 style
        # torch.sigmoid, not the reference's spelled-out 1 / (1 + exp(-x)):
        # XLA's CPU exp and torch's differ in the last bit for ~10 % of
        # float32 inputs, so torch's formula matches jax.nn.sigmoid in
        # ~96 % of them and torch.sigmoid in ~99.6 %.
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"]  # bias affects selection only
    else:
        scores = sel = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, the lower index first among ties.
    idx = torch.sort(sel, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.top_k]
    w = (scores[..., None, :] * F.one_hot(idx, e_pad).to(scores.dtype)).sum(-1)
    if cfg.norm_topk:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, scores


def _dispatch_combine(cfg: MoEConfig, weights, idx, t: int, dtype):
    """(G, T, E, C) dispatch one-hot and combine weights in ``dtype``, and
    the capacity C.

    Token-priority ranking: earlier tokens win capacity slots; overflow is
    dropped. The one-hot tensors are built in the model dtype (their
    entries are exact 0/1 in any float format), one (G, T, E, C) term a
    ``k`` at a time.
    """
    e = padded_experts(cfg)
    k_top = cfg.top_k
    cap = max(1, int(t * k_top * cfg.capacity_factor / e))
    onehot = F.one_hot(idx, e)                                # (G,T,K,E)
    g = onehot.shape[0]
    # Rank slots in (token, k) order within each expert. The counts are
    # summed in integers: exact, as the reference's float32 cumsum, and
    # deterministic on CUDA (a float cumsum is not).
    flat = onehot.reshape(g, t * k_top, e)                    # (G,T*K,E)
    rank = (torch.cumsum(flat, dim=1) - 1).to(torch.float32) * flat
    flat = flat.to(torch.float32)
    keep = (rank < cap) * flat
    rank = (rank * keep).reshape(g, t, k_top, e)
    keep = keep.reshape(g, t, k_top, e).to(dtype)
    dispatch = torch.zeros((g, t, e, cap), dtype=dtype, device=idx.device)
    combine = torch.zeros((g, t, e, cap), dtype=dtype, device=idx.device)
    wk = weights.to(dtype)
    for k in range(k_top):  # one (G,T,E,C) one-hot live at a time
        pos_k = (F.one_hot(rank[:, :, k].long(), cap).to(dtype)
                 * keep[:, :, k, :, None])
        dispatch = dispatch + pos_k
        combine = combine + pos_k * wk[:, :, k, None, None]
    return dispatch, combine, cap


def aux_load_balance_loss(cfg: MoEConfig, scores, idx) -> torch.Tensor:
    """Switch-style: E * sum_e (fraction_tokens_e * mean_prob_e), E the
    unpadded expert count."""
    e = padded_experts(cfg)
    frac = F.one_hot(idx, e).to(torch.float32).sum(2).mean((0, 1))
    prob = scores.mean((0, 1))
    return cfg.aux_loss_weight * cfg.n_experts * torch.sum(frac * prob)


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig, act: str,
              policy: GemmPolicy):
    """x: (B, S, D) -> (out, aux_loss)."""
    b, s, d = x.shape
    tokens = b * s
    g = min(cfg.n_groups, tokens)
    while tokens % g:
        g -= 1
    t = tokens // g
    xg = x.reshape(g, t, d)
    w, idx, scores = _route(params, cfg, xg.float(), policy)
    dispatch, combine, _ = _dispatch_combine(cfg, w, idx, t, x.dtype)

    xs = torch.einsum("gtec,gtd->egcd", dispatch, xg)   # groups -> experts
    gate = policy_einsum("egcd,edf->egcf", xs, params["wi_gate"], policy,
                         "moe_expert")
    up = policy_einsum("egcd,edf->egcf", xs, params["wi_up"], policy,
                       "moe_expert")
    h = (F.silu(gate) if act == "swiglu"
         else F.gelu(gate, approximate="tanh")) * up
    ys = policy_einsum("egcf,efd->egcd", h, params["wo"], policy,
                       "moe_expert")
    out = torch.einsum("egcd,gtec->gtd", ys, combine)   # experts -> groups
    out = out.reshape(b, s, d)

    if cfg.n_shared:
        sh = apply_ffn(params["shared"], x, act, policy, site="ffn")
        if cfg.shared_gate:
            sh = sh * torch.sigmoid(
                torch.einsum("bsd,do->bso", x, params["shared_gate"]))
        out = out + sh
    return out, aux_load_balance_loss(cfg, scores, idx)
