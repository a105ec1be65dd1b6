"""RG-LRU recurrent block of the port (``repro.models.rglru``;
RecurrentGemma / Griffin).

Block = two parallel branches from the input:
  * y-branch: linear -> causal depthwise conv1d(k) -> RG-LRU recurrence
  * gate-branch: linear -> GeLU (tanh form)
merged multiplicatively and projected back to d_model.

RG-LRU:  r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
         a_t = exp(-c * softplus(Lambda) * r_t)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill evaluate the linear recurrence with a log-depth
(Hillis-Steele) scan in torch ops: ceil(log2 S) doubling steps over the
whole sequence, where the reference runs ``jax.lax.associative_scan``.
Both combine the same pairs (a, u) -> (a_l a_r, u_l a_r + u_r) but group
the products differently, so they agree to float32 rounding, not bit for
bit. Decode is the O(1) state update. The gates (``w_r``, ``w_i``) are
plain matmuls, as the reference's ``jnp.einsum``: never emulated, never
prepared; the projections ``w_y``, ``w_gate``, ``w_out`` go through
``dense`` and the policy. h and the gates are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models.common import GemmPolicy, dense, he_init


def init_rglru(gen, d_model: int, cfg: RGLRUConfig, dtype=torch.float32,
               device="cuda", lead: tuple = ()):
    """The block's parameters, stacked on ``lead`` (layer) axes; ``lam``
    is float32 whatever ``dtype`` is, as in the reference."""
    w = cfg.lru_width or d_model
    # Lambda init so a^(1/c) ~ U[0.9, 0.999] (Griffin appendix).
    u = torch.rand(lead + (w,), generator=gen, device=device,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u)))      # softplus^-1(-log u)
    conv = torch.randn(lead + (cfg.conv_kernel, w), generator=gen,
                       device=device, dtype=torch.float32)
    return {
        "w_y": he_init(gen, lead + (d_model, w), dtype, device),
        "w_gate": he_init(gen, lead + (d_model, w), dtype, device),
        "w_out": he_init(gen, lead + (w, d_model), dtype, device),
        "conv_w": (conv * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=device),
        "lam": lam,
        "w_r": he_init(gen, lead + (w, w), dtype, device),
        "w_i": he_init(gen, lead + (w, w), dtype, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, S, W); w: (k, W).

    state: (B, k-1, W) trailing context (decode) or None (zero left-pad).
    Returns (y, new_state); the taps are summed in the reference's order.
    """
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, -(k - 1):]


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0),
    no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gates(params, cfg: RGLRUConfig, x):
    r = torch.sigmoid(torch.matmul(x, params["w_r"]))
    i = torch.sigmoid(torch.matmul(x, params["w_i"]))
    log_a = -cfg.c * _softplus(params["lam"]) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    u = beta * (i.float() * x.float())
    return a, u


def rglru_scan(a, u, h0=None):
    """h_t = a_t h_{t-1} + u_t over axis 1: a log-depth inclusive scan of
    the pairs (a, u) under (a_l, u_l) . (a_r, u_r) = (a_l a_r, u_l a_r +
    u_r), in ceil(log2 S) doubling steps."""
    if h0 is not None:
        u = torch.cat([u[:, :1] + a[:, :1] * h0[:, None], u[:, 1:]], dim=1)
    s = a.shape[1]
    shift = 1
    while shift < s:
        u = torch.cat([u[:, :shift],
                       u[:, :-shift] * a[:, shift:] + u[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return u


def rglru_block_train(params, cfg: RGLRUConfig, x, policy: GemmPolicy):
    """x: (B, S, D) -> (B, S, D), no cache."""
    y, _, _ = _rglru_forward(params, cfg, x, policy, conv_state=None, h0=None)
    return y


def init_rglru_cache(cfg: RGLRUConfig, d_model: int, batch: int,
                     dtype=torch.float32, device="cuda", lead: tuple = ()):
    """{"h": (B, W) float32, "conv": (B, k-1, W) in ``dtype``}, stacked
    on ``lead`` axes."""
    w = cfg.lru_width or d_model
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1, w),
                                dtype=dtype, device=device)}


def rglru_block_prefill(params, cfg: RGLRUConfig, x, policy: GemmPolicy):
    """(out, cache) over the prompt: the last h and the conv tail."""
    y, conv_state, h_last = _rglru_forward(params, cfg, x, policy,
                                           conv_state=None, h0=None)
    return y, {"h": h_last, "conv": conv_state}


def rglru_block_decode(params, cfg: RGLRUConfig, x, cache,
                       policy: GemmPolicy):
    """x: (B, 1, D); O(1) state update. Returns (out, new cache)."""
    y, conv_state, h_last = _rglru_forward(
        params, cfg, x, policy, conv_state=cache["conv"], h0=cache["h"])
    return y, {"h": h_last, "conv": conv_state}


def _rglru_forward(params, cfg: RGLRUConfig, x, policy, conv_state, h0):
    yb = dense(x, params["w_y"], policy, "ffn")
    gate = F.gelu(dense(x, params["w_gate"], policy, "ffn"),
                  approximate="tanh")
    yb, new_conv = _causal_conv(yb, params["conv_w"], params["conv_b"],
                                conv_state)
    a, u = _gates(params, cfg, yb)
    h = rglru_scan(a, u, h0)
    out = h.to(x.dtype) * gate
    return dense(out, params["w_out"], policy, "ffn"), new_conv, h[:, -1]
