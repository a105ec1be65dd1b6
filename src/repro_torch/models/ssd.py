"""Mamba-2 SSD (state-space duality) block of the port
(``repro.models.ssd``).

Training and prefill use the chunked SSD algorithm: quadratic,
attention-like products *within* chunks, plus a chunk-level scan for the
inter-chunk state recurrence. Decode is the O(1) recurrent update

    h_t = exp(dt_t A) h_{t-1} + dt_t * (B_t (x) outer)  ;  y_t = C_t h_t + D x_t

Layout follows the minimal reference implementation: heads H with head
dim P = ``head_dim``, a shared scalar decay A per head, one B/C group.
The intra-chunk einsums are plain torch, as the reference's are plain
JAX; the projections ``w_in`` / ``w_out`` go through ``dense`` and the
decode's state read through ``policy_einsum`` (site 'ssd_state'). The
SSM state is float32, the conv state in the model's type.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSDConfig
from repro_torch.models import rglru
from repro_torch.models.common import (GemmPolicy, apply_norm, dense, he_init,
                                       init_norm, policy_einsum)


def d_inner(d_model: int, cfg: SSDConfig) -> int:
    return cfg.expand * d_model


def n_heads(d_model: int, cfg: SSDConfig) -> int:
    return d_inner(d_model, cfg) // cfg.head_dim


def init_ssd(gen, d_model: int, cfg: SSDConfig, dtype=torch.float32,
             device="cuda", lead: tuple = ()):
    """The block's parameters, stacked on ``lead`` axes; ``dt_bias``,
    ``a_log`` and ``d_skip`` are float32, as in the reference."""
    di = d_inner(d_model, cfg)
    h = n_heads(d_model, cfg)
    conv_dim = di + 2 * cfg.d_state
    f32 = torch.float32
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt = torch.exp(torch.rand(lead + (h,), generator=gen, device=device,
                              dtype=f32) * (hi - lo) + lo)
    conv = torch.randn(lead + (cfg.conv_kernel, conv_dim), generator=gen,
                       device=device, dtype=f32)
    a_log = torch.log(torch.arange(1, h + 1, dtype=f32, device=device))
    return {
        # in_proj emits [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": he_init(gen, lead + (d_model, 2 * di + 2 * cfg.d_state + h),
                        dtype, device),
        "conv_w": (conv * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),       # softplus^-1(dt)
        "a_log": a_log.expand(lead + (h,)).clone(),
        "d_skip": torch.ones(lead + (h,), dtype=f32, device=device),
        "out_norm": init_norm("rms", di, dtype, device, lead),
        "w_out": he_init(gen, lead + (di, d_model), dtype, device),
    }


def _split_proj(params, d_model: int, cfg: SSDConfig, x, policy):
    di = d_inner(d_model, cfg)
    h = n_heads(d_model, cfg)
    zxbcdt = dense(x, params["w_in"], policy, "ffn")
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * cfg.d_state]
    dt = rglru._softplus(zxbcdt[..., -h:].float() + params["dt_bias"])
    return z, xbc, dt


def _causal_conv(x, w, b, state=None):
    """RG-LRU's depthwise causal conv, then SiLU. x: (B, S, C); w: (k, C).
    Returns (y, new_state (B, k-1, C))."""
    y, state = rglru._causal_conv(x, w, b, state)
    return F.silu(y), state


def _segsum(t):
    """'Segment sum': S[..., i, j] = sum_{j < k <= i} t[..., k], as the
    difference of two cumsums (the reference's formula), -inf above the
    diagonal."""
    s = torch.cumsum(t, dim=-1)
    ss = s[..., :, None] - s[..., None, :]
    q = t.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=t.device))
    return torch.where(mask, ss, torch.full((), float("-inf"),
                                            dtype=ss.dtype, device=ss.device))


def ssd_chunked(xh, dt, a, bmat, cmat, d_skip, chunk: int, h0=None):
    """Chunked SSD scan.

    xh: (B, S, H, P); dt: (B, S, H); a: (H,) negative decay rates;
    bmat/cmat: (B, S, N). Returns (y (B, S, H, P), final state
    (B, H, P, N)). A ragged S pads to a whole chunk with dt = 0 steps:
    decay-neutral, no state update.
    """
    b, s0, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s0)
    extra = (-s0) % q
    if extra:
        def pad(t):
            return torch.cat([t, t.new_zeros((b, extra) + tuple(t.shape[2:]))],
                             dim=1)
        xh, dt, bmat, cmat = pad(xh), pad(dt), pad(bmat), pad(cmat)
    s = s0 + extra
    c = s // q
    xc = xh.reshape(b, c, q, h, p)
    dtc = dt.reshape(b, c, q, h)
    bc = bmat.reshape(b, c, q, n)
    cc = cmat.reshape(b, c, q, n)

    da = dtc * a[None, None, None, :]                 # (B,C,Q,H) negative
    da_cs = torch.cumsum(da, dim=2)                   # within-chunk cumsum
    # Intra-chunk (attention-like):
    l = torch.exp(_segsum(da.permute(0, 1, 3, 2)))    # (B,C,H,Q,Q)
    att = torch.einsum("bcqn,bckn,bchqk->bchqk", cc, bc, l)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", att, dtc, xc)

    # Chunk-final states: (B,C,H,P,N)
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)      # (B,C,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn",
                          bc, decay_states * dtc, xc)

    # Inter-chunk recurrence over the C axis (sequential, C is small).
    chunk_decay = torch.exp(da_cs[:, :, -1, :])                # (B,C,H)
    carry = h0 if h0 is not None else xh.new_zeros((b, h, p, n))
    prev = []
    for ci in range(c):
        prev.append(carry)       # the *incoming* state of this chunk
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                     # (B,C,H,P,N)

    # Off-diagonal contribution from the incoming state of each chunk.
    state_decay = torch.exp(da_cs)                             # (B,C,Q,H)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, state_decay,
                         prev_states)

    y = (y_diag + y_off).reshape(b, s, h, p)
    y = y + d_skip[None, None, :, None] * xh
    return y[:, :s0], carry


def ssd_block_train(params, d_model: int, cfg: SSDConfig, x,
                    policy: GemmPolicy):
    y, _, _ = _ssd_forward(params, d_model, cfg, x, policy, None, None)
    return y


def init_ssd_cache(cfg: SSDConfig, d_model: int, batch: int,
                   dtype=torch.float32, device="cuda", lead: tuple = ()):
    """{"conv": (B, k-1, conv_dim) in ``dtype``, "ssm": (B, H, P, N)
    float32}, stacked on ``lead`` axes."""
    di = d_inner(d_model, cfg)
    h = n_heads(d_model, cfg)
    conv_dim = di + 2 * cfg.d_state
    return {"conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1,
                                        conv_dim), dtype=dtype, device=device),
            "ssm": torch.zeros(lead + (batch, h, cfg.head_dim, cfg.d_state),
                               dtype=torch.float32, device=device)}


def ssd_block_prefill(params, d_model: int, cfg: SSDConfig, x,
                      policy: GemmPolicy):
    y, conv_state, ssm_state = _ssd_forward(params, d_model, cfg, x, policy,
                                            None, None)
    return y, {"conv": conv_state, "ssm": ssm_state}


def ssd_block_decode(params, d_model: int, cfg: SSDConfig, x, cache,
                     policy: GemmPolicy):
    """x: (B, 1, D): the recurrent update, no chunking. Returns (out,
    new cache)."""
    z, xbc, dt = _split_proj(params, d_model, cfg, x, policy)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   cache["conv"])
    di = d_inner(d_model, cfg)
    h = n_heads(d_model, cfg)
    xh = xbc[..., :di].reshape(x.shape[0], h, cfg.head_dim)
    bmat = xbc[:, 0, di:di + cfg.d_state]
    cmat = xbc[:, 0, di + cfg.d_state:]
    a = -torch.exp(params["a_log"])
    dt1 = dt[:, 0]                                    # (B,H)
    decay = torch.exp(dt1 * a)                        # (B,H)
    xf = xh.float()
    upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xf, bmat.float())
    ssm = cache["ssm"] * decay[..., None, None] + upd
    y = policy_einsum("bhpn,bn->bhp", ssm, cmat.float(), policy, "ssd_state")
    y = y + params["d_skip"][None, :, None] * xf
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = apply_norm("rms", params["out_norm"], y * F.silu(z))
    return dense(y, params["w_out"], policy, "ffn"), \
        {"conv": conv_state, "ssm": ssm}


def _ssd_forward(params, d_model, cfg, x, policy, conv_state, h0):
    b, s, _ = x.shape
    z, xbc, dt = _split_proj(params, d_model, cfg, x, policy)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    di = d_inner(d_model, cfg)
    h = n_heads(d_model, cfg)
    xh = xbc[..., :di].reshape(b, s, h, cfg.head_dim).float()
    bmat = xbc[..., di:di + cfg.d_state].float()
    cmat = xbc[..., di + cfg.d_state:].float()
    a = -torch.exp(params["a_log"])
    y, final = ssd_chunked(xh, dt, a, bmat, cmat, params["d_skip"],
                           cfg.chunk, h0)
    y = y.reshape(b, s, di).to(x.dtype)
    y = apply_norm("rms", params["out_norm"], y * F.silu(z))
    return dense(y, params["w_out"], policy, "ffn"), new_conv, final
