"""Shared model primitives of the port (``repro.models.common``).

Parameters are plain dicts of tensors in the JAX layout (dense weights
``(K, N)``, applied as ``x @ w``). Dense projections and the policy
einsum sites route through the emulated GEMM, selected per call-site
family by a :class:`GemmPolicy`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.core.emulated import emulated_dot
from repro_torch.core.precision import NATIVE, EmulationConfig


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """Per-call-site emulated-GEMM selection.

    Families: 'attn' (q/k/v/o projections), 'ffn' (MLP matmuls),
    'logits' (output head), 'attn_qk' / 'attn_av' (score and
    weighted-value contractions). Anything absent falls back to
    ``default``; a ``default`` of None defers to the ambient resolver
    (``repro_torch.api.resolve_config``). The reference's ``mesh`` field
    has no counterpart: the slice runs on one card.
    """
    default: EmulationConfig | None = None
    overrides: tuple[tuple[str, EmulationConfig], ...] = ()

    def for_site(self, site: str) -> EmulationConfig:
        for name, cfg in self.overrides:
            if name == site:
                return cfg
        if self.default is not None:
            return self.default
        from repro_torch import api
        return api.resolve_config()


NATIVE_POLICY = GemmPolicy(default=NATIVE)


def dense(x: torch.Tensor, w: torch.Tensor, policy: GemmPolicy, site: str,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) under the policy's emulation config."""
    cfg = policy.for_site(site)
    if cfg.scheme == "native":
        out = torch.matmul(x, w)
    else:
        out = emulated_dot(x, w, cfg).to(x.dtype)
    return out if bias is None else out + bias


def policy_einsum(eq: str, x: torch.Tensor, y: torch.Tensor,
                  policy: GemmPolicy, site: str, pet=None) -> torch.Tensor:
    """Two-operand einsum under the policy's per-site config.

    Native is ``torch.einsum`` (in ``pet`` when given, as the reference's
    ``preferred_element_type``); emulated calls go through
    ``repro_torch.api.einsum``, whose batched core is one strided-batched
    kernel launch. ``+cached`` is dropped here as in the reference: these
    sites have no weight to prepare.
    """
    cfg = policy.for_site(site)
    if cfg.scheme == "native":
        if pet is not None:
            x, y = x.to(pet), y.to(pet)
        return torch.einsum(eq, x, y)
    if cfg.cache_weights:
        cfg = dataclasses.replace(cfg, cache_weights=False)
    from repro_torch import api
    out = api.einsum(eq, x, y, precision=cfg)
    return out if pet is None else out.to(pet)


# ---------------------------------------------------------------------------
# Initializers: a torch.Generator on the target device, so full-width
# weights are drawn where they live.
# ---------------------------------------------------------------------------

def he_init(gen: torch.Generator, shape, dtype, device,
            fan_in: int | None = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2]
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * (2.0 / max(1, fan)) ** 0.5).to(dtype)


def emb_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms. 'nonparam' is OLMo-style non-parametric LayerNorm (no scale/bias).
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, dtype, device):
    if kind == "rms":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparam":
        return {}
    raise ValueError(f"unknown norm kind {kind!r}")


def apply_norm(kind: str, params: Mapping[str, torch.Tensor],
               x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mean = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), -1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, rot_dim: int | None = None
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S). Rotates the first rot_dim dims."""
    d = x.shape[-1]
    rot = d if rot_dim is None else rot_dim
    freqs = rope_frequencies(rot, theta, x.device)
    angles = positions[..., None].float() * freqs            # (B, S, rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# FFN.
# ---------------------------------------------------------------------------

def init_ffn(gen, d_model: int, d_ff: int, act: str, dtype, device,
             lead: tuple = ()):
    if act in ("swiglu", "geglu"):
        return {
            "wi_gate": he_init(gen, lead + (d_model, d_ff), dtype, device),
            "wi_up": he_init(gen, lead + (d_model, d_ff), dtype, device),
            "wo": he_init(gen, lead + (d_ff, d_model), dtype, device),
        }
    return {"wi": he_init(gen, lead + (d_model, d_ff), dtype, device),
            "wo": he_init(gen, lead + (d_ff, d_model), dtype, device)}


def apply_ffn(params, x: torch.Tensor, act: str, policy: GemmPolicy,
              site: str = "ffn") -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        gate = dense(x, params["wi_gate"], policy, site)
        up = dense(x, params["wi_up"], policy, site)
        gate = (F.silu(gate) if act == "swiglu"
                else F.gelu(gate, approximate="tanh"))
        return dense(gate * up, params["wo"], policy, site)
    h = F.gelu(dense(x, params["wi"], policy, site), approximate="tanh")
    return dense(h, params["wo"], policy, site)


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    """Padded embedding/logit vocab (Megatron-style)."""
    return ((vocab + multiple - 1) // multiple) * multiple


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """Mean token NLL in float32; labels outside [0, vocab) (padding ids)
    are masked out."""
    logits = logits.float()
    mask = (labels >= 0) & (labels < vocab)
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
