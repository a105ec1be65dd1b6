"""Shared model primitives of the port (``repro.models.common``).

Parameters are plain dicts of tensors in the JAX layout (dense weights
``(K, N)``, applied as ``x @ w``). Dense projections and the policy
einsum sites route through the emulated GEMM, selected per call-site
family by a :class:`GemmPolicy`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.core.emulated import (emulated_dot, emulated_dot_prepared,
                                       prepared_dot)
from repro_torch.core.precision import NATIVE, EmulationConfig
from repro_torch.kernels.prepared import (PreparedOperand, PreparedResidues,
                                          StepPrepared)


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """Per-call-site emulated-GEMM selection.

    Families: 'attn' (q/k/v/o projections), 'ffn' (MLP matmuls),
    'logits' (output head), 'attn_qk' / 'attn_av' (score and
    weighted-value contractions). Anything absent falls back to
    ``default``; a ``default`` of None defers to the ambient resolver
    (``repro_torch.api.resolve_config``).

    ``mesh`` is the live launch mesh, set by ``dispatch.resolve_policy``
    on a mesh of more than one rank: the model's dense weights are then
    each rank's tiles (``parallel.sharding.tile_pspecs``) and ``dense``
    runs each projection partitioned over the ranks
    (``parallel.shard_gemm.tile_dense``); None on one device.
    """
    default: EmulationConfig | None = None
    overrides: tuple[tuple[str, EmulationConfig], ...] = ()
    mesh: object | None = None

    def for_site(self, site: str) -> EmulationConfig:
        for name, cfg in self.overrides:
            if name == site:
                return cfg
        if self.default is not None:
            return self.default
        from repro_torch import api
        return api.resolve_config()


NATIVE_POLICY = GemmPolicy(default=NATIVE)


def parse_gemm_spec(spec: str) -> EmulationConfig:
    """Deprecated: use ``repro_torch.api.precision`` (the spec grammar).

    The historical grammar: 'native', 'ozaki1-p4', 'ozaki2-p9' and a
    '-cached' suffix (Scheme I only), pinned to ``impl='xla'``.
    """
    warnings.warn(
        "parse_gemm_spec is deprecated; use repro_torch.api.precision("
        "'<spec>') (note the '+cached' spelling)",
        DeprecationWarning, stacklevel=2)
    if spec == "native":
        return NATIVE
    cached = spec.endswith("-cached")
    if cached:
        spec = spec[:-len("-cached")]
    scheme, _, ps = spec.partition("-p")
    if scheme not in ("ozaki1", "ozaki2") or not ps.isdigit():
        raise ValueError(f"bad gemm spec {spec!r}")
    if cached and scheme != "ozaki1":
        raise ValueError("'-cached' is a Scheme-I (ozaki1) feature")
    return EmulationConfig(scheme=scheme, p=int(ps), impl="xla",
                           cache_weights=cached)


def dense(x: torch.Tensor, w, policy: GemmPolicy, site: str,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) under the policy's emulation config.

    ``w`` may be a :class:`~repro_torch.kernels.prepared.StepPrepared`
    pair (float weight + once-per-step prep, attached by
    ``launch/steps.py``), sent through ``emulated_dot_prepared``: the
    forward streams the prep and dB still reaches the weight. It may
    also be a bare ``PreparedOperand`` / ``PreparedResidues``
    (``prepared.prepare_params``, once a serve session), consumed as it
    is whatever the policy says: the scheme was chosen when it was
    prepared, and serving never differentiates.

    With telemetry enabled the call runs inside
    ``telemetry.call_site(site)``, so every emulated GEMM and guard event
    it dispatches carries the site's label.

    When the policy carries a ``mesh``, ``w`` is this rank's tile of the
    weight and the projection runs partitioned over the ranks
    (``parallel.shard_gemm.tile_dense``), whatever the site's config
    (a native site multiplies its tile natively); a whole weight whose
    rows do not split either takes the direct routes below on every
    rank."""
    from repro_torch import telemetry
    if telemetry.enabled():
        with telemetry.call_site(site):
            return _dense(x, w, policy, site, bias)
    return _dense(x, w, policy, site, bias)


def _dense(x: torch.Tensor, w, policy: GemmPolicy, site: str,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    cfg = policy.for_site(site)
    if policy.mesh is not None:
        from repro_torch.parallel import shard_gemm
        out = shard_gemm.tile_dense(x, w, cfg, policy.mesh)
        if out is not None:
            out = out.to(x.dtype)
            return out if bias is None else out + bias
    if isinstance(w, StepPrepared):
        out = emulated_dot_prepared(x, w.w, w.prep, cfg).to(x.dtype)
    elif isinstance(w, (PreparedOperand, PreparedResidues)):
        out = prepared_dot(x, w).to(x.dtype)
    elif cfg.scheme == "native":
        if x.dtype != w.dtype:      # jnp.einsum's type promotion
            t = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(t), w.to(t)
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
    sites have no weight to prepare. With telemetry enabled the call is
    labeled with ``site``, as in :func:`dense`.
    """
    cfg = policy.for_site(site)
    if cfg.scheme == "native":
        if pet is not None:
            x, y = x.to(pet), y.to(pet)
        return torch.einsum(eq, x, y)
    if cfg.cache_weights:
        cfg = dataclasses.replace(cfg, cache_weights=False)
    from repro_torch import api, telemetry
    if telemetry.enabled():
        with telemetry.call_site(site):
            out = api.einsum(eq, x, y, precision=cfg)
    else:
        out = api.einsum(eq, x, y, precision=cfg)
    return out if pet is None else out.to(pet)


# ---------------------------------------------------------------------------
# Initializers: a torch.Generator on the target device, so full-width
# weights are drawn where they live (None on the meta device, where
# nothing is drawn).
# ---------------------------------------------------------------------------

class _Draws:
    """The per-rank cuts of :func:`he_init`'s draws (:func:`cut_draws`):
    ``cuts`` yields, for each call in draw order, the (dim, start, length)
    of the block of each drawn 2-D matrix that is kept (dim 0 or 1 of the
    matrix), or None to keep it whole; ``seen`` collects the meta leaves
    of a meta pass, in draw order."""
    cuts = None
    seen = None


@contextlib.contextmanager
def cut_draws(cuts=None, seen=None):
    """Within it, :func:`he_init` keeps only the blocks ``cuts`` names
    (``models.model.init_rank_params``), or records its meta leaves in
    ``seen``."""
    prev = _Draws.cuts, _Draws.seen
    _Draws.cuts, _Draws.seen = cuts, seen
    try:
        yield
    finally:
        _Draws.cuts, _Draws.seen = prev


def he_init(gen: torch.Generator, shape, dtype, device,
            fan_in: int | None = None) -> torch.Tensor:
    """He-normal weights in ``dtype``, drawn in float32. A stack (leading
    layer and expert axes) is drawn one 2-D matrix at a time into the
    finished tensor, so that no full-width stack (deepseek-v3's experts:
    L x 256 x 7168 x 2048) has a float32 copy of a layer's size; the
    layout, the dtype and the scale are the reference's (ROADMAP.md
    § 3). Under :func:`cut_draws` each matrix is drawn whole, so that the
    generator's stream is the same, and only its cut is kept."""
    if torch.device(device).type == "meta":
        out = torch.empty(shape, dtype=dtype, device=device)
        if _Draws.seen is not None:
            _Draws.seen.append(out)
        return out
    cut = next(_Draws.cuts) if _Draws.cuts is not None else None
    fan = fan_in if fan_in is not None else shape[-2]
    std = (2.0 / max(1, fan)) ** 0.5

    def draw(part_shape):
        x = torch.randn(part_shape, generator=gen, device=device,
                        dtype=torch.float32)
        x = (x * std).to(dtype)
        return x if cut is None else x.narrow(*cut)

    if len(shape) <= 2:
        return draw(shape).contiguous()
    kept = list(shape)
    if cut is not None:
        kept[len(shape) - 2 + cut[0]] = cut[2]
    out = torch.empty(kept, dtype=dtype, device=device)
    for part in out.view(-1, *kept[-2:]):
        part.copy_(draw(shape[-2:]))
    return out


def emb_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms. 'nonparam' is OLMo-style non-parametric LayerNorm (no scale/bias).
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, dtype, device, lead: tuple = ()):
    """A norm's parameters; ``lead`` stacks them on leading (layer) axes,
    as the reference's vmapped layer init does."""
    if kind == "rms":
        return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
                "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}
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

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
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


def _pin(x, spec_parts):
    """The reference's ``with_sharding_constraint`` on an activation: a
    no-op here, where every rank holds the whole activations (ROADMAP.md
    § 3)."""
    del spec_parts
    return x


def apply_ffn(params, x: torch.Tensor, act: str, policy: GemmPolicy,
              site: str = "ffn", sp: bool = False) -> torch.Tensor:
    """The FFN. ``sp`` is the reference's Megatron-SP flag, which pins the
    hidden activation to the model axis; it is taken and changes nothing
    here (:func:`_pin`)."""
    del sp
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
