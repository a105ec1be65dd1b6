"""AdamW over parameter trees (``repro.optim.optimizers``).

States mirror the parameter tree (float32 moments beside each leaf and
an int32 step count). Updates are pure, as in the reference: they return
new trees and leave their arguments as they are. Adafactor is not ported
yet (ROADMAP.md § 1 item 2).
"""

from __future__ import annotations

import math

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in float32;
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def warmup_cosine(step, peak_lr: float, warmup: int = 100,
                  total: int = 10000, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``floor * peak_lr``, as a float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(1, warmup)
    frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi
                                                                 * frac)))
    return torch.where(step < warmup, warm, cos)


def adamw_init(params):
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def adamw_update(grads, state, params, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step: (new params, new state). Weight decay is decoupled
    and applies to matrices (ndim >= 2) only."""
    step = state["step"] + 1
    t = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.dim() >= 2:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v

    out = [upd(*leaves) for leaves in zip(
        *(tree_leaves(t) for t in (grads, state["m"], state["v"], params)))]
    new_params, m, v = (tree_unflatten(params, [o[i] for o in out])
                        for i in range(3))
    return new_params, {"m": m, "v": v, "step": step}


def make_optimizer(kind: str):
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "adafactor":
        raise NotImplementedError(
            "adafactor is not ported yet (ROADMAP.md § 1 item 2)")
    raise ValueError(f"unknown optimizer {kind!r}")
