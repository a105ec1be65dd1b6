"""AdamW and Adafactor over parameter trees (``repro.optim.optimizers``).

States mirror the parameter tree (float32 statistics beside each leaf
and an int32 step count). Updates are pure, as in the reference: they
return new trees and leave their arguments as they are. Adafactor
factors the second moment of every leaf of two or more dimensions into
row and column statistics (a stacked leaf per trailing matrix) and keeps
no first moment.
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


def adafactor_init(params):
    """{"vr", "vc", "step"}: for a leaf of shape (..., R, C) float32 row
    statistics (..., R) and column statistics (..., C); for a 1-D leaf
    ``vr`` of its shape and a (1,) ``vc`` that stays zero."""
    def vr(p):
        shape = p.shape[:-1] if p.dim() >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def adafactor_update(grads, state, params, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0):
    """One Adafactor step: (new params, new state). The second-moment
    decay is beta = 1 - t^-decay at step t; each leaf's update is clipped
    to an RMS of at most ``clip_threshold``."""
    step = state["step"] + 1
    beta = 1.0 - step.float() ** (-decay)

    def upd(g, vr, vc, p):
        g = g.float()
        g2 = g * g + eps
        if p.dim() >= 2:
            vr = beta * vr + (1 - beta) * g2.mean(-1)
            vc = beta * vc + (1 - beta) * g2.mean(-2)
            r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                     + 1e-12)
        else:
            vr = beta * vr + (1 - beta) * g2
            u = g / (torch.sqrt(vr) + 1e-12)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return (p.float() - lr * u).to(p.dtype), vr, vc

    out = [upd(*leaves) for leaves in zip(
        *(tree_leaves(t) for t in (grads, state["vr"], state["vc"], params)))]
    new_params, vr, vc = (tree_unflatten(params, [o[i] for o in out])
                          for i in range(3))
    return new_params, {"vr": vr, "vc": vc, "step": step}


def make_optimizer(kind: str):
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {kind!r}")
