"""The training step of the port (``repro.launch.steps``), on one card.

``make_loss_fn`` and ``make_train_step`` mirror the reference's, without
its shardings and ``jit``: PyTorch runs eagerly, and the slice trains on
one card. The step is pure, as the reference's jitted one is: it takes a
state {"params", "opt"} and a batch of numpy arrays and returns a new
state and its metrics, leaving the old state as it was.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import dispatch
from repro_torch.models import model as M
from repro_torch.models.common import GemmPolicy, cross_entropy_loss
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def make_loss_fn(arch: ArchConfig, policy: GemmPolicy):
    mcfg = arch.model

    def loss_fn(params, batch):
        logits, mtp_logits, aux = M.forward_train(
            params, mcfg, batch, policy, remat=arch.train.remat)
        return cross_entropy_loss(logits, batch["labels"], mcfg.vocab) + aux

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``, like
    ``jax.value_and_grad``; ``params`` keeps no gradient state."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def batch_to(batch: dict, device) -> dict:
    """Numpy (or tensor) batch arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(arch: ArchConfig, mesh=None,
                    policy: GemmPolicy | None = None):
    """The step function ``(state, batch) -> (state, metrics)``.

    ``policy`` None takes the arch config's ``gemm_sites``, which defer
    to the ambient resolver when empty. ``mesh`` must be None: the slice
    trains on one card.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-device meshes are not ported yet (ROADMAP.md § 1 item 8)")
    if arch.train.microbatches > 1:
        raise NotImplementedError(
            "gradient accumulation and its once-per-step weight preparation "
            "(StepPrepared, build_step_preps) are not ported yet "
            "(ROADMAP.md § 1 item 2)")
    if policy is None:
        policy = arch.gemm_policy()
    policy = dispatch.resolve_policy(policy)
    loss_fn = make_loss_fn(arch, policy)
    _, opt_update = make_optimizer(arch.train.optimizer)

    def train_step(state, batch):
        params = state["params"]
        device = tree_leaves(params)[0].device
        loss, grads = value_and_grad(loss_fn, params, batch_to(batch, device))
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = warmup_cosine(state["opt"]["step"], arch.train.learning_rate)
        new_params, new_opt = opt_update(grads, state["opt"], params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(arch: ArchConfig, seed: int = 0, device="cuda"):
    """Seeded parameters and their optimizer state."""
    opt_init, _ = make_optimizer(arch.train.optimizer)
    params = M.init_params(arch.model, seed, device)
    return {"params": params, "opt": opt_init(params)}
