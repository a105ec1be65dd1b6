"""The training and serve steps of the port (``repro.launch.steps``), on
one card.

``make_loss_fn``, ``make_train_step``, ``make_prefill_step``,
``make_decode_step`` and the abstract state (``abstract_params``,
``abstract_opt``, ``abstract_cache``, on the meta device) mirror the
reference's, without its shardings and
``jit``: PyTorch runs eagerly, and the slice runs on one card. The train
step is pure, as the reference's jitted one is: it takes a state
{"params", "opt"} and a batch of numpy arrays and returns a new state
and its metrics, leaving the old state as it was.

With ``TrainPolicy.microbatches`` > 1 the step accumulates gradients over
that many slices of the batch, as the reference's microbatch scan does,
and a policy that caches weights prepares them once per optimizer step,
before the loop (``kernels.prepared.build_step_preps``), instead of once
per microbatch and again in each recompute. A model with multi-token
prediction adds ``MTP_WEIGHT`` times the cross-entropy of its MTP logits
against the labels shifted once more.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import dispatch, prepared
from repro_torch.models import model as M
from repro_torch.models.common import GemmPolicy, cross_entropy_loss
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

MTP_WEIGHT = 0.3


# ---------------------------------------------------------------------------
# Abstract state: meta tensors of the reference's shapes and dtypes (its
# jax.eval_shape trees), built without drawing or allocating anything, so
# that deepseek-v3-671b's 671 B parameters can be counted on any host. The
# reference's state_specs / batch_specs / named are mesh-shaped and wait
# for the port's meshes (ROADMAP.md § 1 item 8).
# ---------------------------------------------------------------------------

def abstract_params(arch: ArchConfig):
    return M.init_params(arch.model, device="meta")


def abstract_opt(arch: ArchConfig, params):
    opt_init, _ = make_optimizer(arch.train.optimizer)
    return opt_init(params)


def abstract_cache(arch: ArchConfig, batch: int, max_seq: int):
    return M.init_cache(arch.model, batch, max_seq, device="meta")


def make_loss_fn(arch: ArchConfig, policy: GemmPolicy):
    mcfg = arch.model

    def loss_fn(params, batch, preps=None):
        if preps:
            # Once-per-step prepared weights (built before the microbatch
            # loop, see make_train_step) replace their float leaves with
            # StepPrepared pairs, which dense() consumes.
            params = prepared.attach_step_preps(params, preps)
        logits, mtp_logits, aux = M.forward_train(
            params, mcfg, batch, policy, remat=arch.train.remat)
        loss = cross_entropy_loss(logits, batch["labels"], mcfg.vocab)
        if mtp_logits is not None:
            # MTP predicts token t+2: shift next-token labels once more.
            labels = batch["labels"]
            mtp_labels = torch.cat([labels[:, 1:],
                                    -torch.ones_like(labels[:, :1])], dim=1)
            loss = loss + MTP_WEIGHT * cross_entropy_loss(
                mtp_logits, mtp_labels, mcfg.vocab)
        return loss + aux

    return loss_fn


def value_and_grad(loss_fn, params, batch, *args):
    """(loss, gradient tree) of ``loss_fn(params, batch, *args)``, like
    ``jax.value_and_grad``: only the leaves of ``params`` are
    differentiated, and ``params`` keeps no gradient state. A leaf the
    loss does not use (the token embedding behind the audio stub) gets
    zeros, as in JAX."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def split_batch(batch: dict, n_micro: int) -> list[dict]:
    """``n_micro`` microbatches of consecutive rows along the first axis
    (the reference's reshape to (n_micro, B // n_micro, ...))."""
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % n_micro:
        raise ValueError(f"a batch of {sorted(rows)} rows does not split "
                         f"into {n_micro} microbatches")
    parts = {k: torch.chunk(v, n_micro) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def accumulate_grads(loss_fn, params, batches, preps=None):
    """(mean loss, mean gradients) over ``batches``: the float32
    gradients summed in microbatch order from zeros, then divided, and
    the losses likewise, as the reference's scan accumulates them."""
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    l_acc = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(params)[0].device)
    for mb in batches:
        loss, grads = value_and_grad(loss_fn, params, mb, preps)
        g_acc = tree_map(lambda a, g: a + g.float(), g_acc, grads)
        l_acc = l_acc + loss
        del grads
    n = len(batches)
    return l_acc / n, tree_map(lambda g: g / n, g_acc)


def batch_to(batch: dict, device) -> dict:
    """Numpy (or tensor) batch arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _one_card_policy(arch: ArchConfig, mesh, policy):
    """The resolved policy of a step; ``mesh`` must be None."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device meshes are not ported yet (ROADMAP.md § 1 item 8)")
    return dispatch.resolve_policy(
        policy if policy is not None else arch.gemm_policy())


def make_train_step(arch: ArchConfig, mesh=None,
                    shape: ShapeSpec | None = None,
                    policy: GemmPolicy | None = None, donate: bool = True):
    """The step function ``(state, batch) -> (state, metrics)``, with the
    reference's call form ``(arch, mesh, shape, policy, donate)``.

    ``policy`` None takes the arch config's ``gemm_sites``, which defer
    to the ambient resolver when empty. ``mesh`` must be None: the slice
    trains on one card. ``shape`` and ``donate`` are taken and have no
    effect in eager torch: the reference uses ``shape`` only to shard the
    batch across its mesh (``in_shardings``), and ``donate`` to let XLA
    reuse the state's buffers for the new state; the eager step builds a
    new state of new tensors either way, and the caller's old state stays
    valid until it drops it.
    """
    del shape, donate
    policy = _one_card_policy(arch, mesh, policy)
    loss_fn = make_loss_fn(arch, policy)
    _, opt_update = make_optimizer(arch.train.optimizer)
    n_micro = arch.train.microbatches
    cached = prepared.policy_caches_weights(policy)

    def train_step(state, batch):
        params = state["params"]
        batch = batch_to(batch, tree_leaves(params)[0].device)
        if n_micro > 1:
            # Prepare each cacheable weight HERE, once per optimizer step;
            # every microbatch and every recompute streams the result.
            preps = prepared.build_step_preps(params, policy) if cached \
                else None
            loss, grads = accumulate_grads(
                loss_fn, params, split_batch(batch, n_micro), preps)
            del preps
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = warmup_cosine(state["opt"]["step"], arch.train.learning_rate)
        new_params, new_opt = opt_update(grads, state["opt"], params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(arch: ArchConfig, shape: ShapeSpec, mesh=None,
                      policy: GemmPolicy | None = None):
    """``prefill(params, inputs) -> (logits (B, 1, vocab_padded), cache)``
    with a contiguous cache of ``shape.seq_len`` positions; for an
    encoder (``causal=False``) a plain forward, ``prefill(params,
    inputs) -> logits (B, S, vocab_padded)``, as the reference's.
    ``mesh`` must be None."""
    policy = _one_card_policy(arch, mesh, policy)
    mcfg = arch.model

    if not mcfg.causal:
        @torch.no_grad()
        def prefill(params, inputs):
            logits, _, _ = M.forward_train(params, mcfg, inputs, policy,
                                           remat=False)
            return logits
        return prefill

    @torch.no_grad()
    def prefill(params, inputs):
        return M.forward_prefill(params, mcfg, inputs, shape.seq_len, policy)

    return prefill


def make_decode_step(arch: ArchConfig, shape: ShapeSpec, mesh=None,
                     policy: GemmPolicy | None = None, donate: bool = True):
    """``decode(params, cache, tokens, pos) -> (logits (B, 1,
    vocab_padded), cache)``; the cache is updated in place, as the
    reference's donated one is. ``mesh`` must be None. ``donate`` is
    taken and has no effect: the eager step writes the cache in place
    whether or not the reference would donate it (with ``donate=False``
    the reference keeps the old cache valid; here the caller copies it
    first if it needs it)."""
    del donate
    policy = _one_card_policy(arch, mesh, policy)
    mcfg = arch.model

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        return M.forward_decode(params, mcfg, tokens, pos, cache, policy)

    return decode


def init_state(arch: ArchConfig, seed: int = 0, device="cuda"):
    """Seeded parameters and their optimizer state."""
    opt_init, _ = make_optimizer(arch.train.optimizer)
    params = M.init_params(arch.model, seed, device)
    return {"params": params, "opt": opt_init(params)}
