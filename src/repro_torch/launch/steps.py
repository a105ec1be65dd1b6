"""The training and serve steps of the port (``repro.launch.steps``).

``make_loss_fn``, ``make_train_step``, ``make_prefill_step``,
``make_decode_step``, the abstract state (``abstract_params``,
``abstract_opt``, ``abstract_cache``, on the meta device) and the specs
(``state_specs``, ``batch_specs``, ``named``) mirror the reference's,
without its ``jit``: PyTorch runs eagerly. The train step is pure, as
the reference's jitted one is: it takes a state {"params", "opt"} and a
batch of numpy arrays and returns a new state and its metrics, leaving
the old state as it was.

With ``TrainPolicy.microbatches`` > 1 the step accumulates gradients over
that many slices of the batch, as the reference's microbatch scan does,
and a policy that caches weights prepares them once per optimizer step,
before the loop (``kernels.prepared.build_step_preps``), instead of once
per microbatch and again in each recompute. A model with multi-token
prediction adds ``MTP_WEIGHT`` times the cross-entropy of its MTP logits
against the labels shifted once more.

On a live mesh (``launch.mesh``; one process a rank) the reference's
GSPMD step becomes explicit SPMD. Training: each data rank reads its own
rows of the batch (``data.make_batch_iterator(host=data rank)``), the
state's dense weights are the rank's tiles (``parallel.sharding.
tile_pspecs``, :func:`init_state`), every dense call partitions over
'model' only (the rows are already local), the gradients and the loss
are averaged over the data axes before clipping, and the clipping norm
sums the tiles' squares over 'model'. Serving: the params passed to the
prefill / decode steps are the rank's tiles (``sharding.tile_params``),
the activations and the cache are whole on every rank, and a dense call
splits its rows over the data axes and its columns or K over 'model'.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.guard import ladder as guard_ladder
from repro_torch.kernels import dispatch, prepared
from repro_torch.models import model as M
from repro_torch.models.common import GemmPolicy, cross_entropy_loss
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

MTP_WEIGHT = 0.3


# ---------------------------------------------------------------------------
# Abstract state: meta tensors of the reference's shapes and dtypes (its
# jax.eval_shape trees), built without drawing or allocating anything, so
# that deepseek-v3-671b's 671 B parameters can be counted on any host.
# ---------------------------------------------------------------------------

def abstract_params(arch: ArchConfig):
    return M.init_params(arch.model, device="meta")


def abstract_opt(arch: ArchConfig, params):
    opt_init, _ = make_optimizer(arch.train.optimizer)
    return opt_init(params)


def abstract_cache(arch: ArchConfig, batch: int, max_seq: int):
    return M.init_cache(arch.model, batch, max_seq, device="meta")


def state_specs(arch: ArchConfig, mesh):
    """The reference's storage specs of the train state on ``mesh``."""
    params = abstract_params(arch)
    p_specs = shd.param_pspecs(params, mesh, fsdp=arch.train.fsdp,
                               attn_sp=arch.model.attn_sharding == "sp")
    opt = abstract_opt(arch, params)
    o_specs = shd.opt_pspecs(opt, p_specs, mesh, zero2=arch.train.zero2)
    return {"params": p_specs, "opt": o_specs}


def _batch_axes(mesh, batch: int):
    """Data axes if the global batch divides them, else replicate
    (long_500k has batch 1)."""
    dp = shd.data_axes(mesh)
    return shd._fit(batch, dp, mesh)


def batch_specs(arch: ArchConfig, shape: ShapeSpec, mesh):
    specs = {}
    for name, leaf in arch.input_specs(shape).items():
        specs[name] = shd.P(_batch_axes(mesh, leaf.shape[0]),
                            *([None] * (leaf.dim() - 1)))
    return specs


def named(specs, mesh):
    return shd.shardings(specs, mesh)


def tile_state_specs(arch: ArchConfig, mesh):
    """Specs of the train state as the ranks hold it on the model path:
    the dense weights' tiles (``sharding.tile_pspecs``) and the optimizer
    moments like them; the step counter and everything else whole."""
    params = abstract_params(arch)
    p_specs = shd.tile_pspecs(params, mesh)
    opt = abstract_opt(arch, params)

    def whole(tree):
        return shd._map(lambda x: shd.P(*([None] * x.dim())), tree)

    return {"params": p_specs,
            "opt": {k: p_specs if k in ("m", "v") else whole(v)
                    for k, v in opt.items()}}


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


def _resolved(arch: ArchConfig, mesh, policy):
    return dispatch.resolve_policy(
        policy if policy is not None else arch.gemm_policy(), mesh)


def _data_ranks(mesh) -> int:
    sizes = mesh_mod.axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1) \
        if mesh_mod.is_live(mesh) else 1


def _mean_over_data(tree, mesh):
    """The float32 mean of every rank's ``tree`` over the data axes."""
    n = _data_ranks(mesh)
    if n == 1:
        return tree
    axes = shd.data_axes(mesh)
    return tree_map(lambda g: comm.sum_raw(g.float(), mesh, axes) / n, tree)


def _clip_on_mesh(grads, tiled, mesh, max_norm: float):
    """``clip_by_global_norm`` of a tree whose ``tiled`` leaves are this
    rank's tiles: their squares are summed over 'model', the whole
    leaves' counted once, so every rank clips by the same global norm."""
    whole = sum(torch.sum(torch.square(g.float()))
                for g, t in zip(tree_leaves(grads), tree_leaves(tiled))
                if not t)
    parts = [torch.sum(torch.square(g.float()))
             for g, t in zip(tree_leaves(grads), tree_leaves(tiled)) if t]
    if parts:
        whole = whole + comm.sum_raw(sum(parts), mesh, "model")
    norm = torch.sqrt(whole)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def make_train_step(arch: ArchConfig, mesh=None,
                    shape: ShapeSpec | None = None,
                    policy: GemmPolicy | None = None, donate: bool = True):
    """The step function ``(state, batch) -> (state, metrics)``, with the
    reference's call form ``(arch, mesh, shape, policy, donate)``.

    ``policy`` None takes the arch config's ``gemm_sites``, which defer
    to the ambient resolver when empty. On a live ``mesh`` the state is
    the rank's (:func:`init_state` with the mesh) and the batch its data
    rank's rows (module doc). ``shape`` and ``donate`` are taken and have
    no effect in eager torch: the reference uses ``shape`` only to shard
    the batch across its mesh (``in_shardings``), and ``donate`` to let
    XLA reuse the state's buffers for the new state; the eager step
    builds a new state of new tensors either way, and the caller's old
    state stays valid until it drops it. ZeRO-2's gradient specs
    (``sharding.grad_pspecs``) shape the dry run's per-device bytes; the
    eager step all-reduces whole gradients.
    """
    del shape, donate
    live = mesh_mod.is_live(mesh) and dispatch._mesh_devices(mesh) > 1
    policy = _resolved(arch, mesh_mod.RowsLocal(mesh) if live else None,
                       policy)
    loss_fn = make_loss_fn(arch, policy)
    _, opt_update = make_optimizer(arch.train.optimizer)
    n_micro = arch.train.microbatches
    cached = prepared.policy_caches_weights(policy)
    # Which gradient leaves are tiles (their norm sums over 'model').
    tiled = None if policy.mesh is None else shd._map(
        lambda s: "model" in tuple(s),
        shd.tile_pspecs(abstract_params(arch), mesh))

    def train_step(state, batch):
        # Every rank's guard verdicts agree, forward and backward
        # (guard.ladder.consensus), so a strict raise aborts the step on
        # every rank and the Trainer retries it on every rank.
        with guard_ladder.consensus(mesh if live else None):
            return _train_step(state, batch)

    def _train_step(state, batch):
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
        if live:
            grads = _mean_over_data(grads, mesh)
            loss = _mean_over_data(loss, mesh)
        if tiled is not None:
            grads, gnorm = _clip_on_mesh(grads, tiled, mesh, 1.0)
        else:
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
    inputs) -> logits (B, S, vocab_padded)``, as the reference's. On a
    live ``mesh`` ``params`` are the rank's tiles (module doc)."""
    policy = _resolved(arch, mesh, policy)
    mcfg = arch.model

    if not mcfg.causal:
        @torch.no_grad()
        def prefill(params, inputs):
            with guard_ladder.consensus(policy.mesh):
                logits, _, _ = M.forward_train(params, mcfg, inputs, policy,
                                               remat=False)
            return logits
        return prefill

    @torch.no_grad()
    def prefill(params, inputs):
        with guard_ladder.consensus(policy.mesh):
            return M.forward_prefill(params, mcfg, inputs, shape.seq_len,
                                     policy)

    return prefill


def make_decode_step(arch: ArchConfig, shape: ShapeSpec, mesh=None,
                     policy: GemmPolicy | None = None, donate: bool = True):
    """``decode(params, cache, tokens, pos) -> (logits (B, 1,
    vocab_padded), cache)``; the cache is updated in place, as the
    reference's donated one is. On a live ``mesh`` ``params`` are the
    rank's tiles and the cache is whole (module doc). ``donate`` is taken
    and has no effect: the eager step writes the cache in place whether
    or not the reference would donate it (with ``donate=False`` the
    reference keeps the old cache valid; here the caller copies it first
    if it needs it)."""
    del donate
    policy = _resolved(arch, mesh, policy)
    mcfg = arch.model

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        with guard_ladder.consensus(policy.mesh):
            return M.forward_decode(params, mcfg, tokens, pos, cache, policy)

    return decode


def init_state(arch: ArchConfig, seed: int = 0, device="cuda", mesh=None):
    """Seeded parameters and their optimizer state; on a live ``mesh`` of
    several model ranks, this rank's tiles of the dense weights
    (``sharding.tile_params``, drawn tile by tile:
    ``models.model.init_rank_params``) and their moments."""
    opt_init, _ = make_optimizer(arch.train.optimizer)
    params = M.init_rank_params(arch.model, seed, device, mesh)
    return {"params": params, "opt": opt_init(params)}
