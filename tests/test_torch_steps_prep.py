"""The once-per-step weight preparation under gradient accumulation
(repro_torch.kernels.prepared.{build_step_preps, attach_step_preps},
launch/steps.py with ``TrainPolicy.microbatches`` > 1) against the
reference, on the smoke olmo-1b (2 layers, d_model 64, vocab 500,
float32) from the same parameters (repro_torch.convert).

The preps of both schemes must be bit-identical to the reference's
(Scheme I compared through ``stacked()``, as the two packages interleave
at their own granularity; Scheme II as stored). The reference's
``make_train_step`` fails on this JAX (ROADMAP.md § 3 R1), but its
``make_loss_fn`` needs no mesh: the oracle is
``jax.value_and_grad(loss_fn)(params, batch, preps)``, jitted, with
``+xla`` on the JAX side (its own tests hold that expansion bit-identical
to its Pallas kernels).

Tolerances, as in tests/test_torch_train_model.py: the loss within 1e-5
relative, each gradient leaf (or AdamW moment) within 1e-4 relative L2.
The emulated GEMMs are bit-identical on equal inputs; XLA and torch round
float32 softmax, rope, norms and exp in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi, configs as jconfigs
from repro.data import SyntheticLMDataset as JDataset
from repro.kernels import prepared as jprepared
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.optim import optimizers as jopt
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.launch import steps as TS
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.optim import optimizers as topt
from repro_torch.kernels import prepared as tprepared
from repro_torch.utils.tree import tree_flatten
from _torch_util import one_torch_thread  # noqa: F401

# torch on one thread: the parallel suite's workers share a few cores.
pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH, SEQ = 4, 32
SPECS = ["ozaki1-p4+cached", "ozaki2-m6+cached"]


@pytest.fixture(scope="module")
def setup():
    jarch = jconfigs.get_smoke_config("olmo-1b")
    tarch = tconfigs.get_smoke_config("olmo-1b")
    jparams = JM.init_params(jax.random.PRNGKey(0), jarch.model)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tarch.model, device="cpu")
    batch = JDataset(jarch.model.vocab, SEQ, 0).batch(0, BATCH)
    return jarch, tarch, jparams, tparams, batch


def _policies(spec):
    return (JPolicy(default=japi.precision(spec + "+xla")),
            TPolicy(default=tapi.precision(spec)))


def _rel(x: torch.Tensor, ref: np.ndarray) -> float:
    ref = ref.astype(np.float32)
    return float(np.linalg.norm(x.float().numpy() - ref)
                 / max(np.linalg.norm(ref), 1e-30))


def _same_prep(tp, jp, layer):
    """One layer of a port prep against the reference's stacked prep."""
    if isinstance(tp, tprepared.PreparedResidues):
        assert (tp.moduli, tp.budget_bits, tp.k, tp.n) == (
            tuple(jp.moduli), jp.budget_bits, jp.k, jp.n)
        np.testing.assert_array_equal(tp.residues.numpy(),
                                      np.asarray(jp.residues[layer]))
        np.testing.assert_array_equal(tp.scale.numpy(),
                                      np.asarray(jp.scale[layer]))
    else:
        assert (tp.p, tp.beta, tp.k, tp.n) == (jp.p, jp.beta, jp.k, jp.n)
        k, n = tp.k, tp.n
        np.testing.assert_array_equal(
            tp.stacked()[:, :k, :n].numpy(),
            np.asarray(jp.slices[layer])[:, :k, :n])
        np.testing.assert_array_equal(tp.scale.numpy(),
                                      np.asarray(jp.scale[layer])[:, :n])


@pytest.mark.parametrize("spec", SPECS)
def test_build_step_preps_matches_reference(setup, spec):
    jarch, tarch, jparams, tparams, _ = setup
    jpol, tpol = _policies(spec)
    jpreps = jprepared.build_step_preps(jparams, jpol)
    tpreps = tprepared.build_step_preps(tparams, tpol)
    assert sorted(tpreps) == sorted(jpreps) and len(tpreps) == 7
    # Every key is a layer stack: the port keeps a list of per-layer
    # preps, the reference one prep stacked on a leading layer axis.
    for key, tp in tpreps.items():
        assert len(tp) == tarch.model.n_layers, key
        for layer, per in enumerate(tp):
            _same_prep(per, jpreps[key], layer)
            _same_prep(per.twin, jpreps[key].twin, layer)
    # attach_step_preps pairs exactly those leaves with their weights.
    attached = tree_flatten(tprepared.attach_step_preps(tparams, tpreps))
    paired = {k for k, v in attached.items()
              if isinstance(v, tprepared.StepPrepared)}
    assert paired == set(tpreps)
    assert all(attached[k].w is tree_flatten(tparams)[k] for k in paired)


@pytest.mark.parametrize("spec", SPECS)
def test_loss_fn_with_preps_matches_reference(setup, spec):
    """make_loss_fn(params, batch, preps): loss and gradients of the float
    leaves against the reference's value_and_grad with the same preps,
    and bit-identical to the port's per-call cache."""
    jarch, tarch, jparams, tparams, batch = setup
    jpol, tpol = _policies(spec)
    jpreps = jprepared.build_step_preps(jparams, jpol)
    jl, jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jarch, jpol)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jpreps)
    loss_fn = TS.make_loss_fn(tarch, tpol)
    tbatch = TS.batch_to(batch, "cpu")
    tl, tg = TS.value_and_grad(loss_fn, tparams, tbatch,
                               tprepared.build_step_preps(tparams, tpol))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = tree_flatten(jax.tree.map(np.asarray, jg))
    tflat = tree_flatten(tg)
    assert sorted(tflat) == sorted(jflat)
    for key, g in tflat.items():
        assert _rel(g, jflat[key]) <= 1e-4, key
    # The hoist changes no bit against the per-call cache.
    cl, cg = TS.value_and_grad(loss_fn, tparams, tbatch)
    assert torch.equal(tl, cl)
    for key, g in tree_flatten(cg).items():
        assert torch.equal(g, tflat[key]), key


@pytest.mark.parametrize("spec", SPECS)
def test_microbatch_step_matches_reference_halves(setup, spec):
    """A microbatches=2 step of the port against the reference's per-half
    gradients (with its hoisted preps), their float32 mean, its clip and
    AdamW. At step 0 the warmup learning rate is 0, so the moments carry
    the gradients' comparison."""
    jarch, tarch, jparams, tparams, batch = setup
    jpol, tpol = _policies(spec)
    micro = dataclasses.replace(
        tarch, train=dataclasses.replace(tarch.train, microbatches=2))
    state = {"params": tparams, "opt": topt.adamw_init(tparams)}
    new_state, metrics = TS.make_train_step(micro, policy=tpol)(state, batch)

    jloss_fn = jax.jit(jax.value_and_grad(JS.make_loss_fn(jarch, jpol)))
    jpreps = jprepared.build_step_preps(jparams, jpol)
    halves = [{k: jnp.asarray(v[i * BATCH // 2:(i + 1) * BATCH // 2])
               for k, v in batch.items()} for i in range(2)]
    g_acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    l_acc = 0.0
    for half in halves:
        l, g = jloss_fn(jparams, half, jpreps)
        g_acc = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), g_acc, g)
        l_acc = l_acc + l
    jgrads = jax.tree.map(lambda g: g / 2, g_acc)
    jgrads, jnorm = jopt.clip_by_global_norm(jgrads, 1.0)
    lr = jopt.warmup_cosine(jnp.asarray(0), jarch.train.learning_rate)
    _, jstate = jopt.adamw_update(jgrads, jopt.adamw_init(jparams), jparams,
                                  lr)
    assert abs(float(metrics["loss"]) - float(l_acc / 2)) <= \
        1e-5 * abs(float(l_acc / 2))
    assert abs(float(metrics["grad_norm"]) - float(jnorm)) <= \
        1e-4 * float(jnorm)
    for name in ("m", "v"):
        jflat = tree_flatten(jax.tree.map(np.asarray, jstate[name]))
        for key, x in tree_flatten(new_state["opt"][name]).items():
            assert _rel(x, jflat[key]) <= 1e-4, (name, key)


@pytest.mark.parametrize("spec", SPECS)
def test_microbatch_step_is_the_mean_of_the_halves(setup, spec):
    """The hoisted step's loss and float32 gradients equal, bit for bit,
    the mean of two microbatches=1 evaluations on the halves (each
    preparing its weights per call), and uncached ones."""
    _, tarch, _, tparams, batch = setup
    _, tpol = _policies(spec)
    tbatch = TS.batch_to(batch, "cpu")
    halves = TS.split_batch(tbatch, 2)
    loss_fn = TS.make_loss_fn(tarch, tpol)
    hoisted = TS.accumulate_grads(loss_fn, tparams, halves,
                                  tprepared.build_step_preps(tparams, tpol))
    per_call = TS.accumulate_grads(loss_fn, tparams, halves)
    uncached = TS.accumulate_grads(TS.make_loss_fn(tarch, TPolicy(
        default=tapi.precision(spec.replace("+cached", "")))), tparams,
        halves)
    for other in (per_call, uncached):
        assert torch.equal(hoisted[0], other[0])
        for key, g in tree_flatten(hoisted[1]).items():
            assert g.dtype == torch.float32
            assert torch.equal(g, tree_flatten(other[1])[key]), key


@pytest.fixture
def prep_counter(monkeypatch):
    """Count the port's prepare_rhs calls."""
    counter = {"n": 0}
    real = tprepared.prepare_rhs

    def counting(*args, **kw):
        counter["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(tprepared, "prepare_rhs", counting)
    return counter


def _tiny_arch(n_micro: int, tie: bool):
    arch = tconfigs.get_smoke_config("olmo-1b")
    return dataclasses.replace(
        arch, model=dataclasses.replace(arch.model, tie_embeddings=tie),
        train=dataclasses.replace(arch.train, microbatches=n_micro))


def _one_step(arch, policy):
    state = TS.init_state(arch, 0, "cpu")
    batch = JDataset(arch.model.vocab, 16, 0).batch(0, 8)
    _, metrics = TS.make_train_step(arch, policy=policy)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    return state["params"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("tie", [False, True])
def test_prepared_once_per_step_under_grad_accum(prep_counter, spec, tie):
    """Mirrors the reference's tests/test_steps_prep.py: with 4
    microbatches every cacheable weight is prepared once per optimizer
    step, not once per microbatch (and again in each recompute). A tied
    head (emb.T) is no step prep, as in the reference: it keeps the
    per-call cache, once per microbatch forward."""
    n_micro = 4
    arch = _tiny_arch(n_micro, tie)
    policy = TPolicy(default=tapi.precision(spec))
    params = _one_step(arch, policy)
    layers = arch.model.n_layers
    per_step = 7 * layers + (0 if tie else 1)
    preps = tprepared.build_step_preps(params, policy)
    assert sum(layers if k.startswith("layers/") else 1
               for k in preps) == per_step
    assert prep_counter["n"] == per_step + (n_micro if tie else 0) + per_step
    # (the last term: build_step_preps above, called once more here)


def test_native_policy_builds_no_preps(prep_counter):
    _one_step(_tiny_arch(4, False), TPolicy(default=tapi.precision("native")))
    assert prep_counter["n"] == 0
    assert not tprepared.policy_caches_weights(TPolicy(default=tapi.precision(
        "ozaki1-p4")))
    assert tprepared.policy_caches_weights(TPolicy(
        default=tapi.precision("native"),
        overrides=(("ffn", tapi.precision("ozaki2-m6+cached")),)))
