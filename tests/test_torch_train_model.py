"""The port's training forward and backward against the reference, on
the smoke olmo-1b (2 layers, d_model 64, vocab 500, float32), from the
same parameters (repro_torch.convert) and the same batch, and its chunked
flash attention.

The reference's ``make_train_step`` fails on this JAX (ROADMAP.md § 3 R1),
so the oracle is ``jax.value_and_grad(steps.make_loss_fn(...))`` composed
without a mesh and jitted. Emulated specs take ``+xla`` on the JAX side,
the reference expansion, which its own tests hold bit-identical to the
Pallas kernels (tests/test_prepared.py); olmo-1b-emu runs its own site
policy (Scheme II on attn_qk, whose batched backward re-enters Scheme
II), with ``+xla`` added to each site's spec on the JAX side.

Tolerances: the loss within 1e-5 relative and each gradient leaf within
1e-4 relative L2. The emulated GEMMs are bit-identical on equal inputs,
but XLA and torch round float32 softmax, rope, norm, exp and the native
matmuls in other orders, a few ulps each, and the emulation carries those
differences forward through 2 layers (measured: 0 on the loss, up to 2e-6
on a leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_util import t
from repro import api as japi, configs as jconfigs
from repro.data import SyntheticLMDataset as JDataset
from repro.launch import steps as JS
from repro.models import attention as jattn, model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.launch import steps as TS
from repro_torch.models import attention as tattn
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.utils.tree import tree_flatten

BATCH, SEQ = 2, 32


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
    """(reference, port) policies: the reference's with ``+xla`` on each
    emulated site; an arch id stands for its gemm_sites."""
    def xla(s):
        return s if s == "native" else s + "+xla"

    if spec.startswith("olmo"):
        sites = jconfigs.get_smoke_config(spec).gemm_sites
        jpol = JPolicy(
            default=japi.precision(xla(dict(sites)["default"])),
            overrides=tuple((k, japi.precision(xla(s))) for k, s in sites
                            if k != "default"))
        return jpol, tconfigs.get_smoke_config(spec).gemm_policy()
    return (JPolicy(default=japi.precision(xla(spec))),
            TPolicy(default=tapi.precision(spec)))


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4", "ozaki1-p4+cached",
                                  "olmo-1b-emu"])
def test_loss_and_gradients_match_reference(setup, spec):
    jarch, tarch, jparams, tparams, batch = setup
    jpol, tpol = _policies(spec)
    jloss_fn = JS.make_loss_fn(jarch, jpol)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = TS.value_and_grad(TS.make_loss_fn(tarch, tpol), tparams,
                               TS.batch_to(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = tree_flatten(jax.tree.map(np.asarray, jg))
    tflat = tree_flatten(tg)
    assert sorted(tflat) == sorted(jflat)
    for key, g in tflat.items():
        ref = jflat[key].astype(np.float32)
        rel = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert rel <= 1e-4, (key, rel)


# ---------------------------------------------------------------------------
# Chunked flash attention: padding (seq 96 on chunks of 64) and the causal
# skip of kv chunks past the diagonal, native and on emulated sites.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_flash_attention_matches_reference(spec):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, q_chunk=64,
              kv_chunk=64)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 96, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 96, 2, 16)).astype(np.float32)
    pos = np.arange(96, dtype=np.int32)
    sites = (("attn_qk", spec), ("attn_av", spec))
    jpol = JPolicy(overrides=tuple((s, japi.precision(x)) for s, x in sites))
    tpol = TPolicy(overrides=tuple((s, tapi.precision(x)) for s, x in sites))
    ref = np.asarray(jattn.flash_attention(
        jcfg, *(jnp.asarray(x) for x in (q, k, v, pos, pos)), policy=jpol))
    out = tattn.flash_attention(tcfg, *(t(x) for x in (q, k, v, pos, pos)),
                                policy=tpol)
    # float32 exp and softmax sums differ by ulps between XLA and torch.
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
