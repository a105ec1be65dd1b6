"""The port's Multi-head Latent Attention (models/mla.py) and sigmoid MoE
routing (models/moe.py) against the reference, from the same parameters
and inputs (numpy, seeded), at deepseek-v3-671b's smoke widths (d_model
64, 4 heads, q_lora 32, kv_lora 16, nope 16, rope 8, v 16).

Tolerances, float32. MLA's outputs and latent caches agree within 1e-5 *
max|out| under 'native' and 'ozaki1-p4' (the emulated 'attn' and
'mla_latent' GEMMs are the same bits in both packages on equal operands;
XLA and torch round the norms, rope, exps and the plain einsums in other
orders). Sigmoid routing: the selected expert indices exactly (an ulp at
a near-tie would move a whole expert; these draws have none that close),
the weights and scores within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import one_torch_thread, t  # noqa: F401
from repro import api as japi
from repro.configs.base import MLAConfig as JMLA, MoEConfig as JMoE
from repro.kernels import dispatch as jdispatch
from repro.models import mla as JL, moe as jmoe
from repro.models.common import GemmPolicy as JPolicy
from repro_torch import api as tapi, convert
from repro_torch.configs.base import MLAConfig, MoEConfig
from repro_torch.models import mla as TL, moe as tmoe
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.utils.tree import tree_flatten

pytestmark = pytest.mark.usefixtures("one_torch_thread")
D, H = 64, 4
MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
           v_dim=16)
B, S, CHUNK, MAX_SEQ = 2, 24, 8, 32
TOL = 1e-5


def _pols(spec):
    return (jdispatch.resolve_policy(JPolicy(default=japi.precision(spec))),
            TPolicy(default=tapi.precision(spec)))


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), err


@pytest.fixture(scope="module")
def mla_params():
    jp = jax.jit(JL.init_mla, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(5), D, H, JMLA(**MLA))
    return jp, convert._to_torch(jax.tree.map(np.asarray, jp), "cpu")


def test_init_mla_layout_and_scales(mla_params):
    """The port's own draw: the reference's leaves, shapes and dtypes,
    stacked on ``lead``, each weight's scale within 10 % of He's."""
    jp, _ = mla_params
    ours = TL.init_mla(torch.Generator().manual_seed(0), D, H,
                       MLAConfig(**MLA), torch.float32, "cpu", lead=(3,))
    ref = tree_flatten(jax.tree.map(np.asarray, jp))
    got = tree_flatten(ours)
    assert got.keys() == ref.keys()
    for key, v in ref.items():
        assert tuple(got[key].shape) == (3,) + v.shape, key
        assert got[key].dtype == torch.float32, key
    for name, fan in (("wq_a", D), ("wq_b", 32), ("wkv_a", D),
                      ("wkv_b", 16), ("wo", H * MLA["v_dim"])):
        assert abs(float(ours[name].std()) / (2 / fan) ** 0.5 - 1) < 0.1
    cache = TL.init_mla_cache(MLAConfig(**MLA), 2, 5, torch.bfloat16, "cpu")
    jc = JL.init_mla_cache(JMLA(**MLA), 2, 5, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jc.items()}


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_mla_train_prefill_step_decode_match_reference(mla_params, spec):
    """mla_train, mla_prefill (its latent cache too), one ragged mla_step
    on a cache with history, and two mla_decode steps after the prefill,
    three query chunks of 8 and a causal online softmax over them."""
    jp, tp = mla_params
    jcfg, tcfg = JMLA(**MLA), MLAConfig(**MLA)
    jpol, tpol = _pols(spec)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S + 2, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    xs = rng.standard_normal((B, 5, D)).astype(np.float32)
    start, n_new = np.array([3, 20], np.int32), np.array([5, 2], np.int32)
    hist = {k: (0.5 * rng.standard_normal((B, MAX_SEQ, w))).astype(np.float32)
            for k, w in (("c_kv", 16), ("k_pe", 8))}

    def ref(p, x, pos, xs, start, n_new, hist):    # one compile
        train = JL.mla_train(p, jcfg, H, x[:, :S], pos, jpol, CHUNK)
        pre, cache = JL.mla_prefill(p, jcfg, H, x[:, :S], pos, jpol,
                                    MAX_SEQ, CHUNK)
        dec = []
        for i in range(2):
            y, cache = JL.mla_decode(p, jcfg, H, x[:, S + i:S + i + 1],
                                     S + i, cache, jpol)
            dec.append(y)
        step = JL.mla_step(p, jcfg, H, xs, start, n_new, hist, jpol)
        return train, pre, dec, cache, step

    want = jax.jit(ref)(jp, jnp.asarray(x), jnp.asarray(pos),
                        jnp.asarray(xs), jnp.asarray(start),
                        jnp.asarray(n_new),
                        {k: jnp.asarray(v) for k, v in hist.items()})
    jtrain, jpre, jdec, jcache, (jstep, jscache) = want
    tpos = t(pos)
    _close(TL.mla_train(tp, tcfg, H, t(x[:, :S]), tpos, tpol, CHUNK), jtrain)
    cache = TL.init_mla_cache(tcfg, B, MAX_SEQ, torch.float32, "cpu")
    out, cache = TL.mla_prefill(tp, tcfg, H, t(x[:, :S]), tpos, tpol, cache,
                                CHUNK)
    _close(out, jpre)
    for i in range(2):
        out, cache = TL.mla_decode(tp, tcfg, H, t(x[:, S + i:S + i + 1]),
                                   S + i, cache, tpol)
        _close(out, jdec[i])
    for k in ("c_kv", "k_pe"):
        _close(cache[k], jcache[k])
    view = {k: t(v) for k, v in hist.items()}
    out, view = TL.mla_step(tp, tcfg, H, t(xs), t(start), t(n_new), view,
                            tpol)
    _close(out, jstep)
    for k in ("c_kv", "k_pe"):
        _close(view[k], jscache[k])


def test_mla_refusals_and_clamped_writes(mla_params):
    """A sequence that is not a whole number of chunks and a prompt past
    the cache raise; a step's chunk past the view's end is written at the
    last rows, as lax.dynamic_update_slice clamps; the prefill then the
    decodes equal the whole forward within float32 rounding."""
    _, tp = mla_params
    tcfg = MLAConfig(**MLA)
    pol = TPolicy(default=tapi.precision("native"))
    x = torch.randn(1, 12, D, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(12, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TL.mla_train(tp, tcfg, H, x, pos, pol, 8)
    with pytest.raises(ValueError, match="does not fit"):
        TL.mla_prefill(tp, tcfg, H, x, pos, pol,
                       TL.init_mla_cache(tcfg, 1, 8, device="cpu"), 4)
    view = TL.init_mla_cache(tcfg, 1, 8, device="cpu")
    _, view = TL.mla_step(tp, tcfg, H, x[:, :3], torch.tensor([7]),
                          torch.tensor([3]), view, pol)
    assert (view["c_kv"][0, :5] == 0).all() and (view["c_kv"][0, 5:] != 0
                                                  ).all()
    full = TL.mla_train(tp, tcfg, H, x, pos, pol, 4)
    cache = TL.init_mla_cache(tcfg, 1, 12, device="cpu")
    out, cache = TL.mla_prefill(tp, tcfg, H, x[:, :8], pos[:, :8], pol,
                                cache, 4)
    outs = [out]
    for i in range(8, 12):
        y, cache = TL.mla_decode(tp, tcfg, H, x[:, i:i + 1], i, cache, pol)
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy())


# ---------------------------------------------------------------------------
# Sigmoid routing with router_bias.
# ---------------------------------------------------------------------------

MOE = dict(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1, d_ff_shared=64,
           scoring="sigmoid", norm_topk=True, pad_multiple=0, n_groups=4)


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_sigmoid_route_with_router_bias_matches_reference(spec):
    """A nonzero bias that moves the selection: the indices equal the
    reference's, and differ from the unbiased pick; the weights are the
    unbiased scores of the picked experts, normalized."""
    jcfg, tcfg = JMoE(**MOE), MoEConfig(**MOE)
    jpol, tpol = _pols(spec)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, D)).astype(np.float32)
    router = (rng.standard_normal((D, 8)) * (2 / D) ** 0.5).astype(np.float32)
    bias = (0.3 * rng.standard_normal(8)).astype(np.float32)
    jw, jidx, jscores = jax.jit(jmoe._route, static_argnums=(1, 3))(
        {"router": jnp.asarray(router), "router_bias": jnp.asarray(bias)},
        jcfg, jnp.asarray(x), jpol)
    tw, tidx, tscores = tmoe._route({"router": t(router),
                                     "router_bias": t(bias)}, tcfg, t(x),
                                    tpol)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=0,
                               atol=1e-6)
    _, plain_idx, _ = tmoe._route({"router": t(router),
                                   "router_bias": torch.zeros(8)}, tcfg,
                                  t(x), tpol)
    assert not torch.equal(plain_idx, tidx)
    picked = torch.gather(tscores, -1, tidx)
    torch.testing.assert_close(tw, picked / picked.sum(-1, keepdim=True),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        float(tmoe.aux_load_balance_loss(tcfg, tscores, tidx)),
        float(jmoe.aux_load_balance_loss(jcfg, jscores, jidx)), rtol=1e-6)


def test_sigmoid_moe_init_and_apply_match_reference():
    """init_moe's float32 router_bias (zeros) in a bf16 layer, and
    apply_moe (sigmoid routing, an ungated shared expert) on the
    reference's parameters with a nonzero bias, within 1e-5 * max|out|."""
    jcfg, tcfg = JMoE(**MOE), MoEConfig(**MOE)
    ours = tmoe.init_moe(torch.Generator().manual_seed(0), D, tcfg, "swiglu",
                         torch.bfloat16, "cpu", lead=(2,))
    assert ours["router_bias"].dtype == torch.float32
    assert ours["router_bias"].shape == (2, 8) and not ours[
        "router_bias"].any()
    assert "shared_gate" not in ours
    jp = jax.jit(jmoe.init_moe, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(2), D, jcfg, "swiglu")
    jp = dict(jp, router_bias=jnp.linspace(-0.2, 0.2, 8, dtype=jnp.float32))
    x = np.random.default_rng(4).standard_normal((2, 6, D)).astype(np.float32)
    jpol, tpol = _pols("native")
    jout, jaux = jax.jit(jmoe.apply_moe, static_argnums=(2, 3, 4))(
        jp, jnp.asarray(x), jcfg, "swiglu", jpol)
    tout, taux = tmoe.apply_moe(
        convert._to_torch(jax.tree.map(np.asarray, jp), "cpu"), t(x), tcfg,
        "swiglu", tpol)
    _close(tout, jout)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
