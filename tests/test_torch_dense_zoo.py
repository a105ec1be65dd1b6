"""granite-3-8b and deepseek-coder-33b, the port's dense GQA decoders,
against the reference on their smoke configs from the same parameters
(repro_torch.convert): the configurations, the parameter layout and
count, the conversion of an untied-head tree, the training forward and
the ragged serving step's logits under 'native' and 'ozaki1-p4', and
the continuous engine with the untied head prepared once a session
('+cached').

Logits agree within 1e-4 * max|logits|: the emulated GEMMs are
bit-identical on equal inputs, and what differs is float32 ulps of XLA's
and torch's softmax, rope, norm and native matmul. Greedy tokens are
equal, or differ only after a step where the reference's top-2 margin is
under MARGIN; prepared and unprepared tokens of one package are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_util import t
from repro import api as japi, configs as jconfigs
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.serving import ContinuousEngine as JEngine, Request as JRequest
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.kernels import prepared
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.serving import ContinuousEngine, Request
from repro_torch.utils.tree import tree_flatten

ARCHS = ("granite-3-8b", "deepseek-coder-33b")
B, C, L = 2, 8, 24
MAX_SEQ = 32
MARGIN = 1e-3
_PARAMS = {}


def _params(arch_id):
    """The reference's seeded smoke parameters and the port's copy."""
    if arch_id not in _PARAMS:
        jarch = jconfigs.get_smoke_config(arch_id)
        jparams = JM.init_params(jax.random.PRNGKey(0), jarch.model)
        tree = jax.tree.map(np.asarray, jparams)
        _PARAMS[arch_id] = (jparams, tree, convert.params_from_jax(
            tree, tconfigs.get_smoke_config(arch_id).model, device="cpu"))
    return _PARAMS[arch_id]


def _policies(spec):
    return (jdispatch.resolve_policy(JPolicy(default=japi.precision(spec))),
            TPolicy(default=tapi.precision(spec)))


def _close(tl, jl):
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()


@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_are_the_references(arch_id):
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tconfigs, get)(arch_id))
                == dataclasses.asdict(getattr(jconfigs, get)(arch_id)))
    assert arch_id in tconfigs.ARCH_IDS


@pytest.mark.parametrize("arch_id,item", [("deepseek-v3-671b", "4.6")])
def test_other_archs_raise_naming_their_item(arch_id, item):
    """The last id of the reference's registry (ROADMAP.md § 1 item 4.6)
    is ported: its configs are the reference's, so no id raises but an
    unknown one, which names the known ids."""
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tconfigs, get)(arch_id))
                == dataclasses.asdict(getattr(jconfigs, get)(arch_id)))
    assert set(jconfigs.ARCH_IDS) <= set(tconfigs.ARCH_IDS)
    with pytest.raises(KeyError, match=arch_id):
        tconfigs.get_config(f"not-{item}")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_params_layout_and_count(arch_id):
    jparams, _, _ = _params(arch_id)
    m = tconfigs.get_smoke_config(arch_id).model
    ours = TM.init_params(m, seed=0, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0),
                               jconfigs.get_smoke_config(arch_id).model)))
    assert jax.tree.map(lambda x: tuple(x.shape), ours) == shapes
    assert TM.param_count(ours) == JM.param_count(jparams)
    assert "head" in ours and ours["head"].shape == (m.d_model, 512)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_convert_untied_gqa_tree_is_the_references(arch_id):
    """Every converted leaf, the untied head and GQA's narrower wk / wv
    among them, equals the reference's in shape and value."""
    _, tree, tparams = _params(arch_id)
    m = tconfigs.get_smoke_config(arch_id).model
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    ours = tree_flatten(tparams)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    kv = m.n_kv_heads * m.resolved_head_dim
    assert ours["layers/b0/mixer/wk"].shape == (m.n_layers, m.d_model, kv)
    assert kv < m.n_heads * m.resolved_head_dim
    assert ours["head"].shape == ref["head"].shape


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_forward_train_and_step_logits_match_reference(arch_id, spec):
    jparams, _, tparams = _params(arch_id)
    jm = jconfigs.get_smoke_config(arch_id).model
    tm = tconfigs.get_smoke_config(arch_id).model
    jpol, tpol = _policies(spec)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jm.vocab, (B, 12)).astype(np.int32)
    tokens = rng.integers(0, jm.vocab, (B, C)).astype(np.int32)
    start, n_new = np.array([0, 9], np.int32), np.array([8, 2], np.int32)
    hist = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in JM.init_cache(jm, B, L)["layers"]["b0"].items()}

    def ref(p, x, *step):       # one compile for both forwards
        return (JM.forward_train(p, jm, {"tokens": x}, jpol, remat=False)[0],
                JM.forward_step(p, jm, *step, jpol)[0])

    jtrain, jstep = jax.jit(ref)(
        jparams, jnp.asarray(toks), jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(n_new),
        {"layers": {"b0": {k: jnp.asarray(v) for k, v in hist.items()}}})
    tl, _, _ = TM.forward_train(tparams, tm, {"tokens": t(toks)}, tpol,
                                remat=False)
    _close(tl.detach(), jtrain)
    tl, _ = TM.forward_step(tparams, tm, t(tokens), t(start), t(n_new),
                            {"layers": {"b0": {k: t(v) for k, v in
                                               hist.items()}}}, tpol)
    _close(tl, jstep)


def _trace(vocab):
    r = np.random.default_rng(7)
    return [(r.integers(1, vocab, int(r.integers(4, 12))).tolist(), 3)
            for _ in range(3)]


def _serve(arch, params, spec, trace):
    eng = ContinuousEngine(arch, max_seq=MAX_SEQ, params=params, device="cpu",
                           policy=TPolicy(default=tapi.precision(spec)),
                           max_lanes=2, chunk=1, page_size=8)
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in trace]
    res = eng.run(reqs, max_steps=500)
    return eng, [res[r.rid].tokens for r in reqs]


def test_continuous_engine_prepares_the_untied_head(monkeypatch):
    """granite-3-8b under ozaki1-p4+cached: both packages prepare the
    head once a session; the port's tokens equal the reference's (or
    differ only under MARGIN) and its own unprepared ones, bit for bit."""
    jparams, _, tparams = _params("granite-3-8b")
    jarch = jconfigs.get_smoke_config("granite-3-8b")
    tarch = tconfigs.get_smoke_config("granite-3-8b")
    trace = _trace(jarch.model.vocab)
    jpol = JPolicy(default=japi.precision("ozaki1-p4+cached"))
    # chunk 1: one step function to compile on the reference's side.
    jeng = JEngine(jarch, None, max_seq=MAX_SEQ, policy=jpol, params=jparams,
                   max_lanes=2, chunk=1, page_size=8)
    assert jeng.prepared and hasattr(jeng.params["head"], "slices")
    jreqs = [JRequest(prompt=p, max_new_tokens=n) for p, n in trace]
    jres = jeng.run(jreqs, max_steps=500)
    jtoks = [jres[r.rid].tokens for r in jreqs]

    calls = []
    real = prepared.prepare_rhs
    monkeypatch.setattr(prepared, "prepare_rhs",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    eng, toks = _serve(tarch, tparams, "ozaki1-p4+cached", trace)
    assert eng.prepared and calls == [1]           # the head, once
    assert isinstance(eng.params["head"], prepared.PreparedOperand)
    assert (eng.params["layers"]["b0"]["mixer"]["wq"]
            is tparams["layers"]["b0"]["mixer"]["wq"])
    _, plain = _serve(tarch, tparams, "ozaki1-p4", trace)
    assert toks == plain
    for (prompt, _), jt, tt in zip(trace, jtoks, toks):
        if jt == tt:
            continue
        i = next(i for i, (x, y) in enumerate(zip(jt, tt)) if x != y)
        ctx = jnp.asarray([prompt + jt[:i]], jnp.int32)
        logits, _ = JM.forward_step(
            jparams, jarch.model, ctx, jnp.zeros((1,), jnp.int32),
            jnp.full((1,), ctx.shape[1], jnp.int32),
            JM.init_cache(jarch.model, 1, MAX_SEQ), jeng.policy)
        top2 = np.sort(np.asarray(logits[0, :jarch.model.vocab]))[-2:]
        assert top2[1] - top2[0] < MARGIN, (prompt, jt, tt)


def test_ozaki2_cached_serves_a_prepared_residue_head():
    """Under ozaki2-m6+cached the head is a PreparedResidues, consumed by
    EmuGEMM-II's prepared form; tokens equal the unprepared spec's."""
    _, _, tparams = _params("deepseek-coder-33b")
    tarch = tconfigs.get_smoke_config("deepseek-coder-33b")
    trace = _trace(tarch.model.vocab)[:2]
    eng, toks = _serve(tarch, tparams, "ozaki2-m6+cached", trace)
    assert isinstance(eng.params["head"], prepared.PreparedResidues)
    assert toks == _serve(tarch, tparams, "ozaki2-m6", trace)[1]
