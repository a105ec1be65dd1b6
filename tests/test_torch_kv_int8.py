"""qwen1.5-32b and the int8 KV cache against the reference.

``quantize_kv`` is float32 IEEE division, round-half-to-even and a clip,
so on the same k and v the int8 values and the scales equal the
reference's bit for bit: shown on zero rows and on exact .5 ties, in
float32 and bf16 (whose max is taken in bf16 before the widening).

Then qwen1.5-32b's smoke config with ``kv_cache_dtype="int8"`` on both
sides (the reference's smoke config keeps "auto", so its own never runs
the int8 cache), from the same parameters (repro_torch.convert): the
whole-batch prefill and two decodes under 'native' and 'ozaki1-p4', to
the bars tests/test_torch_dense_zoo.py holds granite to (logits within
1e-4 * max|logits|). The caches' int8 values are the reference's bit for
bit; their float32 scales are the max of k and v, which differ from the
reference's by float32 ulps of XLA's and torch's native matmul, norm and
rope (and which the emulation carries forward), and agree to 1e-5. The continuous engine's tokens and int8 pools
are held against the reference engine's the same way, and a request's
tokens and pool rows served alone equal its own in a cohort, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import api as japi, configs as jconfigs
from repro.kernels import dispatch as jdispatch
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.serving import ContinuousEngine as JEngine, Request as JRequest
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.serving import ContinuousEngine, LockstepEngine, Request

ARCH = "qwen1.5-32b"
B, PROMPT, MAX_SEQ = 2, 9, 16
MARGIN = 1e-3
_PARAMS = {}


def _int8(arch):
    """The smoke config with the full config's int8 cache."""
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, kv_cache_dtype="int8"))


def _setup():
    """(reference arch, port arch, reference params, port params)."""
    if not _PARAMS:
        jarch = _int8(jconfigs.get_smoke_config(ARCH))
        tarch = _int8(tconfigs.get_smoke_config(ARCH))
        jparams = JM.init_params(jax.random.PRNGKey(0), jarch.model)
        _PARAMS["v"] = (jarch, tarch, jparams, convert.params_from_jax(
            jax.tree.map(np.asarray, jparams), tarch.model, device="cpu"))
    return _PARAMS["v"]


def _close(tl, jl):
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()


def _same_cache(tc, jc):
    """Every leaf's shape and dtype; int8 values bit for bit, float32
    scales to 1e-5."""
    assert tc.keys() == jc.keys() == {"k", "v", "k_scale", "v_scale"}
    for name, leaf in tc.items():
        ref = np.asarray(jc[name])
        assert tuple(leaf.shape) == ref.shape, name
        assert str(leaf.dtype).split(".")[-1] == str(ref.dtype), name
        if leaf.dtype == torch.int8:
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=name)
        else:
            np.testing.assert_allclose(leaf.numpy(), ref, rtol=1e-5,
                                       atol=0, err_msg=name)


def _kv_operand(dtype):
    """(B, S, KVH, D) values with a zero row, exact .5 ties (row max 127,
    so the scale is 1 and x / scale is x) and Eq. 19-like rows."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 3, 16))
         * np.exp(2 * rng.standard_normal((2, 5, 3, 1)))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = np.r_[127.0, np.arange(-7, 8) + 0.5].astype(np.float32)
    x[1, 2, 2] = -np.r_[127.0, np.arange(-7, 8) + 0.5].astype(np.float32)
    jx = jnp.asarray(x).astype(dtype[1])
    return jx, t(np.asarray(jx.astype(jnp.float32)), dtype[0])


@pytest.mark.parametrize("dtype", [(torch.float32, jnp.float32),
                                   (torch.bfloat16, jnp.bfloat16)],
                         ids=["float32", "bfloat16"])
def test_quantize_and_dequantize_kv_bit_for_bit(dtype):
    jx, tx = _kv_operand(dtype)
    jq, js = JA.quantize_kv(jx)
    tq, ts = TA.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert not tq[0, 0, 0].any()
    assert float(ts[0, 0, 0]) == np.float32(1e-8) / np.float32(127)
    # The ties (-6.5 ... 7.5) round half to even.
    assert tq[0, 1, 1].tolist() == [127, -6, -6, -4, -4, -2, -2, 0, 0, 2, 2,
                                    4, 4, 6, 6, 8]
    jd = np.asarray(JA.dequantize_kv(jq, js, dtype[1]).astype(jnp.float32))
    np.testing.assert_array_equal(
        TA.dequantize_kv(tq, ts, dtype[0]).float().numpy(), jd)


def test_config_and_cache_layout_are_the_references():
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tconfigs, get)(ARCH))
                == dataclasses.asdict(getattr(jconfigs, get)(ARCH)))
    full = tconfigs.get_config(ARCH).model
    assert ARCH in tconfigs.ARCH_IDS
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.qkv_bias, full.kv_cache_dtype) == (
        64, 5120, 40, 40, 27392, 152064, True, "int8")
    jarch, tarch, _, _ = _setup()
    acfg = TB.attn_config(tarch.model)
    assert acfg.cache_int8
    assert TA.cache_shape(acfg, 3, 20) == JA.cache_shape(
        JA.AttnConfig(**{f.name: getattr(acfg, f.name)
                         for f in dataclasses.fields(acfg)}), 3, 20)
    ref = jax.eval_shape(lambda: JM.init_cache(jarch.model, B, MAX_SEQ))
    ours = TM.init_cache(tarch.model, B, MAX_SEQ, device="cpu")
    assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), ref) == {
        "layers": {"b0": {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                          for k, v in ours["layers"]["b0"].items()}}}


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_prefill_decode_logits_and_int8_caches_match_reference(spec):
    """Prefill of a (2, 9) prompt batch, then two decodes: logits to the
    granite bar, int8 caches bit for bit (scales to 1e-5)."""
    jarch, tarch, jparams, tparams = _setup()
    jpol = jdispatch.resolve_policy(JPolicy(default=japi.precision(spec)))
    tpol = TPolicy(default=tapi.precision(spec))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 500, (B, PROMPT)).astype(np.int32)
    nxt = rng.integers(0, 500, (2, B, 1)).astype(np.int32)

    def ref(p, x, y):           # one compile for the prefill and decodes
        l0, c = JM.forward_prefill(p, jarch.model, {"tokens": x}, MAX_SEQ,
                                   jpol)
        l1, c = JM.forward_decode(p, jarch.model, y[0], PROMPT, c, jpol)
        l2, c = JM.forward_decode(p, jarch.model, y[1], PROMPT + 1, c, jpol)
        return l0, l1, l2, c

    *jl, jc = jax.jit(ref)(jparams, jnp.asarray(toks), jnp.asarray(nxt))
    tl0, tc = TM.forward_prefill(tparams, tarch.model, {"tokens": t(toks)},
                                 MAX_SEQ, tpol)
    tl1, tc = TM.forward_decode(tparams, tarch.model, t(nxt[0]), PROMPT, tc,
                                tpol)
    tl2, tc = TM.forward_decode(tparams, tarch.model, t(nxt[1]), PROMPT + 1,
                                tc, tpol)
    for a, b in zip((tl0, tl1, tl2), jl):
        _close(a, b)
    _same_cache(tc["layers"]["b0"], jc["layers"]["b0"])
    # The lockstep engine runs the same path.
    eng = LockstepEngine(tarch, None, MAX_SEQ, policy=tpol, params=tparams,
                         device="cpu")
    logits, cache = eng.prefill(t(toks))
    assert torch.equal(logits, tl0)
    for name, leaf in cache["layers"]["b0"].items():
        assert torch.equal(leaf[:, :, :PROMPT],
                           tc["layers"]["b0"][name][:, :, :PROMPT]), name


def _trace():
    r = np.random.default_rng(7)
    return [(r.integers(1, 500, int(r.integers(4, 12))).tolist(), 3)
            for _ in range(3)]


def _serve(tarch, tparams, trace, **kw):
    """Serve ``trace`` natively; also return each request's gathered
    pool rows at its release (prompt + generated - 1 rows written)."""
    eng = ContinuousEngine(tarch, max_seq=MAX_SEQ, params=tparams,
                           device="cpu", policy=TPolicy(
                               default=tapi.precision("native")),
                           max_lanes=2, chunk=1, page_size=8, **kw)
    rows, release = {}, eng.kv.release

    def keep(rid):
        views = eng.kv.gather(eng.pools, eng.kv.tables_for([rid]))
        rows[rid] = views["layers"]["b0"]
        release(rid)
    eng.kv.release = keep
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in trace]
    res = eng.run(reqs, max_steps=500)
    eng.sched.check_invariants()
    out = []
    for r, (p, n) in zip(reqs, trace):
        used = len(p) + n - 1
        out.append((res[r.rid].tokens, {k: v[:, 0, :used]
                                        for k, v in rows[r.rid].items()}))
    return eng, out


def test_continuous_engine_tokens_pools_and_cohorts():
    """The int8 continuous engine against the reference engine (tokens
    equal or within MARGIN, pools' int8 values bit for bit, scales to
    1e-5), and request 0 alone == in its cohort: tokens and pool rows
    bit for bit."""
    jarch, tarch, jparams, tparams = _setup()
    trace = _trace()
    jeng = JEngine(jarch, None, max_seq=MAX_SEQ,
                   policy=JPolicy(default=japi.precision("native")),
                   params=jparams, max_lanes=2, chunk=1, page_size=8)
    jreqs = [JRequest(prompt=p, max_new_tokens=n) for p, n in trace]
    jres = jeng.run(jreqs, max_steps=500)
    jtoks = [jres[r.rid].tokens for r in jreqs]
    eng, served = _serve(tarch, tparams, trace)
    toks = [s[0] for s in served]
    assert eng.pools["layers"]["b0"]["k"].dtype == torch.int8
    assert eng.pools["layers"]["b0"]["k_scale"].shape[-1] == 1
    if toks == jtoks:
        # Past the scratch page, whose slots take every padding write (of
        # several lanes to one slot, whichever the scatter lands last).
        page = eng.kv.page_size
        _same_cache({k: v[:, page:] for k, v in
                     eng.pools["layers"]["b0"].items()},
                    {k: np.asarray(v)[:, page:] for k, v in
                     jeng.pools["layers"]["b0"].items()})
    for (prompt, _), jt, tt in zip(trace, jtoks, toks):
        if jt == tt:
            continue
        i = next(i for i, (x, y) in enumerate(zip(jt, tt)) if x != y)
        ctx = jnp.asarray([prompt + jt[:i]], jnp.int32)
        logits, _ = JM.forward_step(
            jparams, jarch.model, ctx, jnp.zeros((1,), jnp.int32),
            jnp.full((1,), ctx.shape[1], jnp.int32),
            JM.init_cache(jarch.model, 1, MAX_SEQ), jeng.policy)
        top2 = np.sort(np.asarray(logits[0, :500]))[-2:]
        assert top2[1] - top2[0] < MARGIN, (prompt, jt, tt)
    _, alone = _serve(tarch, tparams, trace[:1])
    assert alone[0][0] == served[0][0]
    for name, leaf in alone[0][1].items():
        assert torch.equal(leaf, served[0][1][name]), name
