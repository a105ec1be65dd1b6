"""The port's continuous-batching engine (repro_torch.serving) against the
reference engine (repro.serving), on the olmo-1b smoke config with the
same parameters: greedy tokens are equal on a 3-request trace, except
after a step where the reference's top-2 logit margin is below 1e-3
(there float32 ulps of the two frameworks may pick differently). Plus
the engine's own invariants: cohort independence and page accounting."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi, configs as jconfigs
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.serving import ContinuousEngine as JEngine, Request as JRequest
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.serving import (SCRATCH_PAGE, ContinuousEngine,
                                 PageAllocator, Request)

MAX_SEQ = 48
MARGIN = 1e-3


def _trace(n, seed):
    r = np.random.default_rng(seed)
    return [(r.integers(1, 500, int(r.integers(4, 20))).tolist(),
             int(r.integers(3, 6))) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_setup():
    arch = jconfigs.get_smoke_config("olmo-1b")
    params = JM.init_params(jax.random.PRNGKey(0), arch.model)
    return arch, params, jax.tree.map(np.asarray, params)


def _serve_port(tree, trace, spec, **kw):
    arch = tconfigs.get_smoke_config("olmo-1b")
    params = convert.params_from_jax(tree, arch.model, device="cpu")
    eng = ContinuousEngine(arch, max_seq=MAX_SEQ, params=params,
                           policy=TPolicy(default=tapi.precision(spec)),
                           device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in trace]
    res = eng.run(reqs, max_steps=2000)
    eng.sched.check_invariants()
    return [res[r.rid].tokens for r in reqs], eng


def _jax_margin(arch, params, policy, context):
    """The reference's top-2 logit margin after ``context``."""
    n = len(context)
    cache = JM.init_cache(arch.model, 1, MAX_SEQ)
    toks = jnp.asarray([context], jnp.int32)
    logits, _ = JM.forward_step(params, arch.model, toks,
                                jnp.zeros((1,), jnp.int32),
                                jnp.full((1,), n, jnp.int32), cache, policy)
    top2 = np.sort(np.asarray(logits[0, :arch.model.vocab]))[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_greedy_tokens_match_reference_engine(jax_setup, spec):
    arch, params, tree = jax_setup
    trace = _trace(3, seed=3)
    jpolicy = JPolicy(default=japi.precision(spec))
    jeng = JEngine(arch, None, max_seq=MAX_SEQ, policy=jpolicy,
                   params=params, max_lanes=2, chunk=8, page_size=8)
    jreqs = [JRequest(prompt=p, max_new_tokens=n) for p, n in trace]
    jres = jeng.run(jreqs, max_steps=2000)
    jtoks = [jres[r.rid].tokens for r in jreqs]
    ttoks, _ = _serve_port(tree, trace, spec, max_lanes=2, chunk=8,
                           page_size=8)
    for (prompt, _), jt, tt in zip(trace, jtoks, ttoks):
        if jt == tt:
            continue
        i = next(i for i, (x, y) in enumerate(zip(jt, tt)) if x != y)
        margin = _jax_margin(arch, params, jeng.policy, prompt + jt[:i])
        assert margin < MARGIN, (prompt, jt, tt, margin)


def test_tokens_independent_of_cohort_and_chunk(jax_setup):
    """A lane's tokens do not depend on the rest of the cohort, the
    chunk size or the wave schedule."""
    _, _, tree = jax_setup
    trace = _trace(4, seed=5)
    base, eng = _serve_port(tree, trace, "ozaki1-p4", max_lanes=3, chunk=8,
                            page_size=4)
    alone, _ = _serve_port(tree, trace[:1], "ozaki1-p4", max_lanes=3,
                           chunk=4, page_size=8)
    wave, _ = _serve_port(tree, trace, "ozaki1-p4", max_lanes=3, chunk=8,
                          page_size=4, wave_admission=True)
    assert alone[0] == base[0]
    assert wave == base
    assert eng.kv.allocator.used_pages == 0       # every page came back


def test_eviction_under_page_pressure_keeps_tokens(jax_setup):
    _, _, tree = jax_setup
    trace = _trace(4, seed=6)
    tight, eng = _serve_port(tree, trace, "native", max_lanes=3, chunk=8,
                             page_size=4, num_pages=9)
    roomy, _ = _serve_port(tree, trace, "native", max_lanes=3, chunk=8,
                           page_size=4)
    assert eng.sched.evictions > 0, "the trace needs page pressure"
    assert tight == roomy


def test_allocator_reserves_scratch_and_refuses_double_free():
    a = PageAllocator(num_pages=4)
    got = a.alloc(3, rid=1)
    assert got is not None and SCRATCH_PAGE not in got
    assert a.alloc(1, rid=2) is None
    a.free(got[:1], rid=1)
    with pytest.raises(ValueError, match="double free"):
        a.free(got[:1], rid=1)


def test_engine_refuses_what_the_slice_does_not_run():
    arch = tconfigs.get_smoke_config("olmo-1b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousEngine(arch, max_seq=16, device="cpu",
                         policy=TPolicy(default=tapi.precision("ozaki2-m6")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousEngine(arch, object(), max_seq=16, device="cpu")
    # '+cached' parses and, as in the reference, prepares nothing here:
    # it serves the same tokens as the plain spec.
    toks = {}
    for spec in ("ozaki1-p4+cached", "ozaki1-p4"):
        eng = ContinuousEngine(arch, max_seq=16, device="cpu",
                               policy=TPolicy(default=tapi.precision(spec)))
        req = Request(prompt=[5, 6, 7], max_new_tokens=2)
        toks[spec] = eng.run([req])[req.rid].tokens
        assert eng.prepared == spec.endswith("+cached")
    assert toks["ozaki1-p4+cached"] == toks["ozaki1-p4"]
