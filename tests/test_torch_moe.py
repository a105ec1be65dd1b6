"""qwen2-moe-a2.7b and qwen2-moe-a2.7b-emu, the port's MoE decoders
(repro_torch.models.moe), against the reference on their smoke configs
(2 layers, d_model 64, 6 routed experts padded to 8, top-2, 2 gated
shared experts, n_groups 4, float32) from the same parameters
(repro_torch.convert): the configurations, the parameter layout, count
and initial scales, the conversion of a bf16 tree with its float32
router, the routing (expert indices, capacity ranks, dropped slots),
the logits of the training forward, the ragged serving step and
prefill then decode, the loss and gradients at one microbatch and at
two, and the continuous engine.

The reference's ``make_train_step`` fails on this JAX (ROADMAP.md § 3
R1), so its gradients come from ``jax.value_and_grad`` of its mesh-free
``make_loss_fn``, jitted without remat, with ``+xla`` on each emulated
site of the JAX side (its own tests hold that expansion bit-identical
to its Pallas kernels). A two-microbatch step is held against the mean of the
reference's gradients of the same two halves, as the reference's scan
accumulates them (float32 sum from zeros, then / n_micro): groups and
capacity depend on a microbatch's own tokens, so a whole-batch oracle
would route differently.

Tolerances. Logits within 1e-4 * max|logits| (as
tests/test_torch_dense_zoo.py); the loss within 1e-5 relative and each
gradient leaf within 1e-4 relative L2 (as tests/test_torch_train_model.py;
measured: up to 8e-6 on a leaf). The emulated GEMMs are bit-identical on
equal inputs; XLA and torch round float32 softmax, rope, norms, exp and
the native matmuls in other orders. Routing is compared exactly: the
scores differ by float32 ulps at most, and no two of these draws' top-k
candidates are that close.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import one_torch_thread, t  # noqa: F401
from repro import api as japi, configs as jconfigs
from repro.data import SyntheticLMDataset as JDataset
from repro.launch import steps as JS
from repro.models import model as JM, moe as jmoe
from repro.models.common import GemmPolicy as JPolicy
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.configs.base import TrainPolicy
from repro_torch.launch import serve as tserve, steps as TS
from repro_torch.models import model as TM, moe as tmoe
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.serving import ContinuousEngine, Request
from repro_torch.utils.tree import tree_flatten

# torch on one thread: the parallel suite's workers share a few cores.
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b-emu")
BASE, EMU = ARCHS
B, C, L = 2, 8, 24
MAX_SEQ = 32
BATCH, SEQ = 2, 32
_PARAMS = {}


def _params():
    """The reference's seeded smoke parameters and the port's copy (both
    archs share the model; only their gemm_sites differ)."""
    if not _PARAMS:
        jparams = jax.jit(JM.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jconfigs.get_smoke_config(BASE).model)
        _PARAMS["p"] = (jparams, convert.params_from_jax(
            jax.tree.map(np.asarray, jparams),
            tconfigs.get_smoke_config(BASE).model, device="cpu"))
    return _PARAMS["p"]


def _xla(spec):
    return spec if spec == "native" else spec + "+xla"


def _policies(spec):
    """(reference, port) policies; None stands for the -emu config's
    gemm_sites, with ``+xla`` on each emulated site of the JAX side."""
    if spec is None:
        sites = jconfigs.get_smoke_config(EMU).gemm_sites
        jpol = JPolicy(
            default=japi.precision(_xla(dict(sites)["default"])),
            overrides=tuple((k, japi.precision(_xla(s))) for k, s in sites
                            if k != "default"))
        return jpol, tconfigs.get_smoke_config(EMU).gemm_policy()
    return (JPolicy(default=japi.precision(_xla(spec))),
            TPolicy(default=tapi.precision(spec)))


def _close(tl, jl):
    jl = np.asarray(jl)
    tl = tl.detach().numpy()
    assert tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()


def _rel(x: torch.Tensor, ref: np.ndarray) -> float:
    ref = ref.astype(np.float32)
    return float(np.linalg.norm(x.float().numpy() - ref)
                 / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------------------------------------
# Configurations and parameters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_are_the_references(arch_id):
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tconfigs, get)(arch_id))
                == dataclasses.asdict(getattr(jconfigs, get)(arch_id)))
    assert arch_id in tconfigs.ARCH_IDS
    full = tconfigs.get_config(arch_id).model
    assert (full.n_layers, full.d_model, tmoe.padded_experts(full.moe)) == (
        24, 2048, 64)


def test_sigmoid_scoring_is_refused_naming_its_item():
    """deepseek-v3's sigmoid routing (ROADMAP.md § 1 item 4.6) is ported:
    on qwen2-moe's smoke config it adds the reference's float32
    router_bias (zeros, one per padded expert and layer), and the
    forward runs; deepseek-v3-671b's config scores by sigmoid."""
    m = tconfigs.get_smoke_config(BASE).model
    m = dataclasses.replace(m, moe=dataclasses.replace(m.moe,
                                                       scoring="sigmoid"))
    params = TM.init_params(m, device="cpu")
    bias = params["layers"]["b0"]["moe"]["router_bias"]
    jm = jconfigs.get_smoke_config(BASE).model
    jbias = jax.eval_shape(lambda: JM.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(jm, moe=dataclasses.replace(
            jm.moe, scoring="sigmoid"))))["layers"]["b0"]["moe"]["router_bias"]
    assert (tuple(bias.shape), bias.dtype) == (jbias.shape, torch.float32)
    assert not bias.any()
    logits, _, aux = TM.forward_train(
        params, m, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    assert torch.isfinite(logits).all() and float(aux) > 0
    assert tconfigs.get_config("deepseek-v3-671b").model.moe.scoring == \
        "sigmoid"


@pytest.mark.parametrize("arch_id", ARCHS)
def test_params_layout_count_and_scales(arch_id):
    """The port's own draw has the reference's layout and count, and each
    leaf of more than 4096 entries the reference's scale within 10 %."""
    jparams, _ = _params()
    m = tconfigs.get_smoke_config(arch_id).model
    ours = TM.init_params(m, seed=0, device="cpu")
    assert (jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jparams)
            == jax.tree.map(lambda x: (tuple(x.shape),
                                       str(x.dtype).split(".")[-1]), ours))
    assert TM.param_count(ours) == JM.param_count(jparams)
    e = tmoe.padded_experts(m.moe)
    assert ours["layers"]["b0"]["moe"]["wi_gate"].shape == (
        m.n_layers, e, m.d_model, m.moe.d_ff_expert)
    ref = tree_flatten(jax.tree.map(np.asarray, jparams))
    for key, leaf in tree_flatten(ours).items():
        want = float(ref[key].std())
        if leaf.numel() > 4096 and want > 0:
            assert abs(float(leaf.std()) / want - 1) <= 0.1, key


def test_moe_init_scales_match_the_references_draw():
    """Every MoE leaf at qwen2-moe's width (d 2048): the expert stacks
    keep the reference's fan (the expert count for wi_gate / wi_up,
    ROADMAP.md § 3 R8), within 10 % of its draw's standard deviation."""
    cfg = tconfigs.get_smoke_config(BASE).model.moe
    d = 2048
    ref = jax.jit(jmoe.init_moe, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(0), d, cfg, "swiglu", jnp.float32)
    ours = tmoe.init_moe(torch.Generator().manual_seed(0), d, cfg, "swiglu",
                         torch.float32, "cpu", lead=(2,))
    ref = tree_flatten(jax.tree.map(np.asarray, ref))
    ours = tree_flatten(ours)
    assert ours.keys() == ref.keys()
    for key, v in ref.items():
        assert tuple(ours[key].shape) == (2,) + v.shape, key
        assert abs(float(ours[key].std()) / float(v.std()) - 1) <= 0.1, key
    # He with fan 8 (experts), not 2048 (d_model).
    assert abs(float(ours["wi_gate"].std()) - 0.5) < 0.01


def test_convert_keeps_each_leafs_dtype():
    """A bf16 tree (the reference's bf16 model keeps its router float32):
    the router stays float32, every bf16 leaf stays bf16, and every leaf
    equals the reference's bit for bit."""
    m = dataclasses.replace(jconfigs.get_smoke_config(BASE).model,
                            dtype="bfloat16")
    layout = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), m))
    jparams, _ = _params()
    tree = jax.tree.map(lambda x, like: np.asarray(x.astype(like.dtype)),
                        jparams, layout)
    ours = tree_flatten(convert.params_from_jax(
        tree, dataclasses.replace(tconfigs.get_smoke_config(BASE).model,
                                  dtype="bfloat16"), device="cpu"))
    ref = tree_flatten(tree)
    assert ours.keys() == ref.keys()
    for key, v in ref.items():
        want = torch.float32 if key.endswith("router") else torch.bfloat16
        assert v.dtype.name == str(want).split(".")[-1], key
        assert ours[key].dtype == want, key
        np.testing.assert_array_equal(ours[key].float().numpy(),
                                      v.astype(np.float32), err_msg=key)


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["native", "ozaki2-m6"])
def test_route_and_dispatch_match_reference(spec):
    """Expert indices, capacity ranks (the dispatch one-hot) and dropped
    slots equal the reference's exactly; weights and combine within 1e-6.
    Four groups of six tokens at top-2 over 8 experts: capacity 1, so
    slots are dropped."""
    cfg = tconfigs.get_smoke_config(BASE).model.moe
    jpol, tpol = _policies(spec)
    rng = np.random.default_rng(0)
    g, tok, d = 4, 6, 64
    x = rng.standard_normal((g, tok, d)).astype(np.float32)
    router = (rng.standard_normal((d, 8)) / 8).astype(np.float32)
    jw, jidx, jscores = jmoe._route({"router": jnp.asarray(router)}, cfg,
                                    jnp.asarray(x), jpol)
    tw, tidx, tscores = tmoe._route({"router": t(router)}, cfg, t(x), tpol)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx < cfg.n_experts).all()             # padding never routed
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=0,
                               atol=1e-6)
    jd, jc, jcap = jmoe._dispatch_combine(cfg, jw, jidx, tok, jnp.float32)
    td, tc, tcap = tmoe._dispatch_combine(cfg, tw, tidx, tok, torch.float32)
    assert tcap == jcap == 1
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    dropped = g * tok * cfg.top_k - int(td.sum())
    assert dropped > 0 and dropped == g * tok * cfg.top_k - int(
        np.asarray(jd).sum())
    np.testing.assert_allclose(
        float(tmoe.aux_load_balance_loss(cfg, tscores, tidx)),
        float(jmoe.aux_load_balance_loss(cfg, jscores, jidx)), rtol=1e-6)


def test_top_k_ties_take_the_lower_index():
    """Equal scores: the lower expert index first, as jax.lax.top_k."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(BASE).model.moe,
                              n_experts=8, top_k=3)
    x = torch.zeros((1, 2, 4))
    x[0, 1, 0] = 1.0
    router = torch.zeros((4, 8))
    router[0, 5] = 1.0
    _, idx, _ = tmoe._route({"router": router}, cfg, x,
                            TPolicy(default=tapi.precision("native")))
    _, jidx, _ = jmoe._route({"router": jnp.asarray(router.numpy())}, cfg,
                             jnp.asarray(x.numpy()),
                             JPolicy(default=japi.precision("native")))
    assert idx.tolist() == np.asarray(jidx).tolist() == [[[0, 1, 2],
                                                          [5, 0, 1]]]


# ---------------------------------------------------------------------------
# Logits.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id,spec", [
    (BASE, "native"), (BASE, "ozaki1-p4"), (EMU, None)])
def test_logits_match_reference(arch_id, spec):
    """forward_train and the ragged forward_step; under native and the
    -emu sites also forward_prefill then one forward_decode (ozaki1-p4
    leaves them out: tracing the reference's emulated expansion is most
    of this file's time, and the -emu sites run ozaki1-p4 on the experts,
    attn_av and every dense projection)."""
    jparams, tparams = _params()
    jm = jconfigs.get_smoke_config(arch_id).model
    tm = tconfigs.get_smoke_config(arch_id).model
    jpol, tpol = _policies(spec)
    lockstep = spec != "ozaki1-p4"
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jm.vocab, (B, 12)).astype(np.int32)
    tokens = rng.integers(0, jm.vocab, (B, C)).astype(np.int32)
    start, n_new = np.array([0, 9], np.int32), np.array([8, 2], np.int32)
    hist = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in JM.init_cache(jm, B, L)["layers"]["b0"].items()}
    nxt = rng.integers(0, jm.vocab, (B, 1)).astype(np.int32)

    def ref(p, x, step_args, nxt):         # one compile for all of them
        out = (JM.forward_train(p, jm, {"tokens": x}, jpol, remat=False)[0],
               JM.forward_step(p, jm, *step_args, jpol)[0])
        if not lockstep:
            return out
        pre, cache = JM.forward_prefill(p, jm, {"tokens": x}, MAX_SEQ, jpol)
        dec, _ = JM.forward_decode(p, jm, nxt, x.shape[1], cache, jpol)
        return out + (pre, dec)

    step_args = (jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(n_new),
                 {"layers": {"b0": {k: jnp.asarray(v)
                                    for k, v in hist.items()}}})
    want = jax.jit(ref)(jparams, jnp.asarray(toks), step_args,
                        jnp.asarray(nxt))
    tl, _, aux = TM.forward_train(tparams, tm, {"tokens": t(toks)}, tpol,
                                  remat=False)
    _close(tl, want[0])
    assert aux.dtype == torch.float32 and float(aux) > 0
    tl, _ = TM.forward_step(tparams, tm, t(tokens), t(start), t(n_new),
                            {"layers": {"b0": {k: t(v) for k, v in
                                               hist.items()}}}, tpol)
    _close(tl, want[1])
    if not lockstep:
        return
    pre, cache = TM.forward_prefill(tparams, tm, {"tokens": t(toks)},
                                    MAX_SEQ, tpol)
    _close(pre, want[2])
    dec, _ = TM.forward_decode(tparams, tm, t(nxt), toks.shape[1], cache,
                               tpol)
    _close(dec, want[3])


# ---------------------------------------------------------------------------
# Loss and gradients (the -emu sites: Scheme II on the router and attn_qk,
# Scheme I on the experts, attn_av and the dense projections).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grads_setup():
    jparams, tparams = _params()
    jarch = jconfigs.get_smoke_config(EMU)
    # No remat on the JAX side (it changes no value, and compiles faster);
    # the port's steps keep the config's.
    jarch = dataclasses.replace(jarch, train=dataclasses.replace(
        jarch.train, remat=False))
    jpol, tpol = _policies(None)
    jvg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jarch, jpol)))
    batch = JDataset(jarch.model.vocab, SEQ, 0).batch(0, 2 * BATCH)
    halves = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in batch.items()}
              for i in range(2)]
    ref = [jvg(jparams, {k: jnp.asarray(v) for k, v in h.items()})
           for h in halves]
    return tparams, tpol, batch, halves, ref


def _check_grads(tl, tg, jl, jg):
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = tree_flatten(jax.tree.map(np.asarray, jg))
    tflat = tree_flatten(tg)
    assert sorted(tflat) == sorted(jflat)
    assert "layers/b0/moe/router" in tflat
    for key, g in tflat.items():
        assert _rel(g, jflat[key]) <= 1e-4, key


def test_loss_and_gradients_match_reference(grads_setup):
    """One microbatch (the smoke config's): the loss with its aux term
    and every gradient leaf, the float32 router's among them."""
    tparams, tpol, _, halves, ref = grads_setup
    tarch = tconfigs.get_smoke_config(EMU)
    tl, tg = TS.value_and_grad(TS.make_loss_fn(tarch, tpol), tparams,
                               TS.batch_to(halves[0], "cpu"))
    assert tg["layers"]["b0"]["moe"]["router"].dtype == torch.float32
    _check_grads(tl, tg, *ref[0])


def test_two_microbatch_step_matches_reference_halves(grads_setup,
                                                      monkeypatch):
    """make_train_step with microbatches=2 (the -emu default site is
    '+cached': the dense weights prepared once for the step, MoE leaves
    not) against the float32 mean of the reference's gradients of the
    same two halves; the step's gradients are read where it clips them."""
    tparams, _, batch, _, ref = grads_setup
    tarch = dataclasses.replace(tconfigs.get_smoke_config(EMU),
                                train=TrainPolicy(microbatches=2))
    seen = []
    real = TS.clip_by_global_norm
    monkeypatch.setattr(TS, "clip_by_global_norm",
                        lambda g, c: seen.append(g) or real(g, c))
    step = TS.make_train_step(tarch)
    _, metrics = step({"params": tparams,
                       "opt": TS.make_optimizer("adamw")[0](tparams)}, batch)
    (l1, g1), (l2, g2) = ref
    jg = jax.tree.map(lambda a, b: (np.zeros(a.shape, np.float32)
                                    + np.asarray(a, np.float32)
                                    + np.asarray(b, np.float32)) / 2, g1, g2)
    _check_grads(metrics["loss"], seen[0], (float(l1) + float(l2)) / 2, jg)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

def test_continuous_engine_serves_moe():
    """qwen2-moe-a2.7b-emu under its gemm_sites on the CPU: well-formed
    tokens, and request 0 alone == in its cohort (chunk 1 on 2 lanes: a
    step's 2 tokens form 2 groups of one, so no token competes for
    capacity with another lane's)."""
    _, tparams = _params()
    tarch = tconfigs.get_smoke_config(EMU)
    r = np.random.default_rng(7)
    trace = [(r.integers(1, tarch.model.vocab, int(r.integers(4, 10)))
              .tolist(), 3) for _ in range(3)]

    def serve(reqs):
        eng = ContinuousEngine(tarch, max_seq=MAX_SEQ, params=tparams,
                               device="cpu", max_lanes=2, chunk=1,
                               page_size=8)
        reqs = [Request(prompt=p, max_new_tokens=n) for p, n in reqs]
        res = eng.run(reqs, max_steps=200)
        return eng, [res[q.rid].tokens for q in reqs]

    eng, toks = serve(trace)
    assert eng.policy.for_site("moe_gate").scheme == "ozaki2"
    assert all(len(x) == 3 and all(0 <= v < tarch.model.vocab for v in x)
               for x in toks)
    assert serve(trace[:1])[1][0] == toks[0]


def test_serve_cli_runs_the_moe_arch(capsys):
    toks = tserve.main(["--arch", EMU, "--smoke", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "8", "--gen", "2"])
    assert len(toks) == 2 and all(len(x) == 2 for x in toks)
    assert "[serve] 2 requests x 2 tokens" in capsys.readouterr().out
