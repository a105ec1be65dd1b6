"""deepseek-v3-671b, the port's MLA + sigmoid-routed MoE decoder with
multi-token prediction, against the reference on its smoke config (2
layers, d_model 64, 4 heads, MLA q_lora 32 / kv_lora 16 / nope 16 / rope
8 / v 16, 8 routed experts top-2 and one shared, n_groups 4, float32),
from the same parameters (repro_torch.convert) with a nonzero
``router_bias`` in every MoE: the configurations, the parameter layout
(the ``mtp`` group, the float32 router and bias in a bf16 tree), the
training forward's logits and MTP logits, the ragged serving step, the
loss with its MTP term and every gradient, Adafactor (alone, in a
two-microbatch step with the hoist, through the Trainer's checkpoints),
prefill / decode against the latent cache and both engines' tokens, the
CLIs, and the set of leaves a '+cached' session and step prepare.

The reference's ``make_train_step`` fails on this JAX (ROADMAP.md § 3
R1), so its gradients come from ``jax.value_and_grad`` of its mesh-free
``make_loss_fn``, jitted without remat, with ``+xla`` on the emulated
site (its own tests hold that expansion bit-identical to its Pallas
kernels), and its step is composed from its own clip, schedule and
``adafactor_update``.

Tolerances: logits within 1e-4 * max|logits| (float32 ulps of XLA's and
torch's norms, rope, softmax and native matmuls, carried through the
layers; the emulated GEMMs are the same bits on equal operands); the loss
within 1e-5 relative and each gradient leaf within 1e-4 relative L2 (as
tests/test_torch_moe.py); Adafactor's states within 1e-6 relative and
its parameters within 1e-6 of max|p| on equal gradients, its statistics
within 1e-3 relative L2 on gradients that agree to 1e-4; greedy tokens
equal, or different only after a step whose top-2 margin is under
MARGIN.
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
from repro.kernels import dispatch as jdispatch, prepared as jprepared
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.optim import optimizers as JO
from repro.serving.engine import LockstepEngine as JLockstep
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeSpec, TrainPolicy
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import prepared
from repro_torch.launch import serve as tserve, steps as TS, train as tcli
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.optim import optimizers as TO
from repro_torch.runtime import FailureInjector, Trainer
from repro_torch.serving import ContinuousEngine, LockstepEngine, Request
from repro_torch.utils.tree import tree_flatten, tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCH = "deepseek-v3-671b"
B, PROMPT, GEN = 2, 16, 6
MAX_SEQ = 32
BATCH, SEQ = 2, 32
MARGIN = 1e-3
_PARAMS = {}


def _biased(tree, xp):
    """Every MoE's router_bias set to a fixed nonzero ramp (the init's is
    zero), so that it moves the selection."""
    tree = dict(tree, layers={"b0": dict(tree["layers"]["b0"])},
                mtp=dict(tree["mtp"], block=dict(tree["mtp"]["block"])))
    for blk, lead in ((tree["layers"]["b0"], (2,)),
                      (tree["mtp"]["block"], ())):
        ramp = np.linspace(-0.3, 0.3, 8, dtype=np.float32)
        blk["moe"] = dict(blk["moe"], router_bias=xp.asarray(
            np.broadcast_to(ramp, lead + (8,)).copy()))
    return tree


def _params():
    """The reference's seeded smoke parameters (biased) and the port's
    copy."""
    if not _PARAMS:
        jm = jconfigs.get_smoke_config(ARCH).model
        jparams = _biased(jax.jit(JM.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jm), jnp)
        _PARAMS["p"] = (jparams, convert.params_from_jax(
            jax.tree.map(np.asarray, jparams),
            tconfigs.get_smoke_config(ARCH).model, device="cpu"))
    return _PARAMS["p"]


def _policies(spec, xla=False):
    jspec = spec + "+xla" if xla and spec != "native" else spec
    return (jdispatch.resolve_policy(JPolicy(default=japi.precision(jspec))),
            TPolicy(default=tapi.precision(spec)))


def _close(tl, jl, tol=1e-4):
    jl = np.asarray(jl)
    tl = tl.detach().numpy() if isinstance(tl, torch.Tensor) else tl
    assert tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= tol * np.abs(jl).max()


def _rel(x: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(x.float().numpy() - ref)
                 / max(np.linalg.norm(ref), 1e-30))


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _flat(jtree) -> dict:
    return {_key(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}


# ---------------------------------------------------------------------------
# Configurations and parameters.
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tconfigs, get)(ARCH))
                == dataclasses.asdict(getattr(jconfigs, get)(ARCH)))
    full = tconfigs.get_config(ARCH)
    assert ARCH in tconfigs.ARCH_IDS
    assert (full.model.n_layers, full.model.mla.kv_lora_rank,
            full.model.moe.scoring, full.train.optimizer) == (
        61, 512, "sigmoid", "adafactor")
    assert tconfigs.get_smoke_config(ARCH).train.optimizer == "adamw"


def test_params_layout_count_and_convert():
    """The port's own draw has the reference's leaves, shapes and dtypes
    (the mtp group among them; the router and its zero bias float32 in a
    bf16 tree), and the conversion of the reference's bf16 tree keeps
    every leaf's dtype and bits."""
    jm = dataclasses.replace(jconfigs.get_smoke_config(ARCH).model,
                             dtype="bfloat16")
    tm = dataclasses.replace(tconfigs.get_smoke_config(ARCH).model,
                             dtype="bfloat16")
    layout = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jm))
    ours = TM.init_params(tm, seed=0, device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            {_key(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(layout)[0]}.items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in tree_flatten(ours).items()}
    assert got == want
    assert set(ours["mtp"]) == {"proj", "block", "ln"}
    assert got["mtp/block/moe/router_bias"] == ((8,), "float32")
    assert not ours["layers"]["b0"]["moe"]["router_bias"].any()
    assert TM.param_count(ours) == sum(int(np.prod(s)) for s, _ in
                                       want.values())
    jparams, _ = _params()
    tree = jax.tree.map(lambda x, like: np.asarray(x).astype(like.dtype),
                        jparams, layout)
    conv = tree_flatten(convert.params_from_jax(tree, tm, device="cpu"))
    for key, v in _flat(tree).items():
        assert str(conv[key].dtype).split(".")[-1] == v.dtype.name, key
        np.testing.assert_array_equal(conv[key].float().numpy(),
                                      v.astype(np.float32), err_msg=key)
    with pytest.raises(ValueError, match="not the reference"):
        convert.params_from_jax(dict(tree, extra={}), tm, device="cpu")


# ---------------------------------------------------------------------------
# Logits.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_forward_train_mtp_and_step_logits_match_reference(spec):
    """forward_train's logits, MTP logits and aux loss, and one ragged
    forward_step on latent views with history."""
    jparams, tparams = _params()
    jm = jconfigs.get_smoke_config(ARCH).model
    tm = tconfigs.get_smoke_config(ARCH).model
    jpol, tpol = _policies(spec)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jm.vocab, (B, 24)).astype(np.int32)
    tokens = rng.integers(0, jm.vocab, (B, 8)).astype(np.int32)
    start, n_new = np.array([0, 9], np.int32), np.array([8, 2], np.int32)
    hist = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in JM.init_cache(jm, B, MAX_SEQ)["layers"]["b0"].items()}

    def ref(p, x, tokens, start, n_new, hist):   # one compile
        return (JM.forward_train(p, jm, {"tokens": x}, jpol, remat=False),
                JM.forward_step(p, jm, tokens, start, n_new,
                                {"layers": {"b0": hist}}, jpol)[0])

    (jl, jmtp, jaux), jstep = jax.jit(ref)(
        jparams, jnp.asarray(toks), jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(n_new), {k: jnp.asarray(v) for k, v in hist.items()})
    tl, tmtp, aux = TM.forward_train(tparams, tm, {"tokens": t(toks)}, tpol,
                                     remat=False)
    _close(tl, jl)
    _close(tmtp, jmtp)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    tl, _ = TM.forward_step(tparams, tm, t(tokens), t(start), t(n_new),
                            {"layers": {"b0": {k: t(v) for k, v in
                                               hist.items()}}}, tpol)
    _close(tl, jstep)


# ---------------------------------------------------------------------------
# Loss, gradients, Adafactor.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_grads():
    """The reference's mesh-free loss and gradients under ozaki1-p4 (its
    +xla expansion) on each half of a batch of 2 x BATCH rows."""
    jparams, tparams = _params()
    jarch = jconfigs.get_smoke_config(ARCH)
    jarch = dataclasses.replace(jarch, train=dataclasses.replace(
        jarch.train, remat=False))
    jpol, tpol = _policies("ozaki1-p4", xla=True)
    jvg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jarch, jpol)))
    batch = JDataset(jarch.model.vocab, SEQ, 0).batch(0, 2 * BATCH)
    halves = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in batch.items()}
              for i in range(2)]
    ref = [jvg(jparams, {k: jnp.asarray(v) for k, v in h.items()})
           for h in halves]
    return tparams, tpol, batch, halves, ref


def _check_grads(tl, tg, jl, jg):
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = _flat(jg)
    tflat = tree_flatten(tg)
    assert sorted(tflat) == sorted(jflat)
    for key, g in tflat.items():
        assert _rel(g, jflat[key]) <= 1e-4, key


def test_loss_with_mtp_term_and_gradients_match_reference(ref_grads):
    """One microbatch: the loss (cross-entropy + 0.3 x the MTP
    cross-entropy against labels shifted once more + the aux terms) and
    every gradient leaf, the MTP group's and the float32 router's among
    them; the router bias takes no gradient (selection only)."""
    tparams, tpol, _, halves, ref = ref_grads
    tarch = tconfigs.get_smoke_config(ARCH)
    batch = TS.batch_to(halves[0], "cpu")
    tl, tg = TS.value_and_grad(TS.make_loss_fn(tarch, tpol), tparams, batch)
    _check_grads(tl, tg, *ref[0])
    assert tg["mtp"]["proj"].abs().sum() > 0
    assert not tg["layers"]["b0"]["moe"]["router_bias"].any()
    no_mtp = dataclasses.replace(tarch, model=dataclasses.replace(
        tarch.model, mtp=False))
    base = TS.make_loss_fn(no_mtp, tpol)(
        {k: v for k, v in tparams.items() if k != "mtp"}, batch)
    assert float(tl) - float(base) > 0.3 * 5      # 0.3 x an NLL near ln 500


def _adafactor_tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal(5).astype(dtype),
            "b": rng.standard_normal((6, 7)).astype(dtype),
            "c": {"d": rng.standard_normal((2, 6, 7)).astype(dtype),
                  "e": rng.standard_normal((2, 3, 6, 7)).astype(dtype)}}


def test_adafactor_three_steps_match_reference():
    """adafactor_init and three adafactor_update steps on 1-D, 2-D, 3-D
    and 4-D leaves (factored per trailing matrix; a 1-D leaf's vc stays a
    (1,) zero), the gradients of each step seeded, against the
    reference's functions."""
    rng = np.random.default_rng(9)
    params = _adafactor_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(t, params)
    js, ts = JO.adafactor_init(jp), TO.adafactor_init(tp)
    assert {k: tuple(v.shape) for k, v in tree_flatten(ts).items()} == {
        k: v.shape for k, v in _flat(js).items()}
    upd = jax.jit(JO.adafactor_update)
    for step in range(3):
        grads = _adafactor_tree(rng)
        lr = 1e-2 * (step + 1)
        jp, js = upd(jax.tree.map(jnp.asarray, grads), js, jp, lr)
        tp, ts = TO.adafactor_update(tree_map(t, grads), ts, tp, lr)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for key, v in _flat(js).items():
            got = tree_flatten(ts)[key]
            assert got.dtype == torch.int32 or got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), v, rtol=1e-6, atol=0,
                                       err_msg=key)
        for key, v in _flat(jp).items():
            _close(tree_flatten(tp)[key], v, 1e-6)
    assert not ts["vc"]["a"].any() and ts["vc"]["a"].shape == (1,)


def test_adafactor_step_with_the_hoist_matches_reference(ref_grads,
                                                         monkeypatch):
    """make_train_step with optimizer="adafactor" and 2 microbatches under
    ozaki1-p4+cached (the dense weights prepared once for the step):
    its gradients against the float32 mean of the reference's halves,
    and its new parameters and Adafactor state against the reference's
    clip, schedule and adafactor_update applied to those gradients (both
    states at step 10, so that the learning rate is not 0)."""
    tparams, _, batch, _, ref = ref_grads
    jparams, _ = _params()
    base = tconfigs.get_smoke_config(ARCH)
    tarch = dataclasses.replace(base, train=TrainPolicy(
        microbatches=2, optimizer="adafactor"))
    seen = []
    real = TS.clip_by_global_norm
    monkeypatch.setattr(TS, "clip_by_global_norm",
                        lambda g, c: seen.append(g) or real(g, c))
    step = TS.make_train_step(tarch, policy=TPolicy(
        default=tapi.precision("ozaki1-p4+cached")))
    opt = dict(TO.adafactor_init(tparams), step=torch.tensor(10,
                                                             dtype=torch.int32))
    state, metrics = step({"params": tparams, "opt": opt}, batch)
    (l1, g1), (l2, g2) = ref
    jg = jax.tree.map(lambda a, b: (np.zeros(a.shape, np.float32)
                                    + np.asarray(a, np.float32)
                                    + np.asarray(b, np.float32)) / 2, g1, g2)
    _check_grads(metrics["loss"], seen[0], (float(l1) + float(l2)) / 2, jg)

    def ref_update(g, p):                 # one compile
        opt = dict(JO.adafactor_init(p), step=jnp.asarray(10, jnp.int32))
        lr = JO.warmup_cosine(opt["step"], tarch.train.learning_rate)
        return lr, JO.adafactor_update(JO.clip_by_global_norm(g, 1.0)[0],
                                       opt, p, lr)

    lr, (jnew, jopt) = jax.jit(ref_update)(jg, jparams)
    assert float(lr) > 0 and abs(float(metrics["lr"]) - float(lr)) < 1e-12
    assert int(state["opt"]["step"]) == int(jopt["step"]) == 11
    new = tree_flatten(state["params"])
    for key, v in _flat(jnew).items():
        _close(new[key], v, 1e-6)
    stats = tree_flatten({"vr": state["opt"]["vr"], "vc": state["opt"]["vc"]})
    for key, v in _flat({"vr": jopt["vr"], "vc": jopt["vc"]}).items():
        assert _rel(stats[key], v) <= 1e-3, key


def test_trainer_checkpoints_adafactor_state(tmp_path):
    """A Trainer with Adafactor that fails at step 2 and resumes from its
    checkpoint ends in the uninterrupted run's state, bit for bit; the
    checkpoint holds the vr / vc statistics and the step."""
    base = tconfigs.get_smoke_config(ARCH)
    arch = dataclasses.replace(base, train=TrainPolicy(optimizer="adafactor"))
    shape = ShapeSpec("smoke", 16, 2, "train")

    def run(d, fail_at=None):
        tr = Trainer(step_fn=TS.make_train_step(arch),
                     init_state_fn=lambda: TS.init_state(arch, 0, "cpu"),
                     batch_iterator=make_batch_iterator(arch, shape, 0),
                     ckpt_dir=str(tmp_path / d), device="cpu", ckpt_every=1,
                     failure=FailureInjector(fail_at))
        try:
            tr.run(3 - tr.start_step)
        finally:
            tr.close()
        return tr

    ref = run("ref")
    with pytest.raises(RuntimeError, match="injected failure"):
        run("ft", fail_at=2)
    assert run("ft").start_step == 3
    saved = CheckpointManager(str(tmp_path / "ft")).restore(2)
    assert int(saved["opt"]["step"]) == 3
    assert saved["opt"]["vc"]["layers"]["b0"]["moe"]["wo"].shape == (
        2, 8, 64)
    flat = tree_flatten(saved)
    for key, x in tree_flatten(ref.state).items():
        assert x.dtype == flat[key].dtype and torch.equal(x, flat[key]), key


# ---------------------------------------------------------------------------
# Serving: the latent cache.
# ---------------------------------------------------------------------------

def test_prefill_decode_and_lockstep_tokens_match_reference():
    """forward_prefill then decodes fed the reference's greedy tokens:
    logits at every step and the final latent cache within the bars;
    then both LockstepEngines' greedy tokens."""
    jparams, tparams = _params()
    jarch = jconfigs.get_smoke_config(ARCH)
    tarch = tconfigs.get_smoke_config(ARCH)
    jpol, tpol = _policies("native")
    prompts = np.random.default_rng(2).integers(
        0, jarch.model.vocab, (B, PROMPT)).astype(np.int32)
    jeng = JLockstep(jarch, None, MAX_SEQ, jpol, params=jparams)
    jlog, jcache = jeng._prefill(jparams, {"tokens": jnp.asarray(prompts)})
    tlog, tcache = TM.forward_prefill(tparams, tarch.model,
                                      {"tokens": t(prompts)}, MAX_SEQ, tpol)
    _close(tlog, jlog)
    margins = []
    for i in range(1, GEN):
        tok = jnp.argmax(jlog[:, -1:, :jarch.model.vocab], axis=-1)
        top2 = np.sort(np.asarray(jlog)[:, -1, :jarch.model.vocab], -1)
        margins.append((top2[:, -1] - top2[:, -2]).min())
        jlog, jcache = jeng._decode(jparams, tok, PROMPT + i - 1, jcache)
        tlog, tcache = TM.forward_decode(tparams, tarch.model,
                                         t(np.asarray(tok)), PROMPT + i - 1,
                                         tcache, tpol)
        _close(tlog, jlog)
    tflat = tree_flatten(tcache)
    assert sorted(tflat) == ["layers/b0/c_kv", "layers/b0/k_pe"]
    assert tflat["layers/b0/c_kv"].shape == (2, B, MAX_SEQ, 16)
    for k, v in _flat(jcache).items():
        _close(tflat[k], v)
    jt = np.asarray(jeng.generate(prompts, GEN))
    tt = LockstepEngine(tarch, None, MAX_SEQ, tpol, params=tparams,
                        device="cpu").generate(prompts, GEN)
    assert tt.shape == jt.shape == (B, GEN)
    for lane in range(B):
        diff = np.nonzero(tt[lane] != jt[lane])[0]
        if len(diff):
            assert min(margins[:diff[0] + 1]) < MARGIN, (lane, diff)


def test_continuous_engine_serves_on_latent_pools():
    """The continuous engine's pools are the latent cache's leaves, paged
    ((n_layers, pages x page, kv_lora_rank) and (..., qk_rope_dim)); under
    ozaki1-p4 with n_groups 512 (one token a MoE group, as a full-width
    serve step has), request 0 alone == in its cohort, and its tokens
    equal the lockstep engine's on the CPU."""
    _, tparams = _params()
    base = tconfigs.get_smoke_config(ARCH)
    arch = dataclasses.replace(base, model=dataclasses.replace(
        base.model, moe=dataclasses.replace(base.model.moe, n_groups=512)))
    r = np.random.default_rng(7)
    trace = [(r.integers(1, arch.model.vocab, int(r.integers(5, 12)))
              .tolist(), 4) for _ in range(3)]
    pol = TPolicy(default=tapi.precision("ozaki1-p4"))

    def serve(reqs):
        eng = ContinuousEngine(arch, max_seq=MAX_SEQ, policy=pol,
                               params=tparams, device="cpu", max_lanes=2,
                               chunk=4, page_size=8)
        reqs = [Request(prompt=p, max_new_tokens=n) for p, n in reqs]
        res = eng.run(reqs, max_steps=200)
        return eng, [res[q.rid].tokens for q in reqs]

    eng, toks = serve(trace)
    pools = eng.pools["layers"]["b0"]
    assert {k: tuple(v.shape) for k, v in pools.items()} == {
        "c_kv": (2, eng.kv.num_pages * 8, 16),
        "k_pe": (2, eng.kv.num_pages * 8, 8)}
    assert all(len(x) == 4 and all(0 <= v < arch.model.vocab for v in x)
               for x in toks)
    assert serve(trace[:1])[1][0] == toks[0]
    lock = LockstepEngine(arch, None, MAX_SEQ, pol, params=tparams,
                          device="cpu")
    assert lock.generate(np.asarray([trace[0][0]], np.int32),
                         4)[0].tolist() == toks[0]


def test_serve_and_train_clis_run_deepseek_v3(capsys, tmp_path):
    toks = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "8", "--gen", "2"])
    assert len(toks) == 2 and all(len(x) == 2 for x in toks)
    toks = tserve.main(["--arch", ARCH, "--smoke", "--lockstep", "--device",
                        "cpu", "--gemm", "ozaki1-p4+cached", "--prepare",
                        "--requests", "2", "--prompt-len", "8", "--gen",
                        "2"])
    assert np.asarray(toks).shape == (2, 2)
    log = tcli.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch",
                     "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                     str(tmp_path)])
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
    out = capsys.readouterr().out
    assert out.count("[serve] 2 requests x 2 tokens") == 2
    assert "with prepared weights" in out and "[train] loss" in out


def test_prepared_leaves_are_the_references():
    """Under ozaki1-p4+cached a session prepares exactly the reference's
    2-D leaves: the untied head and the unstacked MTP block's mixer
    projections and shared-expert FFN (prepare_params has no MoE
    exclusion), never wkv_b, the MTP proj or the router; the stacked
    layers are left alone (R4). The once-per-step preps cover the same
    mixer paths and the head plus the stacked layers' projections, per
    layer, and nothing under a MoE."""
    jparams, tparams = _params()
    jpol, tpol = _policies("ozaki1-p4+cached")
    jprep = jprepared.prepare_params(jparams, jpol)
    want = {_key(p) for p, v in jax.tree_util.tree_flatten_with_path(
        jprep, is_leaf=lambda x: hasattr(x, "slices"))[0]
        if hasattr(v, "slices")}
    got = {k for k, v in tree_flatten(
        prepared.prepare_params(tparams, tpol)).items()
        if isinstance(v, prepared.PreparedOperand)}
    assert got == want
    assert {"head", "mtp/block/mixer/wq_a", "mtp/block/mixer/wo",
            "mtp/block/moe/shared/wi_gate"} <= got
    assert not any(k.endswith(("wkv_b", "proj", "router"))
                   or k.startswith("layers/") for k in got)
    jsteps = jax.eval_shape(lambda p: jprepared.build_step_preps(p, jpol),
                            jparams)
    preps = prepared.build_step_preps(tparams, tpol)
    assert set(preps) == {k.replace("[", "").replace("]", "")
                          for k in jsteps}
    assert "layers/b0/mixer/wq_a" in preps and len(
        preps["layers/b0/mixer/wq_a"]) == 2
    assert not any("moe" in k or k.endswith("wkv_b") for k in preps)
