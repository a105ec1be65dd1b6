"""recurrentgemma-2b (RG-LRU + local attention, (rec, rec, attn) groups
and a (rec, rec) tail) and mamba2-780m (Mamba-2 SSD blocks) against the
reference on their smoke configs, from the same parameters
(repro_torch.convert): the configurations, the grouped parameter layout
and count, the conversion (float32 leaves in a bf16 tree), the training
forward's logits under 'native' and 'ozaki1-p4', one gradient, a
40-token prompt past recurrentgemma's 32-token window (the ring rotates)
and 10 decodes (the ring wraps) in the lockstep engine, its greedy
tokens, the continuous engine's refusal, and the set of leaves that a
'+cached' session prepares.

Logits agree within 1e-4 * max|logits| (float32 ulps of XLA's and
torch's scans, norms and native matmuls, carried through the layers;
the emulated GEMMs are the same bits on equal operands), gradients
within 1e-4 relative L2. Greedy tokens are equal, or differ only after
a step where the reference's top-2 margin is under MARGIN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import api as japi, configs as jconfigs
from repro.kernels import dispatch as jdispatch, prepared as jprepared
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.serving.engine import LockstepEngine as JLockstep
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.kernels import prepared
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.serving import ContinuousEngine, LockstepEngine
from repro_torch.utils.tree import tree_flatten

ARCHS = ("recurrentgemma-2b", "mamba2-780m")
B, PROMPT, GEN = 2, 40, 11         # 40 > recurrentgemma's window of 32
MAX_SEQ = PROMPT + GEN
MARGIN = 1e-3
_PARAMS = {}


def _params(arch_id):
    if arch_id not in _PARAMS:
        jarch = jconfigs.get_smoke_config(arch_id)
        jparams = jax.jit(JM.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jarch.model)
        tree = jax.tree.map(np.asarray, jparams)
        _PARAMS[arch_id] = (jparams, tree, convert.params_from_jax(
            tree, tconfigs.get_smoke_config(arch_id).model, device="cpu"))
    return _PARAMS[arch_id]


def _policies(spec):
    return (jdispatch.resolve_policy(JPolicy(default=japi.precision(spec))),
            TPolicy(default=tapi.precision(spec)))


def _close(tl, jl, tol=1e-4):
    jl = np.asarray(jl)
    tl = tl.detach().numpy() if isinstance(tl, torch.Tensor) else tl
    assert tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= tol * np.abs(jl).max()


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_are_the_references(arch_id):
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tconfigs, get)(arch_id))
                == dataclasses.asdict(getattr(jconfigs, get)(arch_id)))
    assert arch_id in tconfigs.ARCH_IDS


@pytest.mark.parametrize("arch_id", ARCHS)
def test_params_layout_count_and_convert(arch_id):
    """The grouped layout (layers/b0..b{k-1} stacked on n_groups, a tail
    list) and its count; the converted tree equals the reference's leaf
    by leaf; in a bf16 model the recurrent blocks' float32 leaves stay
    float32."""
    jparams, tree, tparams = _params(arch_id)
    jm = jconfigs.get_smoke_config(arch_id).model
    m = tconfigs.get_smoke_config(arch_id).model
    ours = TM.init_params(m, seed=0, device="cpu")
    jbf = jax.eval_shape(lambda: JM.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(jm, dtype="bfloat16")))
    assert jax.tree.map(lambda x: tuple(x.shape), ours) == jax.tree.map(
        lambda x: tuple(x.shape), jbf)
    assert TM.param_count(ours) == JM.param_count(jparams)
    ref = {_key(p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat = tree_flatten(tparams)
    assert flat.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)
    bf = dataclasses.replace(m, dtype="bfloat16")
    want = {_key(p): "torch." + str(v.dtype)
            for p, v in jax.tree_util.tree_flatten_with_path(jbf)[0]}
    got = {k: str(v.dtype) for k, v in
           tree_flatten(TM.init_params(bf, seed=0, device="cpu")).items()}
    assert got == want
    assert "torch.float32" in got.values()
    if arch_id == "recurrentgemma-2b":
        assert sorted(ours["layers"]) == ["b0", "b1", "b2"]
        assert len(ours["tail"]) == 2 and "lam" in ours["tail"][1]["mixer"]
        assert ours["layers"]["b2"]["mixer"]["wq"].shape[0] == 1


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_forward_train_logits_match_reference(arch_id, spec):
    jparams, _, tparams = _params(arch_id)
    jm = jconfigs.get_smoke_config(arch_id).model
    tm = tconfigs.get_smoke_config(arch_id).model
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(0).integers(0, jm.vocab, (B, 37)).astype(
        np.int32)
    jl = jax.jit(lambda p, x: JM.forward_train(p, jm, {"tokens": x}, jpol,
                                               remat=False)[0])(
        jparams, jnp.asarray(toks))
    tl, _, _ = TM.forward_train(tparams, tm, {"tokens": t(toks)}, tpol)
    _close(tl, jl)


def test_recurrentgemma_gradient_matches_reference():
    """The loss and every gradient leaf (groups and tail, the float32
    ``lam`` among them) under 'native', remat on the port's side."""
    arch_id = "recurrentgemma-2b"
    jparams, _, tparams = _params(arch_id)
    jarch = jconfigs.get_smoke_config(arch_id)
    jarch = dataclasses.replace(jarch, train=dataclasses.replace(
        jarch.train, remat=False))
    tarch = tconfigs.get_smoke_config(arch_id)
    jpol, tpol = _policies("native")
    seq = np.random.default_rng(1).integers(0, 500, (B, 41)).astype(np.int32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jarch, jpol)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = TS.value_and_grad(TS.make_loss_fn(tarch, tpol), tparams,
                               TS.batch_to(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = {_key(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    tflat = tree_flatten(tg)
    assert sorted(tflat) == sorted(jflat)
    for k, g in tflat.items():
        r = jflat[k]
        rel = np.linalg.norm(g.numpy() - r) / max(np.linalg.norm(r), 1e-30)
        assert rel <= 1e-4, (k, rel)
    assert np.linalg.norm(jflat["tail/1/mixer/lam"]) > 0


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_decode_and_lockstep_tokens_match_reference(arch_id):
    """A 40-token prompt (past recurrentgemma's 32-token window: the
    prefill keeps a rotated ring) and 10 decodes (the ring wraps), fed
    the reference's greedy tokens: logits at every step and the final
    cache within the bars; then both engines' greedy tokens."""
    jparams, _, tparams = _params(arch_id)
    jarch = jconfigs.get_smoke_config(arch_id)
    tarch = tconfigs.get_smoke_config(arch_id)
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
    jflat = {_key(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    tflat = tree_flatten(tcache)
    assert tflat.keys() == jflat.keys()
    for k, v in jflat.items():
        _close(tflat[k], v, 1e-4)
    if arch_id == "recurrentgemma-2b":
        assert tflat["layers/b2/k"].shape[2] == 32       # the ring
    jt = np.asarray(jeng.generate(prompts, GEN))
    tt = LockstepEngine(tarch, None, MAX_SEQ, tpol, params=tparams,
                        device="cpu").generate(prompts, GEN)
    assert tt.shape == jt.shape == (B, GEN)
    for lane in range(B):
        diff = np.nonzero(tt[lane] != jt[lane])[0]
        if len(diff):
            assert min(margins[:diff[0] + 1]) < MARGIN, (lane, diff)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_continuous_engine_refuses_lane_bound_caches(arch_id):
    _, _, tparams = _params(arch_id)
    with pytest.raises(NotImplementedError, match="lane-bound"):
        ContinuousEngine(tconfigs.get_smoke_config(arch_id), max_seq=16,
                         params=tparams, device="cpu")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prepared_leaves_are_the_references(arch_id):
    """Under ozaki1-p4+cached a session prepares exactly the reference's
    2-D leaves: recurrentgemma-2b's tail projections (w_y, w_gate, w_out,
    the FFN's) and its untied head, never w_r / w_i; nothing of
    mamba2-780m (stacked blocks, tied head). The once-per-step preps
    cover the same paths plus the stacked groups, per group."""
    jparams, _, tparams = _params(arch_id)
    jpol, tpol = _policies("ozaki1-p4+cached")
    jprep = jprepared.prepare_params(jparams, jpol)
    want = {_key(p) for p, v in jax.tree_util.tree_flatten_with_path(
        jprep, is_leaf=lambda x: hasattr(x, "slices"))[0]
        if hasattr(v, "slices")}
    ours = prepared.prepare_params(tparams, tpol)
    got = {k for k, v in tree_flatten(ours).items()
           if isinstance(v, prepared.PreparedOperand)}
    assert got == want
    if arch_id == "recurrentgemma-2b":
        assert "head" in got and "tail/0/mixer/w_y" in got
        assert not any(k.endswith(("w_r", "w_i")) for k in got)
        assert len(got) == 1 + 2 * 6
    else:
        assert got == set()
    jsteps = jax.eval_shape(lambda p: jprepared.build_step_preps(p, jpol),
                            jparams)
    preps = prepared.build_step_preps(tparams, tpol)
    assert set(preps) == {k.replace("[", "").replace("]", "")
                          for k in jsteps}
    n_groups = 1 if arch_id == "recurrentgemma-2b" else 3
    assert all(len(v) == n_groups for k, v in preps.items()
               if k.startswith("layers/"))


def test_serve_cli_lockstep_runs_the_recurrent_archs(capsys):
    """``--lockstep`` serves both on the CPU (the prompt past
    recurrentgemma's window; mamba2's tied head left unprepared under
    '+cached'); the continuous engine's refusal reaches the CLI."""
    from repro_torch.launch import serve as tserve
    for arch_id in ARCHS:
        toks = tserve.main(["--arch", arch_id, "--smoke", "--lockstep",
                            "--device", "cpu", "--gemm", "ozaki1-p4+cached",
                            "--prepare", "--requests", "2", "--prompt-len",
                            "36", "--gen", "3"])
        assert np.asarray(toks).shape == (2, 3)
    assert capsys.readouterr().out.count("2 requests x 3 tokens") == 2
    with pytest.raises(NotImplementedError, match="lane-bound"):
        tserve.main(["--arch", ARCHS[1], "--smoke", "--device", "cpu"])
