"""internvl2-1b (a decoder behind the vision stub) and hubert-xlarge (a
bidirectional encoder behind the audio stub) against the reference on
their smoke configs, from the same parameters (repro_torch.convert): the
configurations, the layout with ``frontend_proj``, the pipeline's stub
batches, the front ends, the training forward's logits, the encoder's
prefill step (a plain forward), internvl2's prefill with image
embeddings then decodes (and the audio stub's decode branch), the
lockstep engine on text prompts, the prepared leaves, the continuous
engine's refusal, the serve CLI's encoder exit, and the encoder's loss
and gradients.

Logits agree within 1e-4 * max|logits| (float32 ulps of XLA's and
torch's softmax, norm, rope and native matmul; the emulated GEMMs are
the same bits on equal operands); the pipeline's batches and the
converted parameters are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import api as japi, configs as jconfigs
from repro.configs.base import ShapeSpec as JShape
from repro.data import make_batch_iterator as jbatches
from repro.kernels import dispatch as jdispatch, prepared as jprepared
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import prepared
from repro_torch.launch import serve as tserve, steps as S
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.serving import ContinuousEngine, LockstepEngine
from repro_torch.utils.tree import tree_flatten

ARCHS = ("internvl2-1b", "hubert-xlarge")
VLM, AUDIO = ARCHS
B, SEQ, MAX_SEQ = 2, 24, 32
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


def _batch(arch_id, step=0):
    """The reference's and the port's pipeline batch of ``step``."""
    shape = (SEQ, B, "train")
    jit = jbatches(jconfigs.get_smoke_config(arch_id), JShape("s", *shape), 0)
    tit = make_batch_iterator(tconfigs.get_smoke_config(arch_id),
                              ShapeSpec("s", *shape), 0)
    for _ in range(step + 1):
        (_, jb), (_, tb) = next(jit), next(tit)
    return jb, tb


@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_and_layout_are_the_references(arch_id):
    for get in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(tconfigs, get)(arch_id))
                == dataclasses.asdict(getattr(jconfigs, get)(arch_id)))
    jparams, tree, tparams = _params(arch_id)
    m = tconfigs.get_smoke_config(arch_id).model
    ours = TM.init_params(m, seed=0, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), ours) == jax.tree.map(
        lambda x: tuple(np.shape(x)), tree)
    assert TM.param_count(ours) == JM.param_count(jparams)
    assert ours["frontend_proj"].shape == (m.frontend_dim, m.d_model)
    ref = {_key(p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat = tree_flatten(tparams)
    assert flat.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_pipeline_stub_batches_are_the_references(arch_id):
    """Step 1's batch (the stub stream is drawn once a run): audio frames
    (B, S, F) float32 in place of ids, or ids plus (B, n, F) image
    embeddings, equal to the reference's."""
    jb, tb = _batch(arch_id, step=1)
    assert jb.keys() == tb.keys()
    for k in jb:
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    m = tconfigs.get_smoke_config(arch_id).model
    if arch_id == AUDIO:
        assert tb["tokens"].shape == (B, SEQ, m.frontend_dim)
    else:
        assert tb["image_embeds"].shape == (B, m.n_image_tokens,
                                            m.frontend_dim)


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_front_end_and_forward_logits_match_reference(arch_id, spec):
    """The front end's embeddings (image tokens written over the first
    positions; frames projected) and the training forward's logits;
    hubert attends bidirectionally, without RoPE. The encoder's prefill
    step is that forward."""
    jparams, _, tparams = _params(arch_id)
    jm = jconfigs.get_smoke_config(arch_id).model
    tarch = tconfigs.get_smoke_config(arch_id)
    jpol, tpol = _policies(spec)
    jb, tb = _batch(arch_id)
    jin = {k: jnp.asarray(v) for k, v in jb.items() if k != "labels"}
    tin = {k: t(v) for k, v in tb.items() if k != "labels"}

    def ref(p, inputs):
        return (JM.embed_inputs(p, jm, inputs)[0],
                JM.forward_train(p, jm, inputs, jpol, remat=False)[0])

    jx, jl = jax.jit(ref)(jparams, jin)
    tx, tpos = TM.embed_inputs(tparams, tarch.model, tin)
    _close(tx, jx, 1e-6)
    assert tpos.shape == (B, SEQ) and tpos.dtype == torch.int32
    tl, _, _ = TM.forward_train(tparams, tarch.model, tin, tpol)
    _close(tl, jl)
    if arch_id == AUDIO:
        assert not tarch.model.causal
        step = S.make_prefill_step(tarch, ShapeSpec("s", SEQ, B, "prefill"),
                                   None, tpol)
        assert torch.equal(step(tparams, tin), tl)


def test_vlm_prefill_with_image_then_decode_match_reference():
    """internvl2-1b: a prefill step on a pipeline batch with its image
    embeddings, then 3 decode steps, against the reference's prefill /
    decode; then the lockstep engine on text prompts, token for token."""
    jparams, _, tparams = _params(VLM)
    jarch = jconfigs.get_smoke_config(VLM)
    tarch = tconfigs.get_smoke_config(VLM)
    jpol, tpol = _policies("native")
    jb, tb = _batch(VLM)
    jin = {k: jnp.asarray(v) for k, v in jb.items() if k != "labels"}
    tin = {k: t(v) for k, v in tb.items() if k != "labels"}
    shape = ShapeSpec("s", MAX_SEQ, B, "prefill")
    prefill = S.make_prefill_step(tarch, shape, None, tpol)
    decode = S.make_decode_step(tarch, shape, None, tpol)
    jpre = jax.jit(lambda p, x: JM.forward_prefill(p, jarch.model, x,
                                                   MAX_SEQ, jpol))
    jdec = jax.jit(lambda p, tok, pos, c: JM.forward_decode(
        p, jarch.model, tok, pos, c, jpol))
    jl, jc = jpre(jparams, jin)
    tl, tc = prefill(tparams, tin)
    _close(tl, jl)
    for i in range(3):
        tok = jnp.argmax(jl[:, -1:, :jarch.model.vocab], axis=-1)
        jl, jc = jdec(jparams, tok, SEQ + i, jc)
        tl, tc = decode(tparams, tc, t(np.asarray(tok)), SEQ + i)
        _close(tl, jl)
    prompts = tb["tokens"][:, :10]
    from repro.serving.engine import LockstepEngine as JLockstep
    jt = JLockstep(jarch, None, 16, jpol, params=jparams).generate(prompts, 4)
    tt = LockstepEngine(tarch, None, 16, tpol, params=tparams,
                        device="cpu").generate(prompts, 4)
    np.testing.assert_array_equal(tt, np.asarray(jt))


def test_audio_decode_branch_matches_reference():
    """forward_decode's audio branch projects (B, 1, F) frames, after a
    prefill of frames, as the reference's does."""
    jparams, _, tparams = _params(AUDIO)
    jm = jconfigs.get_smoke_config(AUDIO).model
    tm = tconfigs.get_smoke_config(AUDIO).model
    jpol, tpol = _policies("native")
    frames = np.random.default_rng(3).standard_normal(
        (B, 9, jm.frontend_dim)).astype(np.float32)

    def ref(p, f):
        _, c = JM.forward_prefill(p, jm, {"tokens": f[:, :8]}, 16, jpol)
        return JM.forward_decode(p, jm, f[:, 8:], 8, c, jpol)[0]

    jl = jax.jit(ref)(jparams, jnp.asarray(frames))
    _, c = TM.forward_prefill(tparams, tm, {"tokens": t(frames[:, :8])}, 16,
                              tpol)
    tl, _ = TM.forward_decode(tparams, tm, t(frames[:, 8:]), 8, c, tpol)
    _close(tl, jl)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prepared_leaves_are_the_references(arch_id):
    """Under ozaki1-p4+cached a session prepares the untied head only
    (the blocks are stacked), never ``frontend_proj``."""
    jparams, _, tparams = _params(arch_id)
    jpol, tpol = _policies("ozaki1-p4+cached")
    jprep = jprepared.prepare_params(jparams, jpol)
    want = {_key(p) for p, v in jax.tree_util.tree_flatten_with_path(
        jprep, is_leaf=lambda x: hasattr(x, "slices"))[0]
        if hasattr(v, "slices")}
    got = {k for k, v in tree_flatten(prepared.prepare_params(
        tparams, tpol)).items() if isinstance(v, prepared.PreparedOperand)}
    assert got == want == {"head"}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_continuous_engine_refuses_stub_front_ends(arch_id):
    _, _, tparams = _params(arch_id)
    with pytest.raises(NotImplementedError, match="stub frontends"):
        ContinuousEngine(tconfigs.get_smoke_config(arch_id), max_seq=16,
                         params=tparams, device="cpu")


def test_serve_cli_exits_for_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", AUDIO, "--smoke", "--lockstep", "--device",
                     "cpu"])


def test_encoder_loss_and_gradients_match_reference():
    """hubert-xlarge's loss on a pipeline batch of frames and every
    gradient leaf within 1e-4 relative L2 of the reference's; the token
    embedding, which the audio stub never reads, gets zeros as in JAX
    (``steps.value_and_grad`` once raised for an unused leaf)."""
    from repro.launch import steps as JS
    jparams, _, tparams = _params(AUDIO)
    jarch = jconfigs.get_smoke_config(AUDIO)
    jarch = dataclasses.replace(jarch, train=dataclasses.replace(
        jarch.train, remat=False))
    tarch = tconfigs.get_smoke_config(AUDIO)
    jpol, tpol = _policies("native")
    jb, tb = _batch(AUDIO)
    jl, jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jarch, jpol)))(
        jparams, {k: jnp.asarray(v) for k, v in jb.items()})
    tl, tg = S.value_and_grad(S.make_loss_fn(tarch, tpol), tparams,
                              S.batch_to(tb, "cpu"))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = {_key(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    tflat = tree_flatten(tg)
    assert sorted(tflat) == sorted(jflat)
    # The key bias's gradient is zero but for rounding (a softmax row is
    # invariant to a shift of all its scores): such a leaf is held
    # against 1e-3 of the largest leaf's norm instead of its own.
    floor = 1e-3 * max(np.linalg.norm(v) for v in jflat.values())
    for k, g in tflat.items():
        r = jflat[k]
        rel = np.linalg.norm(g.numpy() - r) / max(np.linalg.norm(r), floor)
        assert rel <= 1e-4, (k, rel)
    assert not tflat["emb"].any() and tflat["frontend_proj"].abs().sum() > 0
