"""The port's whole-batch prefill and single-token decode path against the
reference (repro_torch.models.model.forward_prefill / forward_decode vs
repro.models.model's), on smoke configs from the same parameters
(repro_torch.convert): olmo-1b (tied head, MHA; native), granite-3-8b
(untied head, GQA; ozaki1-p4) and olmo-1b-emu's gemm_sites (Scheme I,
Scheme II on attn_qk).

Logits agree within 1e-4 * max|logits| and the caches' written rows
within 1e-5: the emulated GEMMs are bit-identical on equal inputs, and
what differs is float32 ulps of XLA's and torch's softmax, rope, norm
and native matmul, which the emulation carries forward. Greedy tokens
are equal, or differ only after a step where the reference's top-2
margin is under MARGIN. Then the engine, the steps and the CLI on that
path, and the Trainer's SIGTERM preemption checkpoint.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import api as japi, configs as jconfigs
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.serving.engine import LockstepEngine as JLockstep
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import make_batch_iterator
from repro_torch.launch import serve as tserve, steps as S
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.runtime import Trainer
from repro_torch.serving import LockstepEngine
from repro_torch.utils.tree import tree_flatten

B, PROMPT, GEN, MAX_SEQ = 2, 9, 3, 16
MARGIN = 1e-3


def _policies(arch_id, spec):
    """(reference, port) arch configs and policies: a spec, or the arch's
    own gemm_sites when ``spec`` is None."""
    jarch = jconfigs.get_smoke_config(arch_id)
    tarch = tconfigs.get_smoke_config(arch_id)
    if spec is None:
        return (jarch, tarch, jdispatch.resolve_policy(jarch.gemm_policy()),
                tarch.gemm_policy())
    return (jarch, tarch,
            jdispatch.resolve_policy(JPolicy(default=japi.precision(spec))),
            TPolicy(default=tapi.precision(spec)))


_PARAMS = {}


def _params(jarch, tarch):
    """The reference's seeded parameters and the port's copy of them,
    built once per model shape (olmo-1b-emu shares olmo-1b's)."""
    key = jarch.model.name.replace("-emu", "")
    if key not in _PARAMS:
        jparams = JM.init_params(jax.random.PRNGKey(0), jarch.model)
        tree = jax.tree.map(np.asarray, jparams)
        _PARAMS[key] = (jparams, convert.params_from_jax(
            tree, tarch.model, device="cpu"))
    return _PARAMS[key]


def _close(tl, jl):
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()


def _margin(logits, vocab) -> float:
    top2 = np.sort(np.asarray(logits)[..., :vocab].reshape(-1, vocab), -1)
    return float((top2[:, -1] - top2[:, -2]).min())


@pytest.mark.parametrize("arch_id,spec", [("olmo-1b", "native"),
                                          ("granite-3-8b", "ozaki1-p4"),
                                          ("olmo-1b-emu", None)])
def test_prefill_and_decode_match_reference(arch_id, spec):
    """forward_prefill's logits and cache, then every forward_decode step
    (fed the reference's greedy tokens) against the reference."""
    jarch, tarch, jpol, tpol = _policies(arch_id, spec)
    jparams, tparams = _params(jarch, tarch)
    m = jarch.model
    prompts = np.random.default_rng(1).integers(
        0, m.vocab, (B, PROMPT)).astype(np.int32)
    jpre = jax.jit(lambda p, x: JM.forward_prefill(p, m, {"tokens": x},
                                                   MAX_SEQ, jpol))
    jdec = jax.jit(lambda p, x, pos, c: JM.forward_decode(p, m, x, pos, c,
                                                          jpol))
    jl, jcache = jpre(jparams, jnp.asarray(prompts))
    tl, tcache = TM.forward_prefill(tparams, tarch.model,
                                    {"tokens": t(prompts)}, MAX_SEQ, tpol)
    _close(tl, jl)
    for i in range(GEN):
        pos = PROMPT + i
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tcache["layers"]["b0"][name][:, :, :pos].numpy(),
                np.asarray(jcache["layers"]["b0"][name])[:, :, :pos],
                atol=1e-5, rtol=1e-5)
        tok = np.asarray(jnp.argmax(jl[:, -1:, :m.vocab], -1), np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(tok), pos, jcache)
        tl, tcache = TM.forward_decode(tparams, tarch.model, t(tok), pos,
                                       tcache, tpol)
        _close(tl, jl)


@pytest.mark.parametrize("arch_id", ["olmo-1b", "granite-3-8b"])
def test_decode_matches_teacher_forcing(arch_id):
    """The port of tests/test_models.py::test_decode_matches_teacher_forcing:
    prefill S - 4 tokens, decode the last 4 through the cache, and every
    step's logits equal the training forward's at that position."""
    m = tconfigs.get_smoke_config(arch_id).model
    params = TM.init_params(m, seed=0, device="cpu")
    s = 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, m.vocab, (B, s)).astype(np.int32))
    with torch.no_grad():
        logits, _, _ = TM.forward_train(params, m, {"tokens": toks},
                                        remat=False)
        _, cache = TM.forward_prefill(params, m, {"tokens": toks[:, :s - 4]},
                                      s)
        for pos in range(s - 4, s):
            dl, cache = TM.forward_decode(params, m, toks[:, pos:pos + 1],
                                          pos, cache)
            np.testing.assert_allclose(dl[:, 0].numpy(),
                                       logits[:, pos].numpy(),
                                       rtol=1e-3, atol=2e-4)


def test_lockstep_engine_matches_reference_prepared_head():
    """LockstepEngine.generate on granite-3-8b under ozaki1-p4 with the
    untied head prepared once (both packages), against the reference's
    engine; prepared and unprepared tokens are equal in the port."""
    jarch, tarch, jpol, tpol = _policies("granite-3-8b", "ozaki1-p4")
    jparams, tparams = _params(jarch, tarch)
    m = jarch.model
    prompts = np.random.default_rng(3).integers(
        0, m.vocab, (B, PROMPT)).astype(np.int32)
    jeng = JLockstep(jarch, None, MAX_SEQ, jpol, params=jparams, prepare=True)
    assert hasattr(jeng.params["head"], "slices")
    jtoks = jeng.generate(prompts, GEN)
    eng = LockstepEngine(tarch, None, MAX_SEQ, tpol, params=tparams,
                         prepare=True, device="cpu")
    assert eng.prepared and hasattr(eng.params["head"], "slices")
    ttoks = eng.generate(prompts, GEN)
    assert ttoks.shape == jtoks.shape == (B, GEN)
    for lane in range(B):
        jt, tt = list(jtoks[lane]), list(ttoks[lane])
        if jt == tt:
            continue
        i = next(i for i, (x, y) in enumerate(zip(jt, tt)) if x != y)
        context = np.asarray([list(prompts[lane]) + jt[:i]], np.int32)
        logits, _ = JM.forward_prefill(jparams, m,
                                       {"tokens": jnp.asarray(context)},
                                       MAX_SEQ, jpol)
        assert _margin(logits, m.vocab) < MARGIN, (lane, jt, tt)
    plain = LockstepEngine(tarch, None, MAX_SEQ, tpol, params=tparams,
                           device="cpu")
    assert not plain.prepared
    np.testing.assert_array_equal(plain.generate(prompts, GEN), ttoks)


def test_prefill_and_decode_steps():
    """make_prefill_step / make_decode_step on one card (mesh None) are
    forward_prefill / forward_decode under the arch's policy; a mesh
    raises naming the multi-device item; an encoder's prefill step is a
    plain forward (forward_train's logits), as the reference's."""
    arch = tconfigs.get_smoke_config("granite-3-8b")
    shape = ShapeSpec("smoke", MAX_SEQ, B, "prefill")
    policy = TPolicy(default=tapi.precision("ozaki1-p4"))
    params = TM.init_params(arch.model, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, arch.model.vocab, (B, PROMPT)).astype(np.int32))
    prefill = S.make_prefill_step(arch, shape, None, policy)
    decode = S.make_decode_step(arch, shape, policy=policy)
    logits, cache = prefill(params, {"tokens": toks})
    ref, ref_cache = TM.forward_prefill(params, arch.model, {"tokens": toks},
                                        MAX_SEQ, policy)
    assert torch.equal(logits, ref)
    tok = torch.argmax(logits[:, :, :arch.model.vocab], -1).to(torch.int32)
    out, cache = decode(params, cache, tok, PROMPT)
    ref, _ = TM.forward_decode(params, arch.model, tok, PROMPT, ref_cache,
                               policy)
    assert torch.equal(out, ref)
    assert out.shape == (B, 1, 512)
    # The one-device mesh (no process group) runs the same steps.
    from repro_torch.launch.mesh import make_host_mesh
    one, _ = S.make_prefill_step(arch, shape, make_host_mesh(), policy)(
        params, {"tokens": toks})
    assert torch.equal(one, logits)
    import dataclasses
    enc = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, causal=False))
    want, _, _ = TM.forward_train(params, enc.model, {"tokens": toks},
                                  policy, remat=False)
    got = S.make_prefill_step(enc, shape, None, policy)(params,
                                                        {"tokens": toks})
    assert torch.equal(got, want) and got.shape == (B, PROMPT, 512)


def test_serve_cli_lockstep_in_process(capsys):
    """``--lockstep`` runs the whole-batch engine on the CPU; the legacy
    name ServeEngine is that engine."""
    assert tserve.ServeEngine is LockstepEngine
    argv = ["--arch", "granite-3-8b", "--smoke", "--lockstep", "--device",
            "cpu", "--gemm", "ozaki1-p4+cached", "--prepare", "--requests",
            "2", "--prompt-len", "6", "--gen", "3"]
    toks = tserve.main(argv)
    assert np.asarray(toks).shape == (2, 3)
    out = capsys.readouterr().out
    assert "2 requests x 3 tokens" in out and "prepared weights" in out
    # The same prompts and spec unprepared give the same tokens.
    assert tserve.main(argv[:-7] + argv[-6:]) == toks


def _trainer(ckpt_dir, hook=None, **kw):
    arch = tconfigs.get_smoke_config("olmo-1b")
    shape = ShapeSpec("smoke", 16, 2, "train")
    step = S.make_train_step(arch)
    calls = {"n": 0}

    def step_fn(state, batch):
        out = step(state, batch)
        if hook is not None:
            hook(calls["n"])
        calls["n"] += 1
        return out

    return Trainer(step_fn=step_fn,
                   init_state_fn=lambda: S.init_state(arch, 0, "cpu"),
                   batch_iterator=make_batch_iterator(arch, shape, 0),
                   ckpt_dir=str(ckpt_dir), device="cpu", ckpt_every=100,
                   **kw)


def _state_bits(state):
    return {k: v.clone() for k, v in tree_flatten(state).items()
            if isinstance(v, torch.Tensor)}


def test_sigterm_checkpoints_the_step_and_resumes_bit_exact(tmp_path):
    """With handle_sigterm a SIGTERM raised inside step 1 lets the step
    finish, checkpoints it and returns; a new Trainer resumes from it and
    ends in the uninterrupted run's state, bit for bit."""
    full = _trainer(tmp_path / "full")
    full.run(4)
    full.close()
    want = _state_bits(full.state)

    before = signal.getsignal(signal.SIGTERM)
    tr = None
    try:
        def hook(i):
            if i == 1:
                assert signal.getsignal(signal.SIGTERM) == tr._on_sigterm
                signal.raise_signal(signal.SIGTERM)

        tr = _trainer(tmp_path / "pre", hook, handle_sigterm=True)
        log = tr.run(4)
        assert [m["step"] for m in log] == [0, 1]
        assert tr.ckpt.latest_step() == 1
        tr.close()
        assert signal.getsignal(signal.SIGTERM) == before
    finally:
        signal.signal(signal.SIGTERM, before)
    resumed = _trainer(tmp_path / "pre")
    assert resumed.start_step == 2
    resumed.run(2)
    resumed.close()
    got = _state_bits(resumed.state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
