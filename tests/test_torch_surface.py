"""The port's public call forms against the reference's.

``test_signatures_match_the_reference`` walks every module of
``repro_torch`` that has a counterpart in ``repro`` and compares
``inspect.signature`` of each public function and class (and each public
method of a class) defined there with the reference's of the same name:
the positional parameters must match in name, order and kind, the
keyword-only ones as a set, and a parameter the reference gives a default
must have one in the port. What the port leaves out or adds on purpose is
written below, by category and with its reason (a left-out parameter that
the port still takes, such as ``mesh=None``, must then be None); anything
else fails.

Then one behavioural check per repaired call form: that the reference's
form runs in the port and does what the keyword form does.
"""

import dataclasses
import importlib
import inspect
import os
import pkgutil
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import api as tapi, configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import scheme1
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import dispatch, prepared
from repro_torch.launch import steps as S
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy, rope_frequencies
from repro_torch.runtime import Trainer
from repro_torch.serving import LockstepEngine
from repro_torch.utils.tree import tree_flatten, tree_map

# Parameters the port leaves out everywhere, by category.
MESH_AND_HOST = {   # one card, one host (ROADMAP.md § 1 item 8)
    "mesh", "mesh_shape", "shardings", "state_shardings", "host", "n_hosts",
    "sp"}
GUARD_AND_TELEMETRY: set[str] = set()   # ported: nothing left out
PALLAS_BLOCKS = {   # the CUDA kernels choose their own tiles (§ 3)
    "blocks", "bm", "bn", "bk", "bt", "prologue_a", "prologue_b", "fixed_bk",
    "m_hint", "align", "staging_budget", "accumulator_budget",
    "shardable", "batched", "p_eff", "out_bytes"}
JAX_KEY = {"key"}   # a torch.Generator or an int seed instead (§ 3)
OMITTED = MESH_AND_HOST | GUARD_AND_TELEMETRY | PALLAS_BLOCKS | JAX_KEY
# Parameters only the port has: where tensors go, and what replaces a key.
ADDED = {"device", "gen", "seed", "lead"}

# Deviations of one function, class or method, with their reasons.
SPECIFIC = {
    "kernels.dispatch.GemmPlan":
        "the scheme lives on cfg (the reference's tile planning is gone)",
    "kernels.dispatch.select_blocks":
        "batch before scheme: the port's block cache key order",
    "kernels.dispatch.emulated_matmul_batched":
        "the reference forwards **kw to emulated_matmul; the port names "
        "them (cfg, out_dtype, backend)",
    "kernels.ozaki1.fused_matmul_mixed":
        "the prepared rhs is the 'planes' layout (b_planes)",
    "kernels.prepared.PreparedOperand":
        "records the backend that prepared it (the layout it consumes)",
    "core.scheme2.mixed_radix_to_dd":
        "the double-double's type follows the output (ROADMAP.md § 3 H6)",
    "models.attention.attention_prefill":
        "writes into the caller's cache instead of allocating max_seq",
    "models.blocks.block_prefill":
        "writes into the caller's cache instead of allocating max_seq",
    "models.mla.mla_prefill":
        "writes into the caller's cache instead of allocating max_seq",
    "models.attention.init_attention": "dtype and device from the caller",
    "models.attention.init_cache": "dtype and device from the caller",
    "models.common.init_ffn": "dtype and device from the caller",
    "models.common.init_norm": "dtype and device from the caller",
    "models.common.emb_init": "dtype and device from the caller",
    "models.common.he_init": "dtype and device from the caller",
    "models.moe.init_moe": "dtype and device from the caller",
    "telemetry.record.record_gemm":
        "in_bytes, the operands' element size, for the per-site bounds of "
        "utils.perf_probe (its observers)",
    "utils.perf_probe.attribute":
        "attributes a profiled eager step (prof), not compiled HLO text",
    "utils.perf_probe.attribute_emulation":
        "a profiled eager step and telemetry's calls of it, not HLO text",
    "utils.perf_probe.main": "argv, so that a caller can run the CLI",
}

# Modules of the port with no counterpart in the reference.
PORT_ONLY = {"repro_torch.convert", "repro_torch.kernels.backends.cuda",
             "repro_torch.kernels.backends.reference",
             "repro_torch.kernels.build", "repro_torch.utils.tree"}


def _reference_module(name: str):
    """The reference's module, imported with the environment kept: its
    ``utils.perf_probe`` sets XLA_FLAGS to 512 host devices at import,
    which must not reach this process's jax (initialised first) or the
    subprocesses of later tests."""
    import jax
    jax.devices()
    env = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if env is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = env


def _pairs():
    """(qualified name without the package, port object, reference
    object) of every public function, class and class method."""
    missing = set()
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        tm = importlib.import_module(info.name)
        try:
            rm = _reference_module("repro" + info.name[11:])
        except ModuleNotFoundError:
            missing.add(info.name)
            continue
        short = info.name[12:]
        for attr, tv in sorted(vars(tm).items()):
            rv = getattr(rm, attr, None)
            if (attr.startswith("_") or getattr(tv, "__module__", None)
                    != info.name or not (inspect.isfunction(tv)
                                         or inspect.isclass(tv))
                    or not (inspect.isfunction(rv) or inspect.isclass(rv))):
                continue
            yield f"{short}.{attr}", tv, rv
            if not inspect.isclass(tv):
                continue
            for meth in sorted(vars(tv)):
                tf = inspect.getattr_static(tv, meth)
                rf = inspect.getattr_static(rv, meth, None)
                tf, rf = (getattr(f, "__func__", f) for f in (tf, rf))
                if (not meth.startswith("_") and inspect.isfunction(tf)
                        and inspect.isfunction(rf)):
                    yield f"{short}.{attr}.{meth}", tf, rf
    assert missing == PORT_ONLY


def _mismatch(port, ref) -> str | None:
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD)
    sigs = []
    for fn in (port, ref):
        try:
            sigs.append(inspect.signature(fn))
        except ValueError:          # a builtin's, e.g. an exception class
            sigs.append(None)
    if sigs[0] is None or sigs[1] is None:
        return None if sigs[0] is sigs[1] else "one has no signature"
    added = ADDED - set(sigs[1].parameters)
    tp = [p for p in sigs[0].parameters.values()
          if p.name not in added | OMITTED]
    rp = [p for p in sigs[1].parameters.values() if p.name not in OMITTED]
    pos_t = [p.name for p in tp if p.kind in kinds]
    pos_r = [p.name for p in rp if p.kind in kinds]
    if pos_t != pos_r:
        return f"positional {pos_t} != {pos_r}"
    kw_t = {p.name for p in tp if p.kind == inspect.Parameter.KEYWORD_ONLY}
    kw_r = {p.name for p in rp if p.kind == inspect.Parameter.KEYWORD_ONLY}
    if kw_t != kw_r:
        return f"keyword-only {sorted(kw_t ^ kw_r)}"
    port_params = {p.name: p for p in tp}
    for p in rp:
        if p.kind in (inspect.Parameter.VAR_POSITIONAL,
                      inspect.Parameter.VAR_KEYWORD):
            if port_params.get(p.name, p).kind != p.kind:
                return f"no *{p.name}"
            continue
        if (p.default is not inspect.Parameter.empty
                and port_params[p.name].default is inspect.Parameter.empty):
            return f"{p.name} has no default"
    return None


def test_signatures_match_the_reference():
    bad = {}
    seen = set()
    for name, tv, rv in _pairs():
        seen.add(name)
        why = _mismatch(tv, rv)
        if why is not None and name not in SPECIFIC:
            bad[name] = why
    assert not bad, bad
    # MLA and Adafactor (deepseek-v3-671b's modules) are among the pairs.
    assert {f"models.mla.{f}" for f in (
        "init_mla", "init_mla_cache", "mla_train", "mla_prefill", "mla_step",
        "mla_decode")} | {"optim.optimizers.adafactor_init",
                          "optim.optimizers.adafactor_update"} <= seen
    # So are the guard and the telemetry (ROADMAP.md § 1 items 5 and 6).
    assert {"guard.verify.verify_gemm", "guard.ladder.guarded_call",
            "guard.inject.inject", "guard.policy.stats",
            "telemetry.record.record_gemm", "telemetry.steps.StepTracker",
            "telemetry.registry.MetricsRegistry.once",
            "runtime.trainer.GuardMonitor.observe"} <= seen
    # Every allowlisted deviation is still one (no stale entries).
    assert set(SPECIFIC) <= seen, sorted(set(SPECIFIC) - seen)
    stale = [n for n, tv, rv in _pairs() if n in SPECIFIC
             and _mismatch(tv, rv) is None]
    assert not stale, stale


# ---------------------------------------------------------------------------
# The repaired call forms.
# ---------------------------------------------------------------------------

ARCH = "olmo-1b"


def _state(arch):
    return S.init_state(arch, 0, "cpu")


def test_make_train_step_takes_the_reference_form():
    """make_train_step(arch, mesh, shape, policy, donate) builds the step
    the keyword form builds: the same new state and metrics."""
    arch = tconfigs.get_smoke_config(ARCH)
    shape = ShapeSpec("smoke", 16, 2, "train")
    policy = GemmPolicy(default=tapi.precision("ozaki1-p3"))
    _, batch = next(make_batch_iterator(arch, shape, 0))
    outs = [S.make_train_step(arch, None, shape, policy, donate=False)(
        _state(arch), batch),
        S.make_train_step(arch, policy=policy)(_state(arch), batch)]
    (s0, m0), (s1, m1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    for k, v in tree_flatten(s0).items():
        assert torch.equal(v, tree_flatten(s1)[k]), k


def test_decode_step_and_generate_take_the_reference_form():
    """make_decode_step(..., donate=False) and LockstepEngine.generate(
    prompts, n, greedy=True) run as their keyword forms do."""
    arch = tconfigs.get_smoke_config(ARCH)
    shape = ShapeSpec("smoke", 16, 2, "prefill")
    policy = GemmPolicy(default=tapi.precision("ozaki1-p3"))
    params = TM.init_params(arch.model, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, arch.model.vocab, (2, 5)).astype(np.int32))
    logits, cache = S.make_prefill_step(arch, shape, None, policy)(
        params, {"tokens": toks})
    tok = torch.argmax(logits[:, :, :arch.model.vocab], -1).to(torch.int32)
    ref, _ = TM.forward_decode(params, arch.model, tok, 5,
                               tree_map(torch.clone, cache), policy)
    out, _ = S.make_decode_step(arch, shape, None, policy, donate=False)(
        params, cache, tok, 5)
    assert torch.equal(out, ref)
    eng = LockstepEngine(arch, None, 16, policy, params=params, device="cpu")
    np.testing.assert_array_equal(eng.generate(toks.numpy(), 3, greedy=True),
                                  eng.generate(toks.numpy(), 3))


def test_trainer_keep_and_log_every(tmp_path, capsys):
    """Trainer(keep=1) keeps one checkpoint; log_every=2 prints steps 0
    and 2 of three."""
    arch = tconfigs.get_smoke_config(ARCH)
    shape = ShapeSpec("smoke", 16, 2, "train")
    tr = Trainer(step_fn=S.make_train_step(arch),
                 init_state_fn=lambda: _state(arch),
                 batch_iterator=make_batch_iterator(arch, shape, 0),
                 ckpt_dir=str(tmp_path), device="cpu", ckpt_every=1, keep=1,
                 log_every=2)
    tr.run(3)
    tr.close()
    assert tr.ckpt.all_steps() == [2] and tr.ckpt.keep == 1
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("[trainer] step")]
    assert [line.split()[2] for line in printed] == ["0", "2"]


def test_checkpoint_async_save_and_restore_like(tmp_path):
    """CheckpointManager(async_save=False) publishes before save returns;
    restore(step, like) checks the structure and takes like's devices;
    a shardings argument raises."""
    state = {"w": torch.arange(6.0).reshape(2, 3), "opt": [torch.ones(2)]}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(4, state)
    assert mgr._thread is None and mgr.all_steps() == [4]
    got = mgr.restore(4, state)
    assert torch.equal(got["w"], state["w"]) and got["opt"][0].device.type \
        == "cpu"
    assert torch.equal(mgr.restore(4)["opt"][0], state["opt"][0])
    with pytest.raises(ValueError):
        mgr.restore(4, {"w": state["w"]})
    with pytest.raises(NotImplementedError, match="item 8"):
        mgr.restore(4, state, shardings={"w": None})


def test_prepared_site_default_and_names():
    """build_step_preps / prepare_params take site_default (the site of a
    leaf outside the mixer and head) and names (the leaves prepared)."""
    policy = GemmPolicy(default=tapi.precision("native"), overrides=(
        ("attn", tapi.precision("ozaki1-p3+cached")),))
    w = torch.randn(16, 8)
    params = {"blk": {"w_in": w, "other": w}}
    assert prepared.build_step_preps(params, policy) == {}
    preps = prepared.build_step_preps(params, policy, site_default="attn")
    assert list(preps) == ["blk/w_in"] and preps["blk/w_in"].p == 3
    preps = prepared.build_step_preps(params, policy, site_default="attn",
                                      names={"other"})
    assert list(preps) == ["blk/other"]
    wrapped = prepared.prepare_params(params, policy, site_default="attn",
                                      names={"other"})
    assert wrapped["blk"]["w_in"] is w
    assert isinstance(wrapped["blk"]["other"], prepared.PreparedOperand)


def test_scheme1_split_axis_and_residual_bound():
    """split names its axis ``axis``; the residual is within
    decomposition_residual_bound of the scale."""
    x = torch.randn(5, 7, dtype=torch.float64)
    sl, scale = scheme1.split(x, 4, 6, axis=0)
    assert scale.shape == (1, 7)
    back = sum(2.0 ** (-6 * (i + 1)) * sl[i].double() for i in range(4))
    assert ((x - scale * back).abs()
            <= scale * scheme1.decomposition_residual_bound(4, 6)).all()


def test_dispatch_and_data_call_forms():
    """emulated_matmul's deprecated scheme= / precision= kwargs,
    resolve_policy(policy, None), make_batch_iterator's positional host
    arguments and batch_override, and rope_frequencies' default theta."""
    a, b = torch.randn(6, 20), torch.randn(20, 4)
    with pytest.warns(DeprecationWarning):
        old = dispatch.emulated_matmul(a, b, scheme="ozaki1", precision=3)
    assert torch.equal(old, dispatch.emulated_matmul(a, b, cfg="ozaki1-p3"))
    with pytest.raises(TypeError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            dispatch.emulated_matmul(a, b, cfg="ozaki1-p3", precision=3)
    policy = GemmPolicy(default=tapi.precision("ozaki1-p4"))
    assert dispatch.resolve_policy(policy, None) == policy
    with pytest.raises(NotImplementedError, match="item 8"):
        dispatch.resolve_policy(policy, object())
    arch = tconfigs.get_smoke_config(ARCH)
    shape = ShapeSpec("smoke", 16, 2, "train")
    _, batch = next(make_batch_iterator(arch, shape, 0, 0, 1, 3))
    _, ref = next(make_batch_iterator(arch, dataclasses.replace(
        shape, global_batch=3), 0))
    assert {k: v.shape for k, v in batch.items()} == {
        k: v.shape for k, v in ref.items()}
    with pytest.raises(NotImplementedError, match="item 8"):
        next(make_batch_iterator(arch, shape, 0, 1, 2))
    assert torch.equal(rope_frequencies(64), rope_frequencies(64, 10000.0))


def test_int8_cache_call_forms():
    """The int8 KV cache's functions in the reference's positional forms
    (``cache_shape(cfg, batch, max_seq)``, ``quantize_kv(x)``,
    ``dequantize_kv(q, scale, dtype)``): a window layer's ring length, an
    int8 ``init_cache``'s leaves, and a quantize / dequantize round trip
    within half a step of the scale."""
    from repro_torch.models import attention as TA
    cfg = TA.AttnConfig(80, 5, 5, 16, cache_int8=True)
    assert TA.cache_shape(cfg, 2, 32) == (2, 32, 5, 16)
    assert TA.cache_shape(dataclasses.replace(cfg, window=8), 2, 32) == (
        2, 8, 5, 16)
    cache = TA.init_cache(cfg, 2, 32, torch.float32, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((2, 32, 5, 16), torch.int8), "v": ((2, 32, 5, 16), torch.int8),
        "k_scale": ((2, 32, 5, 1), torch.float32),
        "v_scale": ((2, 32, 5, 1), torch.float32)}
    x = torch.randn(2, 3, 5, 16)
    q, scale = TA.quantize_kv(x)
    back = TA.dequantize_kv(q, scale, torch.float32)
    assert ((back - x).abs() <= scale / 2 + 1e-7).all()


def test_block_kinds_and_local_attention_call_forms():
    """The reference's block call forms: init_block(gen, kind, ...),
    block_step(params, kind, ...) (a rec / ssd kind raises, naming its
    lane-bound cache), attn_config(mcfg, local=True) (the window), and
    the recurrent modules' own (init_rglru / init_ssd with their
    reference defaults, d_inner, n_heads)."""
    from repro_torch.models import blocks as TB, rglru as TR, ssd as TS
    rg = tconfigs.get_smoke_config("recurrentgemma-2b").model
    assert TB.attn_config(rg).window == rg.attn_window == 32
    olmo = tconfigs.get_smoke_config(ARCH).model
    assert TB.attn_config(olmo).window is None
    assert TB.attn_config(dataclasses.replace(olmo, attn_window=8),
                          local=True).window == 8
    gen = torch.Generator().manual_seed(0)
    p = TB.init_block(gen, "rec", rg, torch.float32, "cpu")
    assert set(p) == {"ln1", "mixer", "ln2", "ffn"}
    with pytest.raises(NotImplementedError, match="lane-bound"):
        TB.block_step(p, "rec", rg, torch.zeros(1, 2, rg.d_model),
                      torch.zeros(1, dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32), {},
                      GemmPolicy(default=tapi.precision("native")))
    m2 = tconfigs.get_smoke_config("mamba2-780m").model
    assert set(TB.init_block(gen, "ssd", m2, torch.float32, "cpu")) == {
        "ln1", "mixer"}
    assert TR.init_rglru(gen, 16, rg.rglru, device="cpu")["lam"].dtype == \
        torch.float32
    sp = TS.init_ssd(gen, 16, m2.ssd, device="cpu")
    assert sp["w_in"].dtype == torch.float32
    assert (TS.d_inner(16, m2.ssd), TS.n_heads(16, m2.ssd)) == (32, 2)
