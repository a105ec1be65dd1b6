"""The port's training loop against the reference and on its own: AdamW,
clipping and the schedule against the reference's on the same numpy
trees, the synthetic batches equal to the reference's, cached and
uncached emulation giving the same gradients, the train CLI learning on
the emulated path, and a failure at a step followed by a resume ending
in an uninterrupted run's state, bit for bit.

The optimizer tolerance is 1e-5 relative: both packages compute AdamW in
float32, and XLA and torch may fuse its elementwise ops differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import configs as jconfigs
from repro.data import make_batch_iterator as j_batches
from repro.optim import optimizers as jopt
from repro_torch import api as tapi, configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticLMDataset as TDataset, \
    make_batch_iterator as t_batches
from repro_torch.launch import steps as TS, train as train_cli
from repro_torch.models.common import GemmPolicy as TPolicy
from repro_torch.optim import optimizers as topt
from repro_torch.utils.tree import tree_flatten, tree_map


def test_cached_and_uncached_gradients_are_bit_identical():
    arch = tconfigs.get_smoke_config("olmo-1b")
    params = TS.init_state(arch, 0, "cpu")["params"]
    batch = TS.batch_to(TDataset(arch.model.vocab, 32, 0).batch(0, 2), "cpu")
    for kw in ({}, {"bwd_p": 3}):
        (l0, g0), (l1, g1) = (
            TS.value_and_grad(TS.make_loss_fn(arch, TPolicy(
                default=tapi.precision(spec, **kw))), params, batch)
            for spec in ("ozaki1-p4", "ozaki1-p4+cached"))
        assert torch.equal(l0, l1)
        for key, g in tree_flatten(g0).items():
            assert torch.equal(g, tree_flatten(g1)[key]), (kw, key)


# ---------------------------------------------------------------------------
# Optimizer, schedule and data.
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": {"b": rng.standard_normal((2, 3, 4)).astype(np.float32),
                       "s": rng.standard_normal((7,)).astype(np.float32)}}


def test_adamw_clip_and_schedule_match_reference():
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), tree_map(lambda x: 5 * x, _tree(rng))
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             grads)
    tp, tg = tree_map(t, params), tree_map(t, grads)
    jg, jnorm = jopt.clip_by_global_norm(jg, 1.0)
    tg, tnorm = topt.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(3):
        for s in (0, 50, 100, 5000, 20000):
            np.testing.assert_allclose(
                float(topt.warmup_cosine(torch.tensor(s), 3e-4)),
                float(jopt.warmup_cosine(jnp.asarray(s), 3e-4)), rtol=1e-6)
        lr = 1e-2
        jp, jstate = jopt.adamw_update(jg, jstate, jp, lr)
        tp, tstate = topt.adamw_update(tg, tstate, tp, lr)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for ours, ref in ((tp, jp), (tstate["m"], jstate["m"]),
                      (tstate["v"], jstate["v"])):
        jflat = tree_flatten(jax.tree.map(np.asarray, ref))
        for key, x in tree_flatten(ours).items():
            np.testing.assert_allclose(x.numpy(), jflat[key], rtol=1e-5,
                                       atol=1e-7)


def test_batches_equal_the_reference():
    shape = ShapeSpec("t", 16, 4, "train")
    jit = j_batches(jconfigs.get_smoke_config("olmo-1b"), shape, seed=3)
    tit = t_batches(tconfigs.get_smoke_config("olmo-1b"), shape, seed=3)
    for _ in range(3):
        (js, jb), (ts, tb) = next(jit), next(tit)
        assert js == ts and sorted(jb) == sorted(tb)
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key])


# ---------------------------------------------------------------------------
# The CLI and the Trainer.
# ---------------------------------------------------------------------------

def test_train_on_emulated_path_decreases_loss(tmp_path):
    """The CLI trains the smoke model through ozaki1-p3 GEMMs, and the
    model learns: its loss on the first batch falls. (Consecutive
    losses are of different batches, and in warmup the learning rate is
    small, so the first and last logged losses alone would be noise.)"""
    ckpt = str(tmp_path / "emu")
    log = train_cli.main([
        "--arch", "olmo-1b", "--smoke", "--steps", "12", "--batch", "4",
        "--seq", "32", "--gemm", "ozaki1-p3", "--device", "cpu",
        "--ckpt-dir", ckpt])
    assert len(log) == 12 and all(np.isfinite(m["loss"]) for m in log)
    arch = tconfigs.get_smoke_config("olmo-1b")
    loss_fn = TS.make_loss_fn(arch, TPolicy(default=tapi.precision(
        "ozaki1-p3")))
    _, batch = next(t_batches(arch, ShapeSpec("cli", 32, 4, "train")))
    batch = TS.batch_to(batch, "cpu")
    with torch.no_grad():
        before = loss_fn(TS.init_state(arch, 0, "cpu")["params"], batch)
        after = loss_fn(CheckpointManager(ckpt).restore(11)["params"], batch)
    assert float(before) == pytest.approx(log[0]["loss"], rel=1e-6)
    assert float(after) < float(before)


def test_failure_injection_and_bitexact_resume(tmp_path):
    """A run that fails at step 2 and resumes ends in the state of an
    uninterrupted run, bit for bit."""
    def run(ckpt, fail_at=None):
        argv = ["--arch", "olmo-1b", "--smoke", "--steps", "4", "--batch",
                "2", "--seq", "16", "--gemm", "ozaki1-p4+cached",
                "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
        if fail_at is not None:
            argv += ["--fail-at", str(fail_at)]
        return train_cli.main(argv)

    ref_log = run(str(tmp_path / "ref"))
    with pytest.raises(RuntimeError, match="injected failure"):
        run(str(tmp_path / "ft"), fail_at=2)
    log = run(str(tmp_path / "ft"))               # resumes from step 1
    assert [m["step"] for m in log] == [2, 3]
    assert [m["loss"] for m in log] == [m["loss"] for m in ref_log[2:]]
    states = [CheckpointManager(str(tmp_path / d)).restore(3)
              for d in ("ref", "ft")]
    flat = [tree_flatten(s) for s in states]
    assert sorted(flat[0]) == sorted(flat[1])
    for key, x in flat[0].items():
        assert x.dtype == flat[1][key].dtype and torch.equal(x, flat[1][key])


def test_train_step_refuses_what_is_not_ported():
    """Adafactor (ROADMAP.md § 1 item 4.6) is ported: a step runs and
    keeps the reference's state (vr, vc, step); the guard (§ 1 item 5)
    is ported too: a clean guarded step gives the unguarded step's loss
    and state bit for bit (its tests: tests/test_torch_guard.py)."""
    import dataclasses
    arch = tconfigs.get_smoke_config("olmo-1b")
    ada = dataclasses.replace(
        arch, train=dataclasses.replace(arch.train, optimizer="adafactor"))
    state = TS.init_state(ada, 0, "cpu")
    assert set(state["opt"]) == {"vr", "vc", "step"}
    _, batch = next(t_batches(ada, ShapeSpec("s", 16, 2, "train"), 0))
    new, metrics = TS.make_train_step(ada)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(new["opt"]["step"]) == 1 and int(state["opt"]["step"]) == 0
    wo = new["opt"]["vr"]["layers"]["b0"]["mixer"]["wo"]
    assert wo.shape == state["params"]["layers"]["b0"]["mixer"]["wo"].shape[
        :-1] and wo.gt(0).all()
    outs = [TS.make_train_step(arch, policy=TPolicy(
        default=tapi.precision(spec)))(TS.init_state(arch, 0, "cpu"), batch)
        for spec in ("ozaki1-p4+guard", "ozaki1-p4")]
    assert float(outs[0][1]["loss"]) == float(outs[1][1]["loss"])
    flat = [tree_flatten(o[0]) for o in outs]
    assert all(torch.equal(v, flat[1][k]) for k, v in flat[0].items())
