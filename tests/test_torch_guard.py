"""The port's guard (``repro_torch.guard``) against the reference's
(``repro.guard``) on the CPU: spec suffixes, sentinel masks, verdicts and
tolerances, fault injection, strict and 'on' ladders, the counted
(traced) semantics of guarded batched calls, guarded gradients, the
Trainer's strict retries and ``GuardMonitor``, and the serve engine's
per-lane isolation replay.

Every comparison runs the same numpy-seeded operands through both
packages and holds results bit for bit (NaN lanes included) and the
``guard.stats()`` counters equal. The reference's ladder runs eagerly
(its traced mode only counts), so its 2-D calls are not jitted here; its
batched and differentiated calls are traced, as the port's counted
semantics mirror. The reference pins its 'xla' backend with '@xla', the
port its 'torch' backend with '+xla'. The probe vectors of the two
verifiers differ (a torch.Generator against jax.random), so their
residuals differ in value; only verdicts are compared, on operands the
reference's own tests use.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from _torch_util import one_torch_thread, t  # noqa: F401
from conftest import conditioned
from repro import guard as jguard
from repro.core.precision import EmulationAccuracyError as JAccuracyError
from repro.kernels import dispatch as jdispatch
from repro_torch import api as tapi, configs as tconfigs, guard
from repro_torch.core import emulated
from repro_torch.core.precision import (EmulationAccuracyError,
                                        EmulationConfig)
from repro_torch.guard import ladder, smoke
from repro_torch.kernels import dispatch, prepared
from repro_torch.models.common import GemmPolicy
from repro_torch.serving import ContinuousEngine, Request

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DN = (((1,), (0,)), ((), ()))


def _int_operands(m=16, k=32, n=12, seed=0):
    """The reference test's small nonzero integers: exactly emulated at
    any p, so recovery is checkable as bit-identity. One shape throughout,
    so that the reference's eager ops compile once."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 9, (m, k)) * rng.choice([-1.0, 1.0], (m, k))
    b = rng.integers(1, 9, (k, n)) * rng.choice([-1.0, 1.0], (k, n))
    return a.astype(np.float32), b.astype(np.float32)


def _stats(s) -> dict:
    return dataclasses.asdict(s)


def _same(out: torch.Tensor, ref) -> None:
    """Bit for bit, NaN lanes included."""
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _both_matmul(a, b, spec, inject=None):
    """One eager guarded 2-D call in each package (reference '@xla', port
    '+xla'), from cleared counters; returns (port out, ref out, port
    stats, ref stats). An armed fault fires as often in both."""
    outs, stats, fired = [], [], []
    for pkg_guard, call, jspec in (
            (guard, lambda x, y, s: dispatch.emulated_matmul(t(x), t(y), cfg=s),
             spec.replace("+guard", "+xla+guard")),
            (jguard, lambda x, y, s: jdispatch.emulated_matmul(
                jnp.asarray(x), jnp.asarray(y), cfg=s),
             spec.replace("+guard", "@xla+guard"))):
        pkg_guard.stats_clear()
        if inject is None:
            outs.append(call(a, b, jspec))
        else:
            with pkg_guard.inject(**inject) as fault:
                outs.append(call(a, b, jspec))
            fired.append(fault.fired)
        stats.append(_stats(pkg_guard.stats()))
    assert fired == [] or (fired[0] == fired[1] >= 1)
    return outs[0], outs[1], stats[0], stats[1]


# ---------------------------------------------------------------------------
# Spec grammar.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,mode", [
    ("ozaki1-p4+guard", "on"), ("ozaki1-p4+guard:strict", "strict"),
    ("ozaki2-m6@cuda+guard", "on"), ("bits=40:k1024+guard:strict", "strict")])
def test_guard_spec_roundtrip(spec, mode):
    cfg = EmulationConfig.parse(spec)
    assert cfg.guard == mode
    assert EmulationConfig.parse(cfg.to_spec()) == cfg
    assert guard.GuardPolicy.from_config(cfg) == guard.GuardPolicy(mode=mode)
    assert guard.GuardPolicy.from_config(cfg).strict == (mode == "strict")
    with pytest.raises(ValueError, match="guard"):
        EmulationConfig.parse("native+guard")


# ---------------------------------------------------------------------------
# Sentinels: NaN/Inf parity and the exponent-spread probe.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["ozaki1-p4", "ozaki2-m6"])
def test_nan_inf_masks_match_reference(scheme):
    rng = np.random.default_rng(0)
    a = conditioned(rng, (16, 32))
    b = conditioned(rng, (32, 12))
    a[3, 5], a[7, 0] = np.nan, np.inf
    b[2, 4] = -np.inf
    out, ref, s, js = _both_matmul(a, b, scheme + "+guard")
    _same(out, ref)
    assert s == js and s["masked"] == 1 and s["trips"] == 0
    nan = torch.isnan(out)
    assert bool(nan[3].all() and nan[7].all() and nan[:, 4].all())
    assert int(nan.sum()) == 2 * 12 + 16 - 2


@pytest.mark.parametrize("scheme", ["ozaki1-p4", "ozaki2-m6"])
def test_nan_inf_masks_prepared_rhs(scheme):
    """A prepared weight is decomposed clean; a non-finite activation
    row is still masked, on both sides the same."""
    rng = np.random.default_rng(1)
    a = conditioned(rng, (16, 32))
    a[5, 1] = np.nan
    b = conditioned(rng, (32, 12))
    prep = prepared.prepare_rhs(t(b), tapi.precision(scheme))
    out = tapi.dot_general(t(a), prep, DN, precision=scheme + "+guard")
    jprep = repro.prepare_rhs(jnp.asarray(b), repro.precision(scheme))
    ref = repro.dot_general(jnp.asarray(a), jprep, DN,
                            precision=scheme + "+guard")
    _same(out, ref)
    assert bool(torch.isnan(out[5]).all())
    assert bool(torch.isfinite(torch.cat([out[:5], out[6:]])).all())


def test_probe_and_sanitize_match_reference():
    from repro.guard import sentinel as jsentinel
    from repro_torch.guard import sentinel
    rng = np.random.default_rng(2)
    a = conditioned(rng, (8, 16))
    a[0, 0], a[1, 1], a[2, 3] = 1e30, 1e-30, np.inf
    a[4] = 0.0
    a[5, :] = 1e-40                   # subnormal-only row
    b = conditioned(rng, (16, 6))
    b[3, 2] = np.nan
    p, jp = sentinel.probe_operands(t(a), t(b)), jsentinel.probe_operands(
        jnp.asarray(a), jnp.asarray(b))
    for f in ("row_mask", "col_mask", "spread_a", "spread_b"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    _same(sentinel.sanitize(t(a)), jsentinel.sanitize(jnp.asarray(a)))
    assert bool(p.any_nonfinite())


def test_wide_spread_warns_once_narrow_does_not():
    rng = np.random.default_rng(0)
    a = conditioned(rng, (16, 32))
    a[0, 0], a[1, 1] = 1e30, 1e-30  # ~200-bit spread vs a ~27-bit budget
    b = conditioned(rng, (32, 8))
    dispatch.fallback_warnings_clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(2):
            dispatch.emulated_matmul(t(a), t(b), cfg="ozaki1-p4+guard")
        x, y = _int_operands()
        dispatch.emulated_matmul(t(x), t(y), cfg="ozaki1-p4+guard")
    spread = [str(w.message) for w in rec
              if "exponent spread" in str(w.message)]
    assert len(spread) == 1 and "bits" in spread[0]


# ---------------------------------------------------------------------------
# Clean runs, verdicts and tolerances.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["ozaki1-p4+guard", "ozaki2-m6+guard:strict"])
def test_clean_guarded_call_is_identity(spec):
    """A clean guard is the identity: the unguarded bits, one call, one
    verification, no trip; both packages count the same."""
    a, b = _int_operands()
    out, ref, s, js = _both_matmul(a, b, spec)
    _same(out, ref)
    assert torch.equal(out, dispatch.emulated_matmul(
        t(a), t(b), cfg=spec.split("+")[0]))
    assert s == js == _stats(guard.GuardStats(calls=1, verified=1))


def test_verify_gemm_verdicts_match_reference():
    rng = np.random.default_rng(0)
    a = conditioned(rng, (32, 48))
    b = conditioned(rng, (48, 16))
    c = a.astype(np.float64) @ b.astype(np.float64)
    c = c.astype(np.float32)
    bad = c.copy()
    bad[3, 3] += 0.1 * np.abs(c).max()
    for cc, want in ((c, True), (bad, False)):
        res = guard.verify_gemm(t(a), t(b), t(cc), cfg="ozaki1-p4")
        jres = jguard.verify_gemm(a, b, cc, cfg="ozaki1-p4")
        assert bool(res) == bool(jres) == want
        assert res.tol == jres.tol
    res = guard.verify_gemm(t(a), t(b), t(bad), cfg="ozaki1-p4")
    assert float(res.err) > res.tol
    # A prepared rhs verifies against its reconstruct().
    prep = prepared.prepare_rhs(t(b), tapi.precision("ozaki1-p6"))
    assert guard.verify_gemm(t(a), prep, t(c), cfg="ozaki1-p6")


def test_verify_tolerance_equals_reference():
    from repro.guard.verify import tolerance as jtol
    from repro_torch.guard.verify import tolerance
    for bits in (14, 20, 27, 40):
        for m, n, k in ((64, 64, 64), (1, 2048, 8192)):
            assert tolerance(bits, m, n, k) == jtol(bits, m, n, k)
    assert tolerance(20, 64, 64, 64, tol_factor=1.0) \
        == pytest.approx(2.0 ** -19 + 128 * np.finfo(np.float32).eps)


def test_verify_runs_in_full_float32_and_chunks_b(monkeypatch):
    """The matvecs run at 'highest' float32 precision whatever the
    process asks, which is restored after; B enters in row chunks (a
    bfloat16 weight is never copied whole to float32), with the same
    verdict."""
    from repro_torch.guard import verify
    rng = np.random.default_rng(4)
    a = conditioned(rng, (8, 64))
    b = conditioned(rng, (64, 16))
    c = (a.astype(np.float64) @ b).astype(np.float32)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    seen = []
    real = verify._b_side

    def spy(bb, x, mask):
        seen.append(torch.get_float32_matmul_precision())
        return real(bb, x, mask)
    monkeypatch.setattr(verify, "_b_side", spy)
    monkeypatch.setattr(verify, "CHUNK_ELEMENTS", 16 * 5)
    try:
        whole = verify.verify_gemm(t(a), t(b), t(c), cfg="ozaki1-p4")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest"] and bool(whole.ok)
    monkeypatch.setattr(verify, "CHUNK_ELEMENTS", 1 << 24)
    ref = verify.verify_gemm(t(a), t(b), t(c), cfg="ozaki1-p4")
    assert torch.allclose(whole.err, ref.err, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Fault injection and the ladder.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,bit,operand", [
    ("bitflip_slice", 6, "a"), ("bitflip_slice", 4, "b"),
    ("zero_modulus", 6, "a"), ("zero_modulus", 6, "b")])
def test_injected_slice_fault_caught_and_recovered(kind, bit, operand):
    a, b = _int_operands()
    out, ref, s, js = _both_matmul(a, b, "ozaki1-p4+guard", inject=dict(
        kind=kind, count=1, bit=bit, plane=0, operand=operand))
    _same(out, ref)
    assert s == js
    assert s["trips"] == 1 and s["recoveries"] == 1 and s["escalations"] == 1
    assert torch.equal(out, dispatch.emulated_matmul(t(a), t(b),
                                                     cfg="ozaki1-p4"))


@pytest.mark.parametrize("kind,plane", [("bitflip_slice", 1),
                                        ("zero_modulus", 3),
                                        ("bitflip_slice", 5)])
def test_injected_residue_fault_caught_and_recovered(kind, plane):
    a, b = _int_operands(seed=3)
    out, ref, s, js = _both_matmul(a, b, "ozaki2-m6+guard", inject=dict(
        kind=kind, count=1, plane=plane))
    _same(out, ref)
    assert s == js and s["trips"] == 1 and s["recoveries"] == 1


def test_injection_last_plane_lsb_below_bound_is_tolerated():
    """A last-plane LSB flip is of the order of the decomposition's own
    residual: neither verifier trips (the reference test's operands at
    this file's shape; the port's residual is some 1e-4 of the
    tolerance)."""
    rng = np.random.default_rng(7)
    a = conditioned(rng, (16, 32))
    b = conditioned(rng, (32, 12))
    out, ref, s, js = _both_matmul(a, b, "ozaki1-p4+guard", inject=dict(
        kind="bitflip_slice", count=1, bit=0, plane=3))
    _same(out, ref)
    assert s == js and s["trips"] == 0


def test_inject_validates_arguments():
    for kw in ({"kind": "not_a_kind"}, {"kind": "bitflip_slice", "bit": 9},
               {"kind": "bitflip_slice", "operand": "c"}):
        with pytest.raises(ValueError):
            with guard.inject(**kw):
                pass


def test_strict_exhausted_ladder_raises():
    a, b = _int_operands(seed=5)
    stats = []
    for pkg, err, call in (
            (guard, EmulationAccuracyError, lambda: dispatch.emulated_matmul(
                t(a), t(b), cfg="ozaki2-m6+xla+guard:strict")),
            (jguard, JAccuracyError, lambda: jdispatch.emulated_matmul(
                jnp.asarray(a), jnp.asarray(b),
                cfg="ozaki2-m6@xla+guard:strict"))):
        pkg.stats_clear()
        with pytest.raises(err, match="strict"):
            with pkg.inject("zero_modulus", count=99, plane=1):
                call()
        stats.append(_stats(pkg.stats()))
    assert stats[0] == stats[1]
    assert stats[0]["trips"] == 1 and stats[0]["recoveries"] == 0
    assert stats[0]["escalations"] >= 1


def test_on_mode_exhausted_ladder_falls_back_to_native():
    a, b = _int_operands(seed=6)
    dispatch.fallback_warnings_clear()
    jdispatch.fallback_warnings_clear()
    with pytest.warns(RuntimeWarning, match="native"):
        out, ref, s, js = _both_matmul(a, b, "ozaki2-m6+guard", inject=dict(
            kind="zero_modulus", count=99, plane=1))
    assert s == js and s["native_fallbacks"] == 1
    _same(out, ref)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-6)


# ---------------------------------------------------------------------------
# Batched calls (the reference's traced semantics) and gradients.
# ---------------------------------------------------------------------------

def test_guarded_batched_call_counts_per_element():
    """A guarded batched einsum runs the batched dispatch once and
    verifies, masks and counts each element (the reference vmaps its 2-D
    dispatch under jit): the same bits, NaN lanes and counters; no
    ladder."""
    rng = np.random.default_rng(8)
    a = conditioned(rng, (3, 16, 32))
    b = conditioned(rng, (3, 32, 8))
    a[1, 4, 0] = np.inf
    eq, spec = "bik,bkj->bij", "ozaki1-p4+guard:strict"
    guard.stats_clear()
    out = tapi.einsum(eq, t(a), t(b), precision=spec)
    s = _stats(guard.stats())
    jguard.stats_clear()
    ref = jax.jit(lambda x, y: repro.einsum(eq, x, y, precision=spec))(
        jnp.asarray(a), jnp.asarray(b))
    jax.effects_barrier()
    _same(out, ref)
    assert s == _stats(jguard.stats()) == _stats(guard.GuardStats(
        calls=3, verified=3, masked=1))
    assert bool(torch.isnan(out[1, 4]).all())


def test_guarded_batched_trip_is_counted_not_laddered():
    """Under the counted semantics a tripped element is counted and kept
    (masked lanes aside), never escalated, and strict does not raise."""
    a, b = _int_operands(m=8, k=16, n=4)
    a3, b3 = t(np.stack([a, a])), t(np.stack([b, b]))
    guard.stats_clear()
    with guard.inject("bitflip_slice", count=1, plane=0):
        out = dispatch.emulated_matmul_batched(
            a3, b3, cfg="ozaki1-p4+xla+guard:strict")
    s = guard.stats()
    assert (s.calls, s.verified, s.trips, s.escalations) == (2, 2, 1, 0)
    clean = dispatch.emulated_matmul(t(a), t(b), cfg="ozaki1-p4")
    assert torch.equal(out[1], clean) and not torch.equal(out[0], clean)


def test_guarded_gradients_match_reference():
    """Forward, dA and dB of a guarded dense product: each a verified 2-D
    call; the gradients bit for bit with the reference's (traced by
    jax.grad) and the same counters."""
    rng = np.random.default_rng(9)
    a = conditioned(rng, (8, 16))
    b = conditioned(rng, (16, 4))
    spec = "ozaki1-p4+guard"
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    guard.stats_clear()
    tapi.dot_general(ta, tb, DN, precision=spec).sum().backward()
    s = _stats(guard.stats())
    jguard.stats_clear()
    ga, gb = jax.jit(jax.grad(lambda x, y: repro.dot_general(
        x, y, DN, precision=spec).sum(), argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    jax.effects_barrier()
    _same(ta.grad, ga)
    _same(tb.grad, gb)
    assert s == _stats(jguard.stats())
    assert s["calls"] == s["verified"] == 3


def test_guard_is_never_cached():
    """'+cached+guard' prepares nothing (the ladder may re-plan p): the
    forward goes through the guarded engine and gives the unguarded
    bits."""
    a, b = _int_operands(m=8, k=16, n=4)
    cfg = EmulationConfig.parse("ozaki1-p4+cached+guard")
    ta = t(a).requires_grad_()
    assert not emulated._cacheable(ta, t(b), cfg)
    guard.stats_clear()
    out = emulated.emulated_dot(ta, t(b), cfg)
    assert guard.stats().calls == 1
    assert torch.equal(out.detach(), dispatch.emulated_matmul(
        t(a), t(b), cfg="ozaki1-p4"))


def test_plan_probe_and_sync_count():
    a, b = _int_operands(m=8, k=16, n=4)
    plan = dispatch.plan_emulated(t(a), t(b), EmulationConfig(), probe=True)
    assert plan.probe is not None and not bool(plan.probe.any_nonfinite())
    assert dispatch.plan_emulated(t(a), t(b), EmulationConfig()).probe is None
    ladder.SYNCS.reset()
    dispatch.emulated_matmul(t(a), t(b), cfg="ozaki1-p4+guard")
    assert ladder.SYNCS.n == 3           # masked, spread, verdict
    ladder.SYNCS.reset()
    dispatch.emulated_matmul_batched(t(np.stack([a, a])), t(np.stack([b, b])),
                                     cfg="ozaki1-p4+guard")
    assert ladder.SYNCS.n == 1           # one a batched call
    # The batched check is the 2-D one of each element.
    from repro_torch.guard import verify
    rng = np.random.default_rng(5)
    a3, b3 = t(rng.standard_normal((3, 8, 16))), t(rng.standard_normal(
        (3, 16, 4)))
    c3 = torch.matmul(a3, b3)
    c3[1, 2, 3] += 1.0
    both = verify.verify_batched(a3, b3, c3, "ozaki1-p4")
    each = [verify.verify_gemm(x, y, z, "ozaki1-p4")
            for x, y, z in zip(a3, b3, c3)]
    assert both.ok.tolist() == [bool(e) for e in each] == [True, False, True]
    # The same residuals up to the matvecs' rounding (a clean one is
    # rounding alone).
    assert torch.allclose(both.err, torch.stack([e.err for e in each]),
                          rtol=1e-6, atol=1e-3 * both.tol)
    assert both.tol == each[0].tol


def test_smoke_runs_on_cpu(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    assert "smoke OK on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The Trainer: strict retries and GuardMonitor.
# ---------------------------------------------------------------------------

def _trainer_logs(tmp_path, step_fns, **kw):
    """The same synthetic step under the port's and the reference's
    Trainer."""
    from repro.runtime.trainer import Trainer as JTrainer
    from repro_torch.runtime import Trainer
    logs = []
    for name, cls, init in (
            ("t", Trainer, lambda: {"w": torch.zeros(2)}),
            ("j", JTrainer, lambda: {"w": jnp.zeros(2)})):
        tr = cls(step_fn=step_fns[name], init_state_fn=init,
                 batch_iterator=((i, {}) for i in range(10)),
                 ckpt_dir=str(tmp_path / name), guard_backoff=0.0, **kw)
        try:
            logs.append(tr.run(2))
        finally:
            tr.close()
    return logs


def test_trainer_retries_strict_guard_trips(tmp_path):
    calls = {"t": 0, "j": 0}

    def make(name, one):
        def step_fn(state, batch):
            calls[name] += 1
            if calls[name] == 1:
                raise (EmulationAccuracyError if name == "t"
                       else JAccuracyError)("synthetic strict trip")
            return {"w": state["w"] + 1.0}, {"loss": one}
        return step_fn

    logs = _trainer_logs(tmp_path, {"t": make("t", torch.tensor(0.0)),
                                    "j": make("j", jnp.float32(0.0))})
    assert calls == {"t": 3, "j": 3}
    keys = ("step", "loss", "guard_retries", "guard_trips",
            "guard_native_fallbacks")
    assert [{k: r[k] for k in keys} for r in logs[0]] \
        == [{k: r[k] for k in keys} for r in logs[1]]
    assert logs[0][0]["guard_retries"] == 1


def test_trainer_reraises_when_retries_exhausted(tmp_path):
    from repro_torch.runtime import Trainer

    def step_fn(state, batch):
        raise EmulationAccuracyError("always trips")

    tr = Trainer(step_fn=step_fn, init_state_fn=lambda: {"w": torch.zeros(2)},
                 batch_iterator=((i, {}) for i in range(10)),
                 ckpt_dir=str(tmp_path), device="cpu", guard_retries=1,
                 guard_backoff=0.0)
    with pytest.raises(EmulationAccuracyError):
        tr.run(1)
    tr.close()


def test_guard_monitor_and_strict_trainer_on_a_model(tmp_path):
    """GuardMonitor deltas, and the Trainer on olmo-1b's smoke config
    under '+guard:strict': the guarded losses equal the unguarded ones bit
    for bit, every step's delta counts its verified calls and no trip,
    and a JSONL record a step is written."""
    import json
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps as S
    from repro_torch.runtime import GuardMonitor, Trainer
    mon = GuardMonitor()
    a, b = _int_operands(m=8, k=16, n=4)
    dispatch.emulated_matmul(t(a), t(b), cfg="ozaki1-p4+guard")
    assert mon.observe(0)["calls"] == 1 and mon.observe(1)["calls"] == 0
    arch = tconfigs.get_smoke_config("olmo-1b")
    shape = ShapeSpec("s", 16, 2, "train")
    losses = {}
    for spec in ("ozaki1-p4+guard:strict", "ozaki1-p4"):
        tr = Trainer(
            step_fn=S.make_train_step(arch, policy=GemmPolicy(
                default=tapi.precision(spec))),
            init_state_fn=lambda: S.init_state(arch, 0, "cpu"),
            batch_iterator=make_batch_iterator(arch, shape, 0),
            ckpt_dir=str(tmp_path / spec), device="cpu",
            metrics_jsonl=str(tmp_path / f"{spec}.jsonl"),
            tokens_per_step=32)
        try:
            log = tr.run(2)
        finally:
            tr.close()
        losses[spec] = [r["loss"] for r in log]
        if "guard" in spec:
            assert [r["guard_trips"] for r in log] == [0, 0]
            assert tr.guard_monitor.trip_steps == []
            recs = [json.loads(x) for x in
                    (tmp_path / f"{spec}.jsonl").read_text().splitlines()]
            assert len(recs) == 2 and all(
                r["guard"]["calls"] == r["guard"]["verified"] > 0
                for r in recs)
    assert losses["ozaki1-p4+guard:strict"] == losses["ozaki1-p4"]


def test_stats_clear_resets_all_counters():
    a, b = _int_operands(m=8, k=16, n=4)
    dispatch.emulated_matmul(t(a), t(b), cfg="ozaki1-p4+guard")
    assert guard.stats().calls >= 1
    guard.stats_clear()
    assert guard.stats() == guard.GuardStats() and not guard.stats().tripped


# ---------------------------------------------------------------------------
# The continuous engine: a clean guard, the isolation replay, a failure
# scoped to its request (tests/test_serving.py's, ported).
# ---------------------------------------------------------------------------

ARCH = tconfigs.get_smoke_config("olmo-1b")


def _trace(n, seed):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, ARCH.model.vocab,
                                        int(rng.integers(3, 12))).tolist(),
                    max_new_tokens=int(rng.integers(2, 6)), arrival=0.0)
            for _ in range(n)]


def _engine(spec="ozaki1-p4", **kw):
    return ContinuousEngine(ARCH, max_seq=48, seed=0, max_lanes=2, chunk=8,
                            page_size=8, device="cpu", policy=GemmPolicy(
                                default=tapi.precision(spec)), **kw)


def _run(eng, reqs):
    return eng.run([Request(prompt=q.prompt, max_new_tokens=q.max_new_tokens,
                            arrival=0.0, rid=q.rid) for q in reqs],
                   max_steps=4000)


def test_clean_guarded_serve_equals_unguarded():
    reqs = _trace(3, seed=5)
    ref = _run(_engine(), reqs)
    guard.stats_clear()
    eng = _engine("ozaki1-p4+guard")
    res = _run(eng, reqs)
    s = guard.stats()
    for q in reqs:
        assert res[q.rid].tokens == ref[q.rid].tokens
        assert res[q.rid].guard_trips == 0
    assert s.calls == s.verified > 0 and s.trips == 0


def _first_call_of_each_step(eng, fast, replay):
    """Patch the engine's step so that its first call of each engine step
    (the whole-cohort call) runs ``fast(c, orig, *args)`` and the calls
    after it in the same step (the per-lane replays) ``replay(c, orig,
    *args)``."""
    seen = {"step": None}
    orig = dict(eng._step_fns)

    def make(c):
        def f(*args):
            first = seen["step"] != eng._step_idx
            seen["step"] = eng._step_idx
            return (fast if first else replay)(c, orig[c], *args)
        return f
    eng._step_fns = {c: make(c) for c in orig}


def _run_step(c, step, *args):
    return step(*args)


def test_isolation_replay_reproduces_fast_path():
    """Force the guard-retry path on every step: the per-lane replay must
    produce the same tokens as the whole-cohort fast path, although the
    fast path has already written its KV slots into the pools."""
    reqs = _trace(3, seed=6)
    ref = _run(_engine(), reqs)
    eng = _engine()

    def tripping(c, step, *args):
        raise EmulationAccuracyError("synthetic trip")

    _first_call_of_each_step(eng, tripping, _run_step)
    res = _run(eng, reqs)
    for q in reqs:
        assert res[q.rid].status == "done"
        assert res[q.rid].tokens == ref[q.rid].tokens

    # A fast path that ran (and wrote the pools) before its trip was seen.
    eng = _engine()

    def ran_then_tripped(c, step, *args):
        out = step(*args)
        guard.policy.record("trips")
        return out

    _first_call_of_each_step(eng, ran_then_tripped, _run_step)
    res = _run(eng, reqs)
    for q in reqs:
        assert res[q.rid].tokens == ref[q.rid].tokens


def test_guard_failure_scoped_to_offending_request():
    """A request whose replay keeps raising strict fails alone: cohort
    members complete, untouched and untripped."""
    reqs = _trace(3, seed=7)
    victim = reqs[1].rid
    eng = _engine(guard_retries=1)

    def tripping_fast(c, step, params, pools, tables, tokens, start, n_new):
        if any(s is not None and s.rid == victim for s in eng.sched.lanes):
            raise EmulationAccuracyError("synthetic trip")
        return step(params, pools, tables, tokens, start, n_new)

    def failing_replay(c, step, params, pools, tables, tokens, start, n_new):
        nn = n_new.cpu().numpy()
        for lane, s in enumerate(eng.sched.lanes):
            if s is not None and s.rid == victim and nn[lane] > 0:
                raise EmulationAccuracyError("still failing")
        return step(params, pools, tables, tokens, start, n_new)

    _first_call_of_each_step(eng, tripping_fast, failing_replay)
    res = _run(eng, reqs)
    assert res[victim].status == "failed" and res[victim].guard_trips > 0
    for q in reqs:
        if q.rid != victim:
            assert res[q.rid].status == "done"
            assert res[q.rid].guard_trips == 0
