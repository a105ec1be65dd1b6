"""The port's telemetry (``repro_torch.telemetry``) against the reference's
(``repro.telemetry``) on the CPU: registry semantics and exports (the same
operations give the same snapshot and the same Prometheus text), labels
and call sites, modeled bytes, the instrumented dispatch and prepared
paths (their counters against the reference's eager run of the same
calls), the disabled no-op, profiler scopes, the JSONL step records and
their report, the metrics endpoint, the guard counters on the registry,
the once-only fallback warnings, and the engines' and CLIs' records.
"""

import json
import threading
import urllib.error
import urllib.request
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import one_torch_thread, t  # noqa: F401
from repro import telemetry as jtele
from repro.kernels import dispatch as jdispatch, prepared as jprepared
from repro.telemetry import registry as jregistry
from repro_torch import api as tapi, configs as tconfigs, guard, telemetry
from repro_torch.core.emulated import emulated_dot
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import dispatch, prepared
from repro_torch.models.common import GemmPolicy
from repro_torch.serving import ContinuousEngine, LockstepEngine, Request
from repro_torch.telemetry import record as rec
from repro_torch.telemetry import report
from repro_torch.telemetry.registry import MetricsRegistry

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _restore_enabled_state():
    """Every test leaves both packages' enabled flags as it found them."""
    was = telemetry.enabled(), jtele.enabled()
    yield
    (telemetry.enable if was[0] else telemetry.disable)()
    (jtele.enable if was[1] else jtele.disable)()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _registry_ops(reg):
    reg.inc(rec.EMULATED_CALLS, 2, {"site": "attn", "scheme": "ozaki1"})
    reg.inc(rec.EMULATED_CALLS, 3, {"site": "ffn", "scheme": "ozaki1"})
    reg.inc(rec.EMULATED_CALLS, 1, {"site": "ffn", "scheme": "ozaki2"})
    reg.inc(rec.PAD_EVENTS, 1, {"m": 128, "flag": True})   # stringified
    reg.set_gauge(rec.STEP_TOKENS_PER_S, 100.0, {"kind": "train"})
    reg.set_gauge(rec.STEP_TOKENS_PER_S, 512.5, {"kind": "train"})
    for v in (0.25, 0.75, 0.5):
        reg.observe(rec.STEP_SECONDS, v, {"kind": "train"})
    reg.inc("repro_other_total", 4)
    reg.inc("c", 1, {"reason": 'say "hi"\nback\\slash'})


# ---------------------------------------------------------------------------
# MetricsRegistry and its exports.
# ---------------------------------------------------------------------------

def test_registry_semantics_and_exports_match_reference():
    from repro.telemetry import prometheus as jprom
    regs = MetricsRegistry(), jregistry.MetricsRegistry()
    for reg in regs:
        _registry_ops(reg)
    port, ref = regs
    assert port.snapshot() == ref.snapshot()
    assert telemetry.render_prometheus(port) == jprom.render_prometheus(ref)
    assert port.total(rec.EMULATED_CALLS) == 6
    assert port.total(rec.EMULATED_CALLS, site="ffn") == 4
    assert port.total(rec.PAD_EVENTS, m=128, flag=True) == 1
    assert list(port.series(rec.EMULATED_CALLS, scheme="ozaki1")) \
        == list(ref.series(rec.EMULATED_CALLS, scheme="ozaki1"))
    for reg in regs:
        reg.clear("repro_emulated")
    assert port.snapshot() == ref.snapshot()
    assert port.total(rec.EMULATED_CALLS) == 0
    assert port.total("repro_other_total") == 4
    text = telemetry.render_prometheus(port)
    assert r'reason="say \"hi\"\nback\\slash"' in text
    assert "repro_step_seconds_count" in text and \
        "# TYPE repro_step_tokens_per_s gauge" in text
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])


def test_registry_once_forget_and_threads():
    reg = MetricsRegistry()
    assert reg.once(("fallback", 1)) and not reg.once(("fallback", 1))
    assert reg.once(("other", 1))
    reg.forget_once("fallback")
    assert reg.once(("fallback", 1)) and not reg.once(("other", 1))
    reg.forget_once()
    assert reg.once(("other", 1))

    def work():
        for _ in range(1000):
            reg.inc("n", 1, {"k": "v"})
    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert reg.total("n") == 8000


def test_labels_sites_and_modeled_bytes_match_reference():
    for args in (("ozaki1", 4, "cuda", "kernel"), ("ozaki2", 6, "torch",
                                                   "prepared-torch"),
                 ("ozaki2-3m", 8, "torch", "torch")):
        assert telemetry.gemm_tag(*args) == jtele.gemm_tag(*args)
    assert telemetry.shape_class(4, 8, 2) == jtele.shape_class(4, 8, 2)
    assert telemetry.shape_class(4, 8, 2, 3) == "3x4x8x2"
    for mesh_shape in (None, (("data", 2),), {"data": 2, "model": 4}):
        assert telemetry.mesh_label(mesh_shape) == jtele.mesh_label(
            mesh_shape)
    assert telemetry.mesh_label((("data", 2), ("model", 4))) == \
        "data=2,model=4"
    for scheme, count in (("ozaki1", 4), ("ozaki1-4m", 3), ("ozaki2", 6),
                          ("ozaki2-3m", 8)):
        for out_bytes in (2, 4, 8):
            assert telemetry.modeled_gemm_bytes(
                scheme, count, 128, 256, 64, out_bytes) \
                == jtele.modeled_gemm_bytes(scheme, count, 128, 256, 64,
                                            out_bytes)
    assert telemetry.current_site() == "-"
    with telemetry.call_site("attn"):
        with telemetry.call_site("ffn"):
            assert telemetry.current_site() == "ffn"
        with telemetry.site_scope("-"):
            assert telemetry.current_site() == "attn"
        assert telemetry.current_site() == "attn"
    assert telemetry.current_site() == "-"


# ---------------------------------------------------------------------------
# The instrumented dispatch.
# ---------------------------------------------------------------------------

def test_disabled_records_nothing_and_enabled_is_bit_identical():
    telemetry.disable()
    a, b = t(_rand((32, 48), 1)), t(_rand((48, 16), 2))
    before = telemetry.REGISTRY.counter_snapshot()
    off = dispatch.emulated_matmul(a, b, cfg="ozaki1-p3")
    assert telemetry.REGISTRY.counter_snapshot() == before
    telemetry.enable()
    on = dispatch.emulated_matmul(a, b, cfg="ozaki1-p3")
    assert torch.equal(off, on)
    assert telemetry.REGISTRY.counter_snapshot() != before


def _counted(reg, names):
    return {n: reg.total(n) for n in names}


def test_call_counters_match_reference_eager_run():
    """The same 2-D, batched and prepared calls in both packages (the
    reference eager on its 'xla' backend): the same emulated calls, plan
    records, modeled bytes, prepared builds and consumes."""
    names = (rec.EMULATED_CALLS, rec.EMULATED_TRACES, rec.MODELED_HBM_BYTES,
             rec.MODELED_BYTES_TRACED, rec.PREPARED_BUILD,
             rec.PREPARED_CONSUME, rec.BATCHED_LAUNCHES)
    a, b = _rand((32, 48), 3), _rand((48, 16), 4)
    a3, b3 = _rand((2, 8, 48), 5), _rand((2, 48, 16), 6)
    telemetry.enable()
    jtele.enable()
    before = _counted(telemetry.REGISTRY, names), \
        _counted(jtele.REGISTRY, names)
    for spec in ("ozaki1-p3", "ozaki2-m6"):
        dispatch.emulated_matmul(t(a), t(b), cfg=spec)
        dispatch.emulated_matmul_batched(t(a3), t(b3), cfg=spec)
        prep = prepared.prepare_rhs(t(b), EmulationConfig.parse(spec))
        dispatch.emulated_matmul(t(a), prep, cfg=spec)
        jspec = spec + "@xla"
        jdispatch.emulated_matmul(jnp.asarray(a), jnp.asarray(b), cfg=jspec)
        jdispatch.emulated_matmul_batched(jnp.asarray(a3), jnp.asarray(b3),
                                          cfg=jspec)
        jprep = jprepared.prepare_rhs(jnp.asarray(b),
                                      EmulationConfig.parse(spec))
        jdispatch.emulated_matmul(jnp.asarray(a), jprep, cfg=jspec)
    after = _counted(telemetry.REGISTRY, names), \
        _counted(jtele.REGISTRY, names)
    delta = [{n: after[i][n] - before[i][n] for n in names}
             for i in range(2)]
    assert delta[0] == delta[1]
    assert delta[0][rec.EMULATED_CALLS] == 6
    assert delta[0][rec.BATCHED_LAUNCHES] == 2


def test_block_cache_counters():
    telemetry.enable()
    reg = telemetry.REGISTRY
    dispatch.block_cache_clear()
    hits0 = reg.total(rec.BLOCK_CACHE, result="hit")
    miss0 = reg.total(rec.BLOCK_CACHE, result="miss")
    a, b = t(_rand((40, 32), 7)), t(_rand((32, 24), 8))
    for _ in range(2):
        dispatch.emulated_matmul(a, b, cfg="ozaki1-p3@cuda")
    assert reg.total(rec.BLOCK_CACHE, result="miss") - miss0 == 1
    assert reg.total(rec.BLOCK_CACHE, result="hit") - hits0 == 1


def test_site_label_survives_the_backward():
    """The backward runs after the forward's call_site block has exited;
    it re-enters the captured site, so all three GEMMs carry it."""
    telemetry.enable()
    reg = telemetry.REGISTRY
    cfg = EmulationConfig(scheme="ozaki1", p=3)
    a = t(_rand((16, 32), 9)).requires_grad_()
    b = t(_rand((32, 8), 10)).requires_grad_()
    calls0 = reg.total(rec.EMULATED_CALLS, site="attn")
    unsited0 = reg.total(rec.EMULATED_CALLS, site="-")
    with telemetry.call_site("attn"):
        out = emulated_dot(a, b, cfg).sum()
    out.backward()
    assert reg.total(rec.EMULATED_CALLS, site="attn") == calls0 + 3
    assert reg.total(rec.EMULATED_CALLS, site="-") == unsited0
    tag = telemetry.gemm_tag("ozaki1", 3, "torch", "torch")
    assert reg.total(rec.MODELED_BYTES_TRACED, tag=tag, site="attn") > 0


def test_gemm_scope_only_under_a_profiler():
    """No profiler: a null context, nothing recorded. Under a profiler
    the call's tag names a range in the trace."""
    from contextlib import nullcontext
    assert isinstance(telemetry.gemm_scope("ozaki1", 4, "cuda", "kernel"),
                      nullcontext)
    a, b = t(_rand((16, 32), 11)), t(_rand((32, 8), 12))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dispatch.emulated_matmul(a, b, cfg="ozaki1-p3")
    names = {e.key for e in prof.key_averages()}
    assert "emugemm/ozaki1-p3/torch/torch" in names


# ---------------------------------------------------------------------------
# Step records, the report, the endpoint.
# ---------------------------------------------------------------------------

def test_step_tracker_jsonl_roundtrip(tmp_path, capsys):
    path = tmp_path / "steps.jsonl"
    with telemetry.recording(str(path)):
        tracker = telemetry.StepTracker()
        with telemetry.call_site("ffn"):
            dispatch.emulated_matmul(t(_rand((32, 32), 15)),
                                     t(_rand((32, 32), 16)), cfg="ozaki1-p3")
        tracker.step_metrics(0, 0.5, kind="train", tokens=1024, loss=3.25)
        dispatch.emulated_matmul(t(_rand((32, 32), 17)),
                                 t(_rand((32, 32), 18)), cfg="ozaki1-p3")
        tracker.step_metrics(1, 0.25, kind="train", tokens=1024)
    records = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(records) == 2
    assert all(r["record"] == "repro.telemetry/v1" for r in records)
    assert records[0]["loss"] == 3.25
    assert records[0]["tokens_per_s"] == pytest.approx(2048.0)
    assert records[0]["emulated_calls"] == records[1]["emulated_calls"] == 1
    assert records[0]["modeled_hbm_bytes"] == telemetry.modeled_gemm_bytes(
        "ozaki1", 3, 32, 32, 32)
    summary = report.aggregate(records)
    from repro.telemetry import report as jreport
    assert summary == jreport.aggregate(records) | {
        "prepared": summary["prepared"]}
    assert summary["steps"] == 2 and summary["kinds"] == {"train": 2}
    ffn = [r for r in summary["sites"] if r["site"] == "ffn"][0]
    assert (ffn["scheme"], ffn["backend"], ffn["calls"]) == (
        "ozaki1", "torch", 1)
    assert report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "ffn" in out and "steps=2" in out
    assert report.main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["steps"] == 2


def test_recording_scope_restores_state():
    telemetry.disable()
    with telemetry.recording() as reg:
        assert telemetry.enabled() and reg is telemetry.REGISTRY
    assert not telemetry.enabled()
    telemetry.enable()
    with telemetry.recording():
        pass
    assert telemetry.enabled()


def test_metrics_server_serves_registry():
    reg = MetricsRegistry()
    reg.inc(rec.EMULATED_CALLS, 7, {"backend": "cuda"})
    server = telemetry.serve_metrics(0, reg)
    try:
        url = f"http://127.0.0.1:{server.port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert resp.status == 200
            assert "0.0.4" in resp.headers["Content-Type"]
            body = resp.read().decode("utf-8")
        assert 'repro_emulated_calls_total{backend="cuda"} 7' in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/nope", timeout=5)
    finally:
        server.close()


# ---------------------------------------------------------------------------
# The guard and the fallback warnings on the registry.
# ---------------------------------------------------------------------------

def test_guard_stats_ride_on_registry():
    from repro_torch.guard import policy
    telemetry.enable()
    guard.stats_clear()
    telemetry.REGISTRY.inc(rec.EMULATED_CALLS, 1, {"backend": "torch"})
    base = telemetry.REGISTRY.total(rec.EMULATED_CALLS)
    policy.record("calls")
    policy.record("trips", 2)
    with telemetry.call_site("logits"):
        policy.record("trips")
    assert (guard.stats().calls, guard.stats().trips) == (1, 3)
    assert telemetry.REGISTRY.total(rec.GUARD_EVENTS, event="calls") == 1
    assert telemetry.REGISTRY.total(rec.GUARD_EVENTS, event="trips",
                                    site="logits") == 1
    guard.stats_clear()
    assert guard.stats() == guard.GuardStats()
    assert telemetry.REGISTRY.total(rec.EMULATED_CALLS) == base
    # Telemetry off: the guard still counts.
    telemetry.disable()
    a, b = t(_rand((8, 16), 1)), t(_rand((16, 4), 2))
    dispatch.emulated_matmul(a, b, cfg="ozaki1-p4+guard")
    assert guard.stats().calls == 1


def test_fallback_warning_once_via_registry():
    dispatch.fallback_warnings_clear()
    reason = ("guard", "spread", "ozaki1", 4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        dispatch._warn_fallback_once(reason, ((128, 128), (128, 128)), "m")
        dispatch._warn_fallback_once(reason, ((128, 128), (128, 128)), "m")
        dispatch._warn_fallback_once(reason, ((256, 256), (256, 256)), "m")
    assert len(w) == 2 and all(x.category is RuntimeWarning for x in w)
    dispatch.fallback_warnings_clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        dispatch._warn_fallback_once(reason, ((128, 128), (128, 128)), "m")
    assert len(w) == 1


# ---------------------------------------------------------------------------
# The engines and the CLIs.
# ---------------------------------------------------------------------------

ARCH = tconfigs.get_smoke_config("olmo-1b")


def test_continuous_engine_records(tmp_path):
    """One JSONL record a serve step, its emulated calls the step's, the
    gauges and the token and request counters."""
    path = tmp_path / "serve.jsonl"
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, ARCH.model.vocab, 5).tolist(),
                    max_new_tokens=3) for _ in range(2)]
    reg = telemetry.REGISTRY
    with telemetry.recording(str(path)):
        tok0 = reg.total(rec.SERVE_TOKENS)
        done0 = reg.total(rec.SERVE_REQUESTS, outcome="done")
        calls0 = reg.total(rec.EMULATED_CALLS)
        eng = ContinuousEngine(ARCH, max_seq=16, device="cpu", max_lanes=2,
                               chunk=4, page_size=4, policy=GemmPolicy(
                                   default=tapi.precision("ozaki1-p4")))
        eng.run(reqs)
        calls = reg.total(rec.EMULATED_CALLS) - calls0
    records = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(records) == eng.utilization()["steps"] > 0
    assert all(r["kind"] == "serve_step" for r in records)
    assert sum(r["emulated_calls"] for r in records) == calls > 0
    assert reg.total(rec.SERVE_TOKENS) - tok0 == 2 * 5 + 2 * 2
    assert reg.total(rec.SERVE_REQUESTS, outcome="done") - done0 == 2
    text = telemetry.render_prometheus()
    for name in (rec.SERVE_QUEUE_DEPTH, rec.SERVE_LANES_ACTIVE,
                 rec.SERVE_PAGE_OCCUPANCY, rec.SERVE_TTFT_SECONDS):
        assert name in text


def test_lockstep_engine_and_serve_cli_records(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli
    path = tmp_path / "lock.jsonl"
    with telemetry.recording(str(path)):
        eng = LockstepEngine(ARCH, None, 16, GemmPolicy(
            default=tapi.precision("ozaki1-p4+guard")), device="cpu")
        eng.generate(np.zeros((2, 4), np.int32), 3)
    (r,) = [json.loads(x) for x in path.read_text().splitlines()]
    assert r["kind"] == "serve" and r["extra"]["requests"] == 2
    assert eng.last_guard["calls"] == r["guard"]["calls"] > 0
    assert eng.last_guard["trips"] == 0
    cli = tmp_path / "cli.jsonl"
    telemetry.disable()
    serve_cli.main(["--arch", "olmo-1b", "--smoke", "--requests", "2",
                    "--prompt-len", "4", "--gen", "2", "--device", "cpu",
                    "--gemm", "ozaki1-p4+guard", "--metrics-jsonl",
                    str(cli)])
    out = capsys.readouterr().out
    assert "[serve] guard:" in out and "'trips': 0" in out
    steps = int(out.split("[serve] ")[1].split(" steps")[0])
    assert len(cli.read_text().splitlines()) == steps


def test_train_cli_metrics(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    path, prom = tmp_path / "train.jsonl", tmp_path / "train.prom"
    telemetry.disable()
    train_cli.main(["--arch", "olmo-1b", "--smoke", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--gemm",
                    "ozaki1-p4+guard:strict", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "ck"), "--metrics-jsonl",
                    str(path), "--metrics-prom", str(prom)])
    records = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert all(r["kind"] == "train" and r["tokens_per_s"] > 0
               and r["guard"]["calls"] > 0 and not r["guard"].get("trips")
               for r in records)
    text = prom.read_text()
    assert "repro_emulated_calls_total" in text and \
        "repro_guard_events_total" in text
    assert "metrics dumped" in capsys.readouterr().out
