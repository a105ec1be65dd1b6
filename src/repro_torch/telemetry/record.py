"""Instrumentation helpers: site context, labels, and recording primitives
(``repro.telemetry.record``).

The label schema is the reference's (docs/observability.md):

    site        logical call site ('attn', 'ffn', 'logits', 'emb', '-')
    scheme      emulation scheme ('ozaki1', 'ozaki2', 'ozaki2-3m', ...)
    backend     kernel backend that ran ('cuda', 'torch')
    impl        route ('kernel', 'torch', 'prepared-kernel',
                'prepared-torch')
    shape_class 'MxKxN' of the logical 2-D contraction, or 'BxMxKxN'
                when the call ran as one strided-batched launch
    mesh_shape  always '-': the port runs on one card

The reference records twice: trace-time counters while JAX traces, and
execution-time counters through ``jax.debug.callback``. The port is
eager, so every helper bumps both on every call, as the reference's
counters do when it runs eagerly.

Every helper is a no-op unless :func:`repro_torch.telemetry.enabled` —
checked first, before any label work. The port pads no operand and falls
back to no other backend, so nothing records ``PAD_EVENTS`` or
``FALLBACK_EVENTS``; their names stay for the reference's catalog.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator, Mapping

from repro_torch.telemetry import registry as _reg
from repro_torch.telemetry.registry import REGISTRY

# Metric names (the reference's catalog).
EMULATED_CALLS = "repro_emulated_calls_total"          # per execution
EMULATED_TRACES = "repro_emulated_traces_total"        # per plan
MODELED_HBM_BYTES = "repro_modeled_hbm_bytes_total"    # per execution
MODELED_BYTES_TRACED = "repro_modeled_bytes_traced_total"  # per plan, by tag
BLOCK_CACHE = "repro_block_cache_total"                # hit/miss, per lookup
PAD_EVENTS = "repro_pad_total"                         # per padded call
FALLBACK_EVENTS = "repro_fallback_total"               # per fallback, w/ reason
BATCHED_LAUNCHES = "repro_emulated_batched_launches_total"  # per batched call
PREPARED_CONSUME = "repro_prepared_consume_total"      # kernel vs torch routes
PREPARED_BUILD = "repro_prepared_build_total"          # prepare/rebuild calls
PREPARED_REFUSALS = "repro_prepared_refusal_total"     # layout refusals
GUARD_EVENTS = "repro_guard_events_total"              # guard.stats() backing
SHARD_PARTITION = "repro_shard_partition_total"        # partition kind chosen
MODELED_COLLECTIVE_BYTES = "repro_modeled_collective_bytes_total"
STEP_SECONDS = "repro_step_seconds"                    # histogram
STEP_TOKENS_PER_S = "repro_step_tokens_per_s"          # gauge

# Continuous-batching serve engine (repro_torch.serving).
SERVE_QUEUE_DEPTH = "repro_serve_queue_depth"          # gauge, per step
SERVE_PAGE_OCCUPANCY = "repro_serve_page_occupancy"    # gauge, 0..1
SERVE_LANES_ACTIVE = "repro_serve_lanes_active"        # gauge, per step
SERVE_TOKENS = "repro_serve_tokens_total"              # counter, kind label
SERVE_REQUESTS = "repro_serve_requests_total"          # counter, outcome label
SERVE_EVICTIONS = "repro_serve_evictions_total"        # counter
SERVE_GUARD_TRIPS = "repro_serve_guard_trips_total"    # counter, per request
SERVE_TTFT_SECONDS = "repro_serve_ttft_seconds"        # histogram
SERVE_TPOT_SECONDS = "repro_serve_tpot_seconds"        # histogram

enabled = _reg.enabled

_tls = threading.local()


def current_site() -> str:
    """Innermost ambient call-site label, '-' when none is set."""
    stack = getattr(_tls, "sites", None)
    return stack[-1] if stack else "-"


@contextlib.contextmanager
def call_site(name: str) -> Iterator[None]:
    """Label emulated calls inside the scope with ``site``."""
    stack = getattr(_tls, "sites", None)
    if stack is None:
        stack = _tls.sites = []
    stack.append(str(name))
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def site_scope(name: str) -> Iterator[None]:
    """Re-establish a previously captured site label ('-' is a no-op): the
    backward of an autograd function runs after the forward's
    ``call_site`` block has exited, so it re-enters the captured site."""
    if name == "-":
        yield
        return
    with call_site(name):
        yield


def shape_class(m: int, k: int, n: int, batch: int | None = None) -> str:
    """'MxKxN' of the 2-D contraction; 'BxMxKxN' for a strided-batched
    launch (``batch`` is its leading extent)."""
    core = f"{int(m)}x{int(k)}x{int(n)}"
    return core if batch is None else f"{int(batch)}x{core}"


def mesh_label(mesh_shape: Any = None) -> str:
    """Always '-': the port launches on one card, without a mesh."""
    return "-"


def gemm_tag(scheme: str, count: int, backend: str, impl: str) -> str:
    """Profiler scope tag: ``emugemm/<scheme>-<p|m><count>/<backend>/<impl>``.

    Scheme I counts mantissa slices (``p``); Scheme II counts moduli
    (``m``).
    """
    unit = "m" if scheme.startswith("ozaki2") else "p"
    return f"emugemm/{scheme}-{unit}{int(count)}/{backend}/{impl}"


def gemm_labels(
    scheme: str,
    backend: str,
    impl: str,
    m: int,
    k: int,
    n: int,
    mesh_shape: Any = None,
    batch: int | None = None,
) -> dict[str, str]:
    return {
        "site": current_site(),
        "scheme": scheme,
        "backend": backend,
        "impl": impl,
        "shape_class": shape_class(m, k, n, batch),
        "mesh_shape": mesh_label(mesh_shape),
    }


def modeled_gemm_bytes(
    scheme: str, count: int, m: int, k: int, n: int,
    out_bytes: int = 4, complex_3m: bool = False,
) -> int:
    """Modeled fused HBM bytes of one emulated GEMM (paper Eq. 10/15/18)."""
    from repro_torch.core import traffic

    s = traffic.GemmShape(int(m), int(n), int(k))
    if scheme.startswith("ozaki2"):
        complex_3m = complex_3m or scheme == "ozaki2-3m"
        per_mod = (
            traffic.scheme2_3m_fused_bytes_per_modulus(s)
            if complex_3m
            else traffic.scheme2_fused_bytes_per_modulus(s)
        )
        n_out = 2 if complex_3m else 1
        return int(count) * per_mod + n_out * out_bytes * s.m * s.n
    mult = 4 if scheme.endswith("-4m") else 1  # Scheme-I complex: 4 GEMMs
    return mult * traffic.scheme1_fused_bytes(s, int(count), out_bytes)


# Callables that get every recorded GEMM call (record_gemm), empty unless
# a measurement runs: utils.perf_probe and utils.roofline.analyze_step
# append one for their step and remove it after.
OBSERVERS: list[Callable[[dict], None]] = []


def record_gemm(
    *,
    scheme: str,
    count: int,
    backend: str,
    impl: str,
    m: int,
    k: int,
    n: int,
    mesh_shape: Any = None,
    out_bytes: int = 4,
    batch: int | None = None,
    in_bytes: int | None = None,
) -> None:
    """Record one emulated GEMM call: the plan counters (traces, modeled
    bytes by tag) and the execution counters (calls, modeled HBM bytes),
    both now. ``batch`` marks a strided-batched launch: it enters the
    shape class ('BxMxKxN') and multiplies the modeled bytes. Each of
    :data:`OBSERVERS` then gets the call's fields as a dict (tag, site,
    scheme, count, m, k, n, batch, out_bytes, ``in_bytes``: the operands'
    element size, modeled_bytes)."""
    if not _reg.enabled():
        return
    labels = gemm_labels(scheme, backend, impl, m, k, n, mesh_shape, batch)
    tag = gemm_tag(scheme, count, backend, impl)
    try:
        nbytes = modeled_gemm_bytes(scheme, count, m, k, n, out_bytes)
        nbytes *= batch or 1
    except Exception:
        nbytes = 0
    REGISTRY.inc(EMULATED_TRACES, 1, labels)
    if nbytes:
        REGISTRY.inc(MODELED_BYTES_TRACED, nbytes,
                     {"tag": tag, "site": labels["site"]})
    REGISTRY.inc(EMULATED_CALLS, 1, labels)
    if nbytes:
        REGISTRY.inc(MODELED_HBM_BYTES, nbytes, labels)
    for observe in OBSERVERS:
        observe({"tag": tag, "site": labels["site"], "scheme": scheme,
                 "count": int(count), "m": int(m), "k": int(k), "n": int(n),
                 "batch": batch, "out_bytes": int(out_bytes),
                 "in_bytes": in_bytes, "modeled_bytes": int(nbytes)})


def record_collective(kind: str, mesh_shape: Any, nbytes_per_device: int) -> None:
    """A modeled-collective-bytes bump (the port runs no collective yet,
    ROADMAP.md § 1 item 8; kept for the reference's surface)."""
    if not _reg.enabled() or not nbytes_per_device:
        return
    REGISTRY.inc(MODELED_COLLECTIVE_BYTES, int(nbytes_per_device), {
        "kind": kind, "mesh_shape": mesh_label(mesh_shape),
        "site": current_site()})


def record_event(name: str, labels: Mapping[str, Any] | None = None,
                 value: float = 1) -> None:
    """A counter bump, gated on :func:`enabled`."""
    if not _reg.enabled():
        return
    REGISTRY.inc(name, value, labels)
