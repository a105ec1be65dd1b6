"""repro_torch.telemetry — per-site emulation metrics, profiler
annotations, sinks (the port of the reference's telemetry package).

The one counter store in the process.  Hot-path instrumentation is a
no-op until enabled::

    import repro_torch

    repro_torch.telemetry.enable()            # or REPRO_TELEMETRY=1
    with repro_torch.telemetry.recording("steps.jsonl"):
        train(...)                            # scoped enable + JSONL sink

    print(repro_torch.telemetry.render_prometheus())

Layers record through :mod:`repro_torch.telemetry.record`; exports are the
JSONL step sink (:func:`jsonl_sink`, ``python -m
repro_torch.telemetry.report``) and the Prometheus text endpoint
(:func:`render_prometheus`, :func:`serve_metrics`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from repro_torch.telemetry.registry import (
    REGISTRY,
    MetricsRegistry,
    disable,
    enable,
    enabled,
)
from repro_torch.telemetry.record import (
    call_site,
    current_site,
    gemm_tag,
    mesh_label,
    modeled_gemm_bytes,
    record_collective,
    record_event,
    record_gemm,
    shape_class,
    site_scope,
)
from repro_torch.telemetry.trace import gemm_scope
from repro_torch.telemetry.steps import (
    JsonlSink,
    StepMetrics,
    StepTracker,
    emit,
    jsonl_sink,
)
from repro_torch.telemetry.prometheus import (
    MetricsServer,
    render_prometheus,
    serve_metrics,
)

__all__ = [
    "REGISTRY",
    "MetricsRegistry",
    "JsonlSink",
    "MetricsServer",
    "StepMetrics",
    "StepTracker",
    "call_site",
    "current_site",
    "disable",
    "emit",
    "enable",
    "enabled",
    "gemm_scope",
    "gemm_tag",
    "jsonl_sink",
    "mesh_label",
    "modeled_gemm_bytes",
    "record_collective",
    "record_event",
    "record_gemm",
    "recording",
    "render_prometheus",
    "serve_metrics",
    "shape_class",
    "site_scope",
]


@contextlib.contextmanager
def recording(jsonl: str | None = None) -> Iterator[MetricsRegistry]:
    """Enable telemetry for the scope (optionally with a JSONL sink).

    Restores the previous enabled/disabled state on exit; a sink opened
    for ``jsonl`` is closed.  Yields the process registry so callers can
    query it inline.
    """
    was_enabled = enabled()
    enable()
    sink = jsonl_sink(jsonl) if jsonl else None
    try:
        yield REGISTRY
    finally:
        if sink is not None:
            sink.close()
        if not was_enabled:
            disable()
