"""Prometheus text exposition of the metrics registry
(``repro.telemetry.prometheus``).

:func:`render_prometheus` emits the text format (version 0.0.4): counters
and gauges as single samples, histogram summaries as ``_count``/``_sum``/
``_min``/``_max`` samples.  :func:`serve_metrics` serves it from a stdlib
``http.server`` daemon thread on ``GET /metrics`` at 127.0.0.1 (the
reference binds every interface) — wired to ``launch/serve.py
--metrics-port``; ``launch/train.py`` dumps the same text at exit.
"""

from __future__ import annotations

import http.server
import threading
from typing import Mapping

from repro_torch.telemetry.registry import REGISTRY, MetricsRegistry

_HELP = {
    "repro_emulated_calls_total": "Emulated GEMM executions by site/scheme/backend/impl.",
    "repro_emulated_traces_total": "Emulated GEMM plan events.",
    "repro_modeled_hbm_bytes_total": "Modeled fused HBM bytes (paper Eq. 10/15/18) per execution.",
    "repro_modeled_bytes_traced_total": "Modeled HBM bytes recorded at plan time, by emugemm tag.",
    "repro_modeled_collective_bytes_total": "Modeled collective bytes per device execution.",
    "repro_block_cache_total": "Block-selection cache lookups by result.",
    "repro_pad_total": "Traces that padded operands to meet backend alignment.",
    "repro_fallback_total": "Backend/impl fallback events with reasons.",
    "repro_prepared_consume_total": "Prepared-operand consume routes (fused kernel vs torch).",
    "repro_prepared_build_total": "Prepared-operand builds/rebuilds.",
    "repro_prepared_refusal_total": "Prepared-operand layout refusals.",
    "repro_guard_events_total": "Guard ladder events (guard.stats() backing store).",
    "repro_shard_partition_total": "shard_map GEMM partition kinds chosen.",
    "repro_step_seconds": "Per-step wall-clock seconds.",
    "repro_step_tokens_per_s": "Most recent decode throughput.",
}


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    f = float(value)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(registry: MetricsRegistry = REGISTRY) -> str:
    """Render the registry in Prometheus text exposition format."""
    snap = registry.snapshot()
    lines: list[str] = []
    seen_header: set[str] = set()

    def header(name: str, mtype: str) -> None:
        if name in seen_header:
            return
        seen_header.add(name)
        help_text = _HELP.get(name, name.replace("_", " "))
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")

    for item in snap["counters"]:
        header(item["name"], "counter")
        lines.append(
            f"{item['name']}{_fmt_labels(item['labels'])} "
            f"{_fmt_value(item['value'])}"
        )
    for item in snap["gauges"]:
        header(item["name"], "gauge")
        lines.append(
            f"{item['name']}{_fmt_labels(item['labels'])} "
            f"{_fmt_value(item['value'])}"
        )
    for item in snap["histograms"]:
        name = item["name"]
        header(name, "summary")
        labels = _fmt_labels(item["labels"])
        lines.append(f"{name}_count{labels} {_fmt_value(item['count'])}")
        lines.append(f"{name}_sum{labels} {_fmt_value(item['sum'])}")
        lines.append(f"{name}_min{labels} {_fmt_value(item['min'])}")
        lines.append(f"{name}_max{labels} {_fmt_value(item['max'])}")
    return "\n".join(lines) + ("\n" if lines else "")


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler name)
        if self.path.split("?")[0] not in ("/", "/metrics"):
            self.send_error(404)
            return
        body = render_prometheus(self.registry).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:  # keep serve stdout clean
        pass


class MetricsServer:
    """A daemon-threaded /metrics endpoint over the registry."""

    def __init__(self, port: int, registry: MetricsRegistry = REGISTRY) -> None:
        handler = type("Handler", (_MetricsHandler,), {"registry": registry})
        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", int(port)),
                                                      handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-torch-metrics", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_metrics(port: int, registry: MetricsRegistry = REGISTRY) -> MetricsServer:
    """Start serving ``GET /metrics`` on ``port`` (0 picks a free port)."""
    return MetricsServer(port, registry)
