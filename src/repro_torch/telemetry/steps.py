"""Per-step metrics records and the JSONL event sink
(``repro.telemetry.steps``).

``StepTracker`` snapshots the registry's counters and, once per step,
derives a :class:`StepMetrics` record from the *deltas* since the previous
step — emulated-call counts, modeled HBM/collective bytes, cache hit
ratios, guard/retry deltas — alongside wall-clock step time and tokens/s.
The Trainer and the serve engines each write one JSONL record per step
through :func:`jsonl_sink`; ``python -m repro_torch.telemetry.report``
aggregates the file back into the
per-site table.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, IO

from repro_torch.telemetry import record as _rec
from repro_torch.telemetry.registry import REGISTRY, LabelKey, MetricsRegistry

RECORD_VERSION = "repro.telemetry/v1"


@dataclasses.dataclass
class StepMetrics:
    """One JSONL record: a step's wall-clock + registry deltas."""

    step: int
    kind: str = "step"  # 'train' | 'serve' | 'cell' | 'step'
    seconds: float = 0.0
    tokens_per_s: float | None = None
    loss: float | None = None
    emulated_calls: float = 0.0
    modeled_hbm_bytes: float = 0.0
    modeled_collective_bytes: float = 0.0
    block_cache_hit_ratio: float | None = None
    prepared_hit_ratio: float | None = None
    guard: dict[str, float] = dataclasses.field(default_factory=dict)
    counters: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["record"] = RECORD_VERSION
        return d


class JsonlSink:
    """Append-mode JSONL writer; registered as a process-default sink."""

    def __init__(self, path: str, register: bool = True) -> None:
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh: IO[str] | None = open(self.path, "a", encoding="utf-8")
        if register:
            _SINKS.append(self)

    def write(self, record: StepMetrics | dict[str, Any]) -> None:
        payload = record.to_json() if isinstance(record, StepMetrics) else dict(record)
        line = json.dumps(payload, sort_keys=True, default=str)
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        if self in _SINKS:
            _SINKS.remove(self)

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


_SINKS: list[JsonlSink] = []


def jsonl_sink(path: str) -> JsonlSink:
    """Open ``path`` for appending and register it as a step-record sink."""
    return JsonlSink(path)


def emit(record: StepMetrics | dict[str, Any]) -> None:
    """Write a record to every registered sink."""
    for sink in list(_SINKS):
        sink.write(record)


def _delta(
    new: dict[tuple[str, LabelKey], float],
    old: dict[tuple[str, LabelKey], float],
) -> dict[tuple[str, LabelKey], float]:
    out: dict[tuple[str, LabelKey], float] = {}
    for key, value in new.items():
        d = value - old.get(key, 0.0)
        if d:
            out[key] = d
    return out


def _sum(deltas: dict[tuple[str, LabelKey], float], name: str,
         **where: str) -> float:
    total = 0.0
    for (n, lk), v in deltas.items():
        if n != name:
            continue
        d = dict(lk)
        if all(d.get(k) == str(val) for k, val in where.items()):
            total += v
    return total


def _ratio(hit: float, miss: float) -> float | None:
    total = hit + miss
    return hit / total if total else None


class StepTracker:
    """Derives per-step :class:`StepMetrics` from registry counter deltas."""

    def __init__(self, registry: MetricsRegistry = REGISTRY) -> None:
        self._registry = registry
        self._last = registry.counter_snapshot()

    def step_metrics(
        self,
        step: int,
        seconds: float,
        *,
        kind: str = "step",
        tokens: int | None = None,
        loss: float | None = None,
        extra: dict[str, Any] | None = None,
        write: bool = True,
    ) -> StepMetrics:
        now = self._registry.counter_snapshot()
        deltas = _delta(now, self._last)
        self._last = now

        guard = {}
        for (n, lk), v in deltas.items():
            if n == _rec.GUARD_EVENTS:
                event = dict(lk).get("event", "?")
                guard[event] = guard.get(event, 0.0) + v

        metrics = StepMetrics(
            step=int(step),
            kind=kind,
            seconds=float(seconds),
            tokens_per_s=(tokens / seconds if tokens and seconds > 0 else None),
            loss=loss,
            emulated_calls=_sum(deltas, _rec.EMULATED_CALLS),
            modeled_hbm_bytes=_sum(deltas, _rec.MODELED_HBM_BYTES),
            modeled_collective_bytes=_sum(deltas, _rec.MODELED_COLLECTIVE_BYTES),
            block_cache_hit_ratio=_ratio(
                _sum(deltas, _rec.BLOCK_CACHE, result="hit"),
                _sum(deltas, _rec.BLOCK_CACHE, result="miss"),
            ),
            prepared_hit_ratio=_ratio(
                _sum(deltas, _rec.PREPARED_CONSUME, route="fused"),
                _sum(deltas, _rec.PREPARED_CONSUME, route="torch"),
            ),
            guard=guard,
            counters=[
                {"name": n, "labels": dict(lk), "value": v}
                for (n, lk), v in sorted(deltas.items())
            ],
            extra=dict(extra or {}),
        )
        self._registry.observe(_rec.STEP_SECONDS, metrics.seconds,
                               {"kind": kind})
        if metrics.tokens_per_s is not None:
            self._registry.set_gauge(_rec.STEP_TOKENS_PER_S,
                                     metrics.tokens_per_s, {"kind": kind})
        if write:
            emit(metrics)
        return metrics
