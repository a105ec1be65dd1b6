"""Process-wide metrics registry of the port (``repro.telemetry.registry``).

One counter store per process: every layer that makes a routing decision
(dispatch, prepared consumption, the guard ladder, the trainer and serve
loops) records into the module-level :data:`REGISTRY`.

Two kinds of state live here, with different lifecycles:

* **The registry itself is always functional.**  ``guard.stats()`` and the
  one-shot fallback-warning bookkeeping are views over it, and those work
  whether or not telemetry is enabled.
* **Hot-path instrumentation is gated on :func:`enabled`.**  When telemetry
  is off (the default), the dispatch and prepared call sites do not touch
  the registry: a disabled check costs one global read.

Enable with :func:`enable`, the :func:`~repro_torch.telemetry.recording`
scope, or ``REPRO_TELEMETRY=1`` in the environment (read once at import;
the reference's variable, which names no package).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Any, Iterator, Mapping

ENV_VAR = "REPRO_TELEMETRY"
_TRUTHY = ("1", "true", "yes", "on")

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: Mapping[str, Any] | None) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class HistogramSummary:
    """Streaming summary of observed values (no bucket boundaries)."""

    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> dict[str, float]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }


class MetricsRegistry:
    """Thread-safe store of labeled counters, gauges and histograms.

    Metric identity is ``(name, frozenset of label items)``.  Label values
    are stringified on entry so numeric and string labels compare equal in
    queries and exports.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, LabelKey], float] = {}
        self._gauges: dict[tuple[str, LabelKey], float] = {}
        self._histograms: dict[tuple[str, LabelKey], HistogramSummary] = {}
        self._once: set[Any] = set()

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def inc(
        self,
        name: str,
        value: float = 1,
        labels: Mapping[str, Any] | None = None,
    ) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set_gauge(
        self,
        name: str,
        value: float,
        labels: Mapping[str, Any] | None = None,
    ) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def observe(
        self,
        name: str,
        value: float,
        labels: Mapping[str, Any] | None = None,
    ) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = HistogramSummary()
            hist.observe(value)

    # ------------------------------------------------------------------
    # one-shot bookkeeping (always active; backs _warn_fallback_once)
    # ------------------------------------------------------------------
    def once(self, key: Any) -> bool:
        """True the first time ``key`` is seen, False afterwards."""
        with self._lock:
            if key in self._once:
                return False
            self._once.add(key)
            return True

    def forget_once(self, prefix: Any = None) -> None:
        """Drop one-shot keys; tuple keys matching ``prefix[0]`` only, or all."""
        with self._lock:
            if prefix is None:
                self._once.clear()
            else:
                self._once = {
                    k
                    for k in self._once
                    if not (isinstance(k, tuple) and k and k[0] == prefix)
                }

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def _matches(self, key: LabelKey, where: Mapping[str, Any]) -> bool:
        if not where:
            return True
        d = dict(key)
        return all(d.get(str(k)) == str(v) for k, v in where.items())

    def total(self, name: str, **where: Any) -> float:
        """Sum of all counter series named ``name`` whose labels match."""
        with self._lock:
            return sum(
                v
                for (n, lk), v in self._counters.items()
                if n == name and self._matches(lk, where)
            )

    def counters(
        self, name: str | None = None, **where: Any
    ) -> dict[tuple[str, LabelKey], float]:
        with self._lock:
            return {
                (n, lk): v
                for (n, lk), v in self._counters.items()
                if (name is None or n == name) and self._matches(lk, where)
            }

    def series(self, name: str, **where: Any) -> Iterator[tuple[dict[str, str], float]]:
        for (_, lk), v in sorted(self.counters(name, **where).items()):
            yield dict(lk), v

    def snapshot(self) -> dict[str, Any]:
        """Deep copy of all metric state, JSON-friendly."""
        with self._lock:
            return {
                "counters": [
                    {"name": n, "labels": dict(lk), "value": v}
                    for (n, lk), v in sorted(self._counters.items())
                ],
                "gauges": [
                    {"name": n, "labels": dict(lk), "value": v}
                    for (n, lk), v in sorted(self._gauges.items())
                ],
                "histograms": [
                    {"name": n, "labels": dict(lk), **h.to_dict()}
                    for (n, lk), h in sorted(self._histograms.items())
                ],
            }

    def counter_snapshot(self) -> dict[tuple[str, LabelKey], float]:
        with self._lock:
            return dict(self._counters)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def clear(self, name_prefix: str | None = None) -> None:
        """Drop metric series; only those whose name starts with the prefix
        when one is given.  One-shot keys are untouched (see forget_once)."""
        with self._lock:
            if name_prefix is None:
                self._counters.clear()
                self._gauges.clear()
                self._histograms.clear()
                return
            for store in (self._counters, self._gauges, self._histograms):
                for key in [k for k in store if k[0].startswith(name_prefix)]:
                    del store[key]


#: The process-wide registry every instrumented layer records into.
REGISTRY = MetricsRegistry()

_enabled = os.environ.get(ENV_VAR, "").strip().lower() in _TRUTHY


def enabled() -> bool:
    """Whether hot-path telemetry instrumentation is active."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False
