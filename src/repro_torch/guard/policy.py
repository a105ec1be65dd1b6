"""Guard policy and the queryable trip statistics (``repro.guard.policy``).

``GuardPolicy`` is the resolved form of the ``+guard`` / ``+guard:strict``
spec suffixes (parsed into ``EmulationConfig.guard`` by core.precision):
it owns the verification knobs and the escalation-ladder shape.  The
guard counters live on the process-wide telemetry registry
(``repro_torch.telemetry.REGISTRY``, metric ``repro_guard_events_total``
labeled by event and call site) — the single counter store in the
process — whether or not hot-path telemetry is enabled.  :func:`stats` /
:func:`stats_clear` are the view the Trainer and the serve engines poll
between steps, and what tests assert on.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.precision import EmulationConfig
from repro_torch.telemetry import record as _tele
from repro_torch.telemetry.registry import REGISTRY


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Resolved guard behaviour for one emulated GEMM call-site.

    mode: 'on' — exhausted ladder falls back to the native dot (with a
      one-shot warning); 'strict' — exhausted ladder raises
      EmulationAccuracyError.
    probes: number of stochastic probe vectors for verify_gemm.
    tol_factor: safety factor on the analytic tolerance (the bound is a
      worst-case; 16x keeps the false-trip rate at zero on conditioned
      inputs while a single injected int8 bit flip overshoots it by
      orders of magnitude).
    escalate_bits: extra precision bits requested from plan_precision on
      the first ladder rung.
    """
    mode: str = "on"
    probes: int = 2
    tol_factor: float = 16.0
    escalate_bits: int = 8

    @classmethod
    def from_config(cls, cfg: EmulationConfig) -> "GuardPolicy | None":
        if cfg.guard is None:
            return None
        return cls(mode=cfg.guard)

    @property
    def strict(self) -> bool:
        return self.mode == "strict"


@dataclasses.dataclass(frozen=True)
class GuardStats:
    """Snapshot of the guard counters since the last ``stats_clear()``."""
    calls: int = 0            # guarded GEMMs executed
    verified: int = 0         # verifications that ran
    trips: int = 0            # verifications that missed the tolerance
    escalations: int = 0      # ladder rungs executed after a trip
    recoveries: int = 0       # trips whose retry verified clean
    native_fallbacks: int = 0 # ladders exhausted into the native dot
    masked: int = 0           # GEMMs with NaN/Inf lanes masked

    @property
    def tripped(self) -> bool:
        return self.trips > 0


def record(event: str, n: int = 1) -> None:
    """Bump one guard counter (thread-safe).  Events land on the telemetry
    registry labeled with the ambient call site, so per-site guard trip
    rates fall out of the same store ``guard.stats()`` sums over."""
    REGISTRY.inc(_tele.GUARD_EVENTS, int(n),
                 {"event": event, "site": _tele.current_site()})


def stats() -> GuardStats:
    """Queryable trip counter: a summed view over the registry's
    ``repro_guard_events_total`` series (all sites)."""
    known = {f.name for f in dataclasses.fields(GuardStats)}
    out = {}
    for labels, value in REGISTRY.series(_tele.GUARD_EVENTS):
        event = labels.get("event")
        if event in known:
            out[event] = out.get(event, 0) + int(value)
    return GuardStats(**out)


def stats_clear() -> None:
    REGISTRY.clear(_tele.GUARD_EVENTS)
