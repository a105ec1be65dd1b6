"""Request admission queue for the continuous-batching serve engine
(the port's copy of ``repro.serving.queue``).

``RequestQueue`` is the thread-safe waiting room between request arrival
and scheduler admission: callers ``submit`` from any thread (or replay a
recorded arrival trace), the scheduler ``pop_ready`` holding its own
clock, and eviction puts preempted requests back at their *original*
arrival position — FCFS order is by arrival time, so an evicted request
never loses its place and no request starves behind later traffic.

Policies:
  fcfs — strict arrival order (the default; starvation-free)
  spf  — shortest-prompt-first among the *arrived* requests, with an
         ``spf_age_limit`` anti-starvation valve: once a request has
         waited that long it is served FCFS regardless of length.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Iterable

import numpy as np

_rid_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt ids in, ``max_new_tokens`` ids out."""

    prompt: tuple[int, ...]
    max_new_tokens: int
    arrival: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           tuple(int(t) for t in np.asarray(self.prompt)))
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class RequestState:
    """Mutable serving-side record of one request's lifecycle."""

    request: Request
    generated: list[int] = dataclasses.field(default_factory=list)
    prompt_consumed: int = 0     # prompt tokens already prefilled
    fed: int = 0                 # tokens written into the paged cache
    prefill_len: int = 0         # effective prompt length at admission
    guard_trips: int = 0         # strict accuracy trips charged to it
    evictions: int = 0
    status: str = "queued"       # queued|running|done|failed
    admitted_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.request.max_new_tokens

    def reset_for_requeue(self) -> None:
        """Eviction keeps emitted tokens (they were already served); on
        re-admission the prompt *plus* the emitted tokens are re-prefilled
        so decode continues exactly where it stopped."""
        self.prompt_consumed = 0
        self.fed = 0
        self.evictions += 1
        self.status = "queued"

    @property
    def effective_prompt(self) -> tuple[int, ...]:
        return self.request.prompt + tuple(self.generated)


class RequestQueue:
    """Arrival-ordered waiting room with pluggable pop policy."""

    def __init__(self, policy: str = "fcfs", spf_age_limit: float = 10.0):
        if policy not in ("fcfs", "spf"):
            raise ValueError(f"unknown queue policy {policy!r}")
        self.policy = policy
        self.spf_age_limit = float(spf_age_limit)
        self._lock = threading.Lock()
        self._waiting: list[RequestState] = []

    def submit(self, request: Request) -> RequestState:
        state = RequestState(request=request)
        self.requeue(state)
        return state

    def submit_all(self, requests: Iterable[Request]) -> list[RequestState]:
        return [self.submit(r) for r in requests]

    def requeue(self, state: RequestState) -> None:
        state.status = "queued"
        with self._lock:
            self._waiting.append(state)
            self._waiting.sort(key=lambda s: (s.request.arrival, s.rid))

    def depth(self, now: float | None = None) -> int:
        """Queued requests; with ``now``, only those that have arrived."""
        with self._lock:
            if now is None:
                return len(self._waiting)
            return sum(1 for s in self._waiting if s.request.arrival <= now)

    def __len__(self) -> int:
        return self.depth()

    def pending(self) -> int:
        """Everything still queued, arrived or not."""
        return self.depth()

    def next_arrival(self) -> float | None:
        """Earliest arrival among queued requests (None when empty)."""
        with self._lock:
            if not self._waiting:
                return None
            return min(s.request.arrival for s in self._waiting)

    def pop_ready(self, now: float) -> RequestState | None:
        """Next request to admit under the policy, or None."""
        with self._lock:
            arrived = [s for s in self._waiting if s.request.arrival <= now]
            if not arrived:
                return None
            pick = arrived[0]           # FCFS: oldest arrival
            if self.policy == "spf":
                aged = now - pick.request.arrival >= self.spf_age_limit
                if not aged:
                    pick = min(arrived,
                               key=lambda s: (len(s.effective_prompt),
                                              s.request.arrival, s.rid))
            self._waiting.remove(pick)
            return pick
