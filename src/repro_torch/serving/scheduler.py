"""Continuous-batching scheduler: lanes, admission, eviction, step plans
(the port's copy of ``repro.serving.scheduler``).

The engine compiles exactly two step shapes — a mixed ``(max_lanes,
chunk)`` step and a pure-decode ``(max_lanes, 1)`` step — and the
scheduler's job is to keep those fixed shapes full of useful work:

  * **Lanes** are batch rows. A request occupies one lane from admission
    to completion (or eviction); idle lanes ride along as padding with
    ``n_new = 0`` and all-scratch block tables.
  * **Chunked prefill**: a prefilling lane consumes up to ``chunk``
    prompt tokens per step; decode lanes consume exactly one. Both kinds
    share a single forward, so decode latency never waits behind a long
    prompt and prefill never needs a separate compiled shape.
  * **Admission** pops the arrival queue (FCFS or SPF, see
    repro_torch.serving.queue) while a free lane, the token budget, and one
    chunk's worth of pages are all available. Requests whose total
    footprint can never fit are failed up front instead of deadlocking.
  * **Eviction**: when a mid-flight lane cannot grow its page list, the
    running lane with the *latest* arrival is preempted — pages freed,
    request re-queued at its original arrival position, prompt + emitted
    tokens re-prefilled on re-admission. Only strictly-younger victims
    are ever evicted, so the globally oldest request always makes
    progress and no request starves.

Step accounting is position-exact: ``state.fed`` counts tokens written
into the paged cache; prefill feeds ``effective_prompt`` (original
prompt plus any tokens emitted before an eviction), and each decode step
feeds the newest emitted token at position ``fed``. Because every model
row is computed independently (see forward_step), a request's emitted
tokens are bit-identical whatever cohort, chunking, or eviction history
the scheduler produces — the property the serving tests pin down.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.queue import RequestQueue, RequestState


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    max_lanes: int = 4
    chunk: int = 16              # prefill tokens per lane per mixed step
    token_budget: int | None = None   # cap on sum of running total_tokens
    policy: str = "fcfs"              # queue pop policy: fcfs | spf
    spf_age_limit: float = 10.0

    def __post_init__(self):
        if self.max_lanes < 1 or self.chunk < 1:
            raise ValueError("max_lanes and chunk must be >= 1")


@dataclasses.dataclass
class StepPlan:
    """One fixed-shape forward: which lane feeds what, where."""

    rids: list          # lane -> rid | None
    tokens: np.ndarray  # (B, C) int32, left-aligned fresh token ids
    start: np.ndarray   # (B,) int32, absolute position of first fresh token
    n_new: np.ndarray   # (B,) int32, valid token count (0 for idle lanes)
    emit: np.ndarray    # (B,) bool, lane's sampled logit becomes a new token
    prefill: np.ndarray  # (B,) bool, lane fed prompt (vs generated) tokens
    chunk: int          # C — 1 for pure-decode plans, cfg.chunk otherwise

    @property
    def scheduled_tokens(self) -> int:
        return int(self.n_new.sum())


class Scheduler:
    def __init__(self, cfg: ScheduleConfig, kv: PagedKVCache,
                 queue: RequestQueue | None = None, wave: bool = False):
        self.cfg = cfg
        self.kv = kv
        self.queue = queue if queue is not None else RequestQueue(
            policy=cfg.policy, spf_age_limit=cfg.spf_age_limit)
        # Wave admission models the lockstep engine this subsystem
        # replaces: a new cohort is admitted only once every lane has
        # drained. Kept as the reference mode for the bench gate and the
        # per-request bit-identity tests.
        self.wave = wave
        self.lanes: list[RequestState | None] = [None] * cfg.max_lanes
        self.failed: list[RequestState] = []
        self.evictions = 0
        self.admissions = 0

    # ---- bookkeeping ----------------------------------------------------

    def running(self) -> list[RequestState]:
        return [s for s in self.lanes if s is not None]

    def has_work(self) -> bool:
        return any(self.lanes) or self.queue.pending() > 0

    def _running_token_load(self) -> int:
        return sum(s.request.total_tokens for s in self.running())

    def _fits_forever(self, state: RequestState) -> bool:
        total = state.request.total_tokens
        cap_pages = min(self.kv.num_pages - 1, self.kv.view_pages)
        return (self.kv.pages_needed(total) <= cap_pages
                and total <= self.kv.max_seq)

    def _next_step_tokens(self, state: RequestState) -> int:
        if state.prompt_consumed < state.prefill_len:
            return min(self.cfg.chunk,
                       state.prefill_len - state.prompt_consumed)
        return 1

    def _running_page_deficit(self) -> int:
        """Pages the running lanes still need for their *next* step.

        Admission must leave these free: otherwise a freshly admitted (or
        freshly evicted-and-requeued) request grabs the pages a starving
        lane's eviction just released, and admit/evict livelocks."""
        deficit = 0
        for s in self.running():
            need = self.kv.pages_needed(s.fed + self._next_step_tokens(s))
            deficit += max(0, need - len(self.kv.allocator.owned_by(s.rid)))
        return deficit

    # ---- admission ------------------------------------------------------

    def admit(self, now: float) -> int:
        admitted = 0
        while None in self.lanes:
            state = self.queue.pop_ready(now)
            if state is None:
                break
            if not self._fits_forever(state):
                state.status = "failed"
                state.finished_at = now
                self.failed.append(state)
                continue
            budget = self.cfg.token_budget
            if (budget is not None and self._running_token_load()
                    + state.request.total_tokens > budget):
                self.queue.requeue(state)
                break
            first = min(len(state.effective_prompt), self.cfg.chunk)
            need = self.kv.pages_needed(first)
            if (self.kv.allocator.free_pages - need
                    < self._running_page_deficit()
                    or not self.kv.ensure(state.rid, first)):
                self.queue.requeue(state)   # pages free up as lanes retire
                break
            lane = self.lanes.index(None)
            self.lanes[lane] = state
            state.status = "running"
            state.prefill_len = len(state.effective_prompt)
            state.fed = state.prompt_consumed
            if state.admitted_at is None:
                state.admitted_at = now
            self.admissions += 1
            admitted += 1
        return admitted

    # ---- eviction -------------------------------------------------------

    def _evict_for(self, starving: RequestState, now: float) -> bool:
        """Preempt the youngest running lane strictly younger than
        ``starving`` — in (arrival, rid) order, so simultaneous arrivals
        still totally order and the globally oldest request can always
        claim pages. Returns True if pages were freed."""
        key = lambda s: (s.request.arrival, s.rid)
        victims = [s for s in self.running()
                   if s is not starving and key(s) > key(starving)]
        if not victims:
            return False
        victim = max(victims, key=key)
        self._preempt(victim)
        return True

    def _preempt(self, victim: RequestState) -> None:
        lane = self.lanes.index(victim)
        self.lanes[lane] = None
        self.kv.release(victim.rid)
        victim.reset_for_requeue()
        self.queue.requeue(victim)
        self.evictions += 1

    # ---- planning -------------------------------------------------------

    def plan(self, now: float) -> StepPlan | None:
        if not self.wave or not any(self.lanes):
            self.admit(now)
        b, chunk = self.cfg.max_lanes, self.cfg.chunk
        # (lane, state, toks, emit, prefill); state captured because a
        # later lane's page pressure may evict an earlier entry mid-plan.
        want: list[tuple[int, RequestState, list[int], bool, bool]] = []
        for lane, state in enumerate(self.lanes):
            if state is None:
                continue
            if state.prompt_consumed < state.prefill_len:
                n = min(chunk, state.prefill_len - state.prompt_consumed)
                toks = list(state.effective_prompt[
                    state.prompt_consumed:state.prompt_consumed + n])
                emit = state.prompt_consumed + n >= state.prefill_len
                pf = True
            else:
                toks = [state.generated[-1]]
                emit = True
                pf = False
            if not self.kv.ensure(state.rid, state.fed + len(toks)):
                if self._evict_for(state, now) and self.kv.ensure(
                        state.rid, state.fed + len(toks)):
                    pass
                else:
                    continue        # stall this lane one step; pages drain
            want.append((lane, state, toks, emit, pf))
        want = [w for w in want if self.lanes[w[0]] is w[1]]   # drop evicted
        if not want:
            return None

        c = 1 if all(len(t) == 1 for _, _, t, _, _ in want) else chunk
        tokens = np.zeros((b, c), dtype=np.int32)
        start = np.zeros((b,), dtype=np.int32)
        n_new = np.zeros((b,), dtype=np.int32)
        emit = np.zeros((b,), dtype=bool)
        prefill = np.zeros((b,), dtype=bool)
        for lane, state, toks, em, pf in want:
            tokens[lane, :len(toks)] = toks
            start[lane] = state.fed
            n_new[lane] = len(toks)
            emit[lane] = em
            prefill[lane] = pf
        rids = [s.rid if s is not None and n_new[i] > 0 else None
                for i, s in enumerate(self.lanes)]
        return StepPlan(rids=rids, tokens=tokens, start=start, n_new=n_new,
                        emit=emit, prefill=prefill, chunk=c)

    # ---- commit ---------------------------------------------------------

    def commit(self, plan: StepPlan, sampled: np.ndarray, now: float
               ) -> list[RequestState]:
        """Apply one executed plan: advance positions, append emitted
        tokens, retire finished lanes. Returns the retired states."""
        retired = []
        for lane, state in enumerate(self.lanes):
            if state is None or plan.rids[lane] != state.rid:
                continue
            n = int(plan.n_new[lane])
            state.fed += n
            if state.prompt_consumed < state.prefill_len:
                state.prompt_consumed += n
            if plan.emit[lane]:
                state.generated.append(int(sampled[lane]))
                if state.first_token_at is None:
                    state.first_token_at = now
                if state.done:
                    state.status = "done"
                    state.finished_at = now
                    self.kv.release(state.rid)
                    self.lanes[lane] = None
                    retired.append(state)
        return retired

    # ---- invariants (exercised by tests) --------------------------------

    def check_invariants(self) -> None:
        live = {s.rid for s in self.running()}
        assert len(live) == len(self.running()), "duplicate lane occupancy"
        self.kv.allocator.check_leaks(live)
        for s in self.running():
            assert s.fed <= s.prefill_len + len(s.generated)
            assert len(self.kv.allocator.owned_by(s.rid)) >= \
                self.kv.pages_needed(s.fed), \
                f"request {s.rid}: fed {s.fed} tokens outruns its pages"
