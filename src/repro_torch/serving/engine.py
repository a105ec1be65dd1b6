"""Continuous-batching engine of the port (``repro.serving.engine``).

:class:`ContinuousEngine` executes the scheduler's fixed-shape plans —
a mixed ``(max_lanes, chunk)`` prefill+decode step and a
``(max_lanes, 1)`` pure-decode step — against a paged KV cache. A
lane's tokens are bit-identical whatever the rest of the cohort is
doing (every model row is computed independently), so continuous
batching changes throughput, never results.

Not ported from the reference: the per-request guard isolation replay
(ROADMAP.md § 1 item 5), telemetry (item 6) and the legacy
``LockstepEngine``. ``+cached`` prepares nothing on olmo-1b, as in the
reference (its projection weights are 3-D layer stacks and its head is
the tied embedding; ROADMAP.md § 3 R4).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.models import model as M
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import ScheduleConfig, Scheduler, StepPlan


@dataclasses.dataclass
class RequestResult:
    rid: int
    status: str                    # done | failed
    tokens: list[int]
    ttft: float | None             # first token latency (s from arrival)
    tpot: float | None             # mean per-output-token latency (s)
    evictions: int

    @classmethod
    def of(cls, s: RequestState) -> "RequestResult":
        arr = s.request.arrival
        ttft = (s.first_token_at - arr
                if s.first_token_at is not None else None)
        n = len(s.generated)
        tpot = None
        if n > 1 and s.finished_at is not None and s.first_token_at is not None:
            tpot = (s.finished_at - s.first_token_at) / (n - 1)
        return cls(rid=s.rid, status=s.status, tokens=list(s.generated),
                   ttft=ttft, tpot=tpot, evictions=s.evictions)


def _refuse_prepared(params) -> None:
    """The reference's ``prepare_params`` wraps 2-D dense weights only;
    olmo-1b has none (stacked layers, tied head), so preparing is a no-op
    there. Any architecture where it would do work needs the prepared-
    operand kernels, which are not ported."""
    if "head" in params:
        raise NotImplementedError(
            "prepared weights ('+cached' / --prepare on an untied head) "
            "are not ported yet (ROADMAP.md § 1 item 2)")


class ContinuousEngine:
    def __init__(self, arch, mesh=None, *, max_seq: int, policy=None,
                 params=None, seed: int = 0, prepare: bool | None = None,
                 max_lanes: int = 4, chunk: int = 16, page_size: int = 16,
                 num_pages: int | None = None, queue_policy: str = "fcfs",
                 token_budget: int | None = None,
                 wave_admission: bool = False, clock=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet (ROADMAP.md § 1 "
                "item 8); the slice serves on one card")
        self.device = M.resolve_device(device)
        self.arch = arch
        self.mcfg = arch.model
        self.policy = dispatch.resolve_policy(
            policy if policy is not None else arch.gemm_policy())
        self.params = params if params is not None else M.init_params(
            self.mcfg, seed, self.device)
        caches = any(c is not None and c.cache_weights for c in
                     [self.policy.default]
                     + [c for _, c in self.policy.overrides])
        self.prepared = bool(caches if prepare is None else prepare)
        if self.prepared:
            _refuse_prepared(self.params)
        if num_pages is None:     # worst case: every lane at max_seq
            num_pages = 1 + max_lanes * math.ceil(max_seq / page_size)
        self.kv = PagedKVCache(self.mcfg, page_size=page_size,
                               num_pages=num_pages, max_seq=max_seq,
                               chunk=chunk, device=self.device)
        self.pools = self.kv.init_pools()
        cfg = ScheduleConfig(max_lanes=max_lanes, chunk=chunk,
                             token_budget=token_budget, policy=queue_policy)
        self.sched = Scheduler(cfg, self.kv, wave=wave_admission)
        self.queue: RequestQueue = self.sched.queue
        self._results: dict[int, RequestResult] = {}
        self._step_idx = 0
        self._busy_steps = 0
        self._queue_nonempty_steps = 0
        self._t0 = time.monotonic()
        self._clock = clock if clock is not None else (
            lambda: time.monotonic() - self._t0)

    # ---- the step -------------------------------------------------------

    @torch.inference_mode()
    def step_fn(self, tables, tokens, start, n_new, chunk: int):
        """One forward over the gathered views; scatters the fresh KV
        slots back into the pools (in place) and returns greedy tokens."""
        views = self.kv.gather(self.pools, tables)
        logits, views = M.forward_step(self.params, self.mcfg, tokens, start,
                                       n_new, views, self.policy)
        self.kv.scatter(self.pools, tables, views, start, n_new, chunk)
        return torch.argmax(logits[:, :self.mcfg.vocab], dim=-1)

    def _execute(self, plan: StepPlan, tables) -> np.ndarray:
        dev = self.device
        tok = self.step_fn(tables,
                           torch.from_numpy(plan.tokens).to(dev),
                           torch.from_numpy(plan.start).to(dev),
                           torch.from_numpy(plan.n_new).to(dev), plan.chunk)
        return tok.to(torch.int32).cpu().numpy()

    # ---- request intake -------------------------------------------------

    def submit(self, request: Request) -> RequestState:
        return self.queue.submit(request)

    def reset_clock(self) -> None:
        """Re-zero the arrival/latency clock (e.g. after a warmup)."""
        self._t0 = time.monotonic()

    # ---- the serve loop -------------------------------------------------

    def step_once(self, now: float | None = None) -> StepPlan | None:
        """Plan + execute + commit one engine step. Returns the executed
        plan, or None when nothing was runnable at ``now``."""
        if now is None:
            now = self._clock()
        plan = self.sched.plan(now)
        if plan is None:
            return None
        tables = self.kv.tables_for(plan.rids)
        sampled = self._execute(plan, tables)
        for s in self.sched.commit(plan, sampled, self._clock()):
            self._results.setdefault(s.rid, RequestResult.of(s))
        self._step_idx += 1
        self._busy_steps += 1
        if self.queue.depth(now) > 0:
            self._queue_nonempty_steps += 1
        return plan

    def run(self, requests=None, max_steps: int | None = None
            ) -> dict[int, RequestResult]:
        """Serve to completion (wall clock; arrivals are seconds from
        engine start). Returns {rid: RequestResult}."""
        for r in requests or ():
            self.submit(r)
        steps = 0
        while self.sched.has_work():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"serve loop exceeded {max_steps} steps")
            now = self._clock()
            plan = self.step_once(now)
            steps += 1
            if plan is None:
                nxt = self.queue.next_arrival()
                if nxt is not None and nxt > now:
                    time.sleep(min(nxt - now, 0.05))
        return dict(self._results)

    def utilization(self) -> dict:
        """Deterministic schedule-quality counters."""
        return {"steps": self._step_idx,
                "busy_steps": self._busy_steps,
                "queue_nonempty_steps": self._queue_nonempty_steps,
                "evictions": self.sched.evictions,
                "admissions": self.sched.admissions,
                "kv": self.kv.stats()}
