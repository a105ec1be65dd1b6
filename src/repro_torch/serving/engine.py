"""Serving engines of the port (``repro.serving.engine``).

:class:`ContinuousEngine` executes the scheduler's fixed-shape plans —
a mixed ``(max_lanes, chunk)`` prefill+decode step and a
``(max_lanes, 1)`` pure-decode step — against a paged KV cache. A
lane's tokens are bit-identical whatever the rest of the cohort is
doing (every model row is computed independently), so continuous
batching changes throughput, never results.

:class:`LockstepEngine` is the reference's legacy whole-batch engine:
prefill the batch at once, then decode every lane in lockstep against
a contiguous cache.

When the policy caches weights (``+cached``) or ``prepare`` is asked
for, ``prepared.prepare_params`` prepares the 2-D dense weights once a
session, as the reference does; every step then streams the prepared
operand. Those are the untied heads (granite-3-8b, deepseek-coder-33b):
olmo-1b's projection weights are 3-D layer stacks and its head is the
tied embedding, so nothing is prepared there (ROADMAP.md § 3 R4);
recurrentgemma-2b's two unstacked tail blocks are 2-D and are.

:class:`ContinuousEngine` serves attention-family token models only: it
refuses up front (``NotImplementedError``) every arch with a rec / ssd
state or a window ring in its cache, and every stub front end, as the
reference's paged cache does. :class:`LockstepEngine` serves those with
a contiguous cache (recurrentgemma-2b, mamba2-780m; internvl2-1b on text
prompts).

On a live mesh of several ranks (``launch.mesh``; one process a rank,
every rank running the same requests) each rank holds the tiles of the
dense weights that ``parallel.sharding.tile_pspecs`` gives it, a
prepared head prepared from its own tile, and the whole paged cache and
activations; every dense projection runs partitioned over the ranks
(``parallel.shard_gemm``), and every rank samples the same tokens.

Per-request guard retry, as in the reference: the engine polls
``guard.stats()`` deltas per step, and a step whose delta shows a trip
or an escalation (or that raised ``EmulationAccuracyError`` under
``+guard:strict``) is re-run lane by lane (``_isolation_replay``), so
that the trip is charged to the request(s) that caused it
(``guard_trips`` in its result) and their outputs are recomputed; a
request that still fails strict after ``guard_retries`` attempts is
failed alone (``_fail_lane``). The reference's fast path is a jitted
step that only counts trips and keeps the pre-step pools; the port's
whole-cohort call and its per-lane replays run the same eager step
(``_step_fns``), whose 2-D GEMMs climb the ladder, and it scatters the
step's KV slots into the pools in place — a replay rewrites exactly those
slots of its lane, which the step's forward recomputes before it reads
them. With telemetry enabled both engines write one step record a step
(``telemetry.StepTracker``), and the continuous engine its queue, page
and lane gauges and token, request and latency counters.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import guard, telemetry
from repro_torch.core.precision import EmulationAccuracyError
from repro_torch.kernels import dispatch, prepared
from repro_torch.models import model as M
from repro_torch.serving.kv_cache import (SCRATCH_PAGE, PagedKVCache,
                                          check_pageable)
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import ScheduleConfig, Scheduler, StepPlan
from repro_torch.telemetry import record as _rec

_GUARD_FIELDS = ("calls", "trips", "escalations", "recoveries",
                 "native_fallbacks", "masked")


@dataclasses.dataclass
class RequestResult:
    rid: int
    status: str                    # done | failed
    tokens: list[int]
    ttft: float | None             # first token latency (s from arrival)
    tpot: float | None             # mean per-output-token latency (s)
    guard_trips: int
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
                   ttft=ttft, tpot=tpot, guard_trips=s.guard_trips,
                   evictions=s.evictions)


def _rank_device(device, mesh) -> torch.device:
    """The engine's device: on a live mesh under NCCL each rank's own card
    (``launch.mesh.rank_device``), else ``device`` as it is."""
    from repro_torch.launch import mesh as mesh_mod
    dev = M.resolve_device(device)
    if (dev.type == "cuda" and dev.index is None and mesh_mod.is_live(mesh)
            and torch.cuda.device_count() > 1):
        return mesh_mod.rank_device("cuda")
    return dev


def _place(params, policy):
    """Whole parameters given to an engine, as this rank holds them: on a
    policy that carries a mesh, each dense weight's tile
    (``parallel.sharding.tile_pspecs``), everything else whole; unchanged
    on one device. Seeded ones are drawn tile by tile
    (``models.model.init_rank_params``)."""
    if policy.mesh is None:
        return params
    from repro_torch.parallel import sharding
    return sharding.tile_params(params, policy.mesh)


class ContinuousEngine:
    def __init__(self, arch, mesh=None, *, max_seq: int, policy=None,
                 params=None, seed: int = 0, prepare: bool | None = None,
                 max_lanes: int = 4, chunk: int = 16, page_size: int = 16,
                 num_pages: int | None = None, queue_policy: str = "fcfs",
                 token_budget: int | None = None, guard_retries: int = 1,
                 guard_backoff: float = 0.0, wave_admission: bool = False,
                 clock=None, device="cuda"):
        check_pageable(arch.model)
        self.mesh = mesh
        self.device = _rank_device(device, mesh)
        self.arch = arch
        self.mcfg = arch.model
        self.policy = dispatch.resolve_policy(
            policy if policy is not None else arch.gemm_policy(), mesh)
        self.params = (_place(params, self.policy) if params is not None
                       else M.init_rank_params(self.mcfg, seed, self.device,
                                               self.policy.mesh))
        if prepare is None:       # auto: +cached specs stream preps
            prepare = prepared.policy_caches_weights(self.policy)
        self.prepared = bool(prepare)
        if self.prepared:
            self.params = prepared.prepare_params(self.params, self.policy)
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
        # The step of a whole cohort and of a per-lane replay alike.
        self._step_fns = {c: self._make_step(c) for c in {1, chunk}}
        self.guard_retries = guard_retries
        self.guard_backoff = guard_backoff
        self.last_guard: dict[str, int] = {}
        self._results: dict[int, RequestResult] = {}
        self._step_idx = 0
        self._busy_steps = 0
        self._queue_nonempty_steps = 0
        self._t0 = time.monotonic()
        self._clock = clock if clock is not None else (
            lambda: time.monotonic() - self._t0)
        self._tracker = telemetry.StepTracker() if telemetry.enabled() \
            else None

    # ---- the step -------------------------------------------------------

    def _make_step(self, c: int):
        kv, mcfg = self.kv, self.mcfg

        @torch.inference_mode()
        def step(params, pools, tables, tokens, start, n_new):
            """One forward over the gathered views; scatters the fresh KV
            slots back into the pools (in place) and returns the greedy
            tokens and the pools."""
            views = kv.gather(pools, tables)
            with guard.ladder.consensus(self.policy.mesh):
                logits, views = M.forward_step(params, mcfg, tokens, start,
                                               n_new, views, self.policy)
            pools = kv.scatter(pools, tables, views, start, n_new, c)
            return torch.argmax(logits[:, :mcfg.vocab], dim=-1), pools

        return step

    def _args(self, tables, tokens, start, n_new):
        dev = self.device
        return (self.params, self.pools, tables,
                torch.from_numpy(np.ascontiguousarray(tokens)).to(dev),
                torch.from_numpy(np.ascontiguousarray(start)).to(dev),
                torch.from_numpy(np.ascontiguousarray(n_new)).to(dev))

    def _guard_delta(self, before, raised: bool = False) -> dict[str, int]:
        """The guard counters' change since ``before``; ``raised`` (a strict
        raise) counts as a trip. On a mesh, the largest over the ranks,
        so that every rank replays (or not) together."""
        after = guard.stats()
        delta = {f: getattr(after, f) - getattr(before, f)
                 for f in _GUARD_FIELDS}
        delta["trips"] = max(delta["trips"], int(raised))
        return dict(zip(delta, guard.ladder.mesh_max(list(delta.values()),
                                                     self.policy.mesh)))

    def _execute(self, plan: StepPlan, tables) -> np.ndarray:
        before = guard.stats()
        raised = False
        try:
            tok, pools = self._step_fns[plan.chunk](*self._args(
                tables, plan.tokens, plan.start, plan.n_new))
            sampled = tok.to(torch.int32).cpu().numpy()
            self.pools = pools
        except EmulationAccuracyError:
            # A strict trip whose ladder ran out: fall straight to
            # per-lane isolation.
            raised = True
        delta = self._guard_delta(before, raised)
        self.last_guard = delta
        if delta.get("trips", 0) or delta.get("escalations", 0):
            sampled = self._isolation_replay(plan, tables)
        return sampled

    def _isolation_replay(self, plan: StepPlan, tables) -> np.ndarray:
        """Re-run the tripped step one lane at a time.

        The replay both *attributes* the trip to the request(s) that
        caused it and *recomputes* their outputs (the ladder's escalated
        precision or native fallback). Only still-failing strict lanes
        are failed; innocent cohort members keep their (identical,
        row-independent) results with zero retries.
        """
        b = len(plan.rids)
        sampled = np.zeros((b,), dtype=np.int32)
        scratch_row = torch.full((self.kv.view_pages,), SCRATCH_PAGE,
                                 dtype=tables.dtype, device=tables.device)
        for lane in range(b):
            if plan.rids[lane] is None:
                continue
            state = self.sched.lanes[lane]
            assert state is not None and state.rid == plan.rids[lane]
            t1 = torch.stack([tables[i] if i == lane else scratch_row
                              for i in range(b)])
            toks, st, nn = (np.zeros_like(x) for x in (plan.tokens,
                                                       plan.start,
                                                       plan.n_new))
            toks[lane], st[lane], nn[lane] = (plan.tokens[lane],
                                              plan.start[lane],
                                              plan.n_new[lane])
            attempt = 0
            while True:
                before = guard.stats()
                try:
                    tok, pools = self._step_fns[plan.chunk](*self._args(
                        t1, toks, st, nn))
                    raised = False
                except EmulationAccuracyError:
                    raised = True
                # A raise (every rank's at once) counts one trip.
                delta = self._guard_delta(before, raised)
                trips = 1 if raised else delta["trips"]
                if trips:
                    state.guard_trips += trips
                    _rec.record_event(_rec.SERVE_GUARD_TRIPS,
                                      {"rid": state.rid}, trips)
                if not raised:
                    sampled[lane] = int(tok[lane])
                    self.pools = pools
                    break
                if attempt >= self.guard_retries:
                    self._fail_lane(lane, state)
                    plan.rids[lane] = None
                    break
                attempt += 1
                if self.guard_backoff:
                    time.sleep(self.guard_backoff * attempt)
        return sampled

    def _fail_lane(self, lane: int, state: RequestState) -> None:
        state.status = "failed"
        state.finished_at = self._clock()
        self.kv.release(state.rid)
        self.sched.lanes[lane] = None
        self.sched.failed.append(state)
        self._results[state.rid] = RequestResult.of(state)
        _rec.record_event(_rec.SERVE_REQUESTS, {"outcome": "guard_failed"})

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
        evicted_before = self.sched.evictions
        plan = self.sched.plan(now)
        self._record_gauges(now)
        if plan is None:
            return None
        tables = self.kv.tables_for(plan.rids)
        t0 = time.perf_counter()
        sampled = self._execute(plan, tables)
        dt = time.perf_counter() - t0
        retired = self.sched.commit(plan, sampled, self._clock())
        self._record_step(plan, retired, dt,
                          self.sched.evictions - evicted_before)
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

    # ---- telemetry ------------------------------------------------------

    def _record_gauges(self, now: float) -> None:
        if not telemetry.enabled():
            return
        reg = telemetry.REGISTRY
        reg.set_gauge(_rec.SERVE_QUEUE_DEPTH, self.queue.depth(now))
        reg.set_gauge(_rec.SERVE_PAGE_OCCUPANCY,
                      self.kv.stats()["occupancy"])
        reg.set_gauge(_rec.SERVE_LANES_ACTIVE, len(self.sched.running()))

    def _record_step(self, plan: StepPlan, retired, dt: float,
                     evicted: int) -> None:
        for s in retired:
            self._results.setdefault(s.rid, RequestResult.of(s))
        if not telemetry.enabled():
            return
        reg = telemetry.REGISTRY
        n_pref = int(plan.n_new[plan.prefill].sum())
        n_dec = int(plan.n_new[~plan.prefill & (plan.n_new > 0)].sum())
        if n_pref:
            reg.inc(_rec.SERVE_TOKENS, n_pref, {"kind": "prefill"})
        if n_dec:
            reg.inc(_rec.SERVE_TOKENS, n_dec, {"kind": "decode"})
        if evicted:
            reg.inc(_rec.SERVE_EVICTIONS, evicted)
        for s in retired:
            if s.status == "done":
                reg.inc(_rec.SERVE_REQUESTS, 1, {"outcome": "done"})
            r = self._results[s.rid]
            if r.ttft is not None:
                reg.observe(_rec.SERVE_TTFT_SECONDS, r.ttft)
            if r.tpot is not None:
                reg.observe(_rec.SERVE_TPOT_SECONDS, r.tpot)
        if self._tracker is not None:
            self._tracker.step_metrics(
                self._step_idx, dt, kind="serve_step",
                tokens=plan.scheduled_tokens,
                extra={"lanes": int((plan.n_new > 0).sum()),
                       "chunk": plan.chunk,
                       "queue_depth": self.queue.depth(),
                       "page_occupancy": self.kv.stats()["occupancy"],
                       "guard_trips": self.last_guard.get("trips", 0)})

    def utilization(self) -> dict:
        """Deterministic schedule-quality counters."""
        return {"steps": self._step_idx,
                "busy_steps": self._busy_steps,
                "queue_nonempty_steps": self._queue_nonempty_steps,
                "evictions": self.sched.evictions,
                "admissions": self.sched.admissions,
                "kv": self.kv.stats()}


class LockstepEngine:
    """Legacy whole-batch engine: prefill the full batch once, decode all
    lanes in lockstep against a contiguous cache (``repro_torch.launch.
    serve.ServeEngine``). ``prepare`` prepares the dense weights once a
    session, as in the reference; unlike :class:`ContinuousEngine` it is
    never automatic."""

    def __init__(self, arch, mesh, max_seq: int, policy=None, params=None,
                 seed: int = 0, prepare: bool = False, guard_retries: int = 1,
                 guard_backoff: float = 0.25, device="cuda"):
        self.mesh = mesh
        self.device = _rank_device(device, mesh)
        self.arch = arch
        self.mcfg = arch.model
        self.max_seq = max_seq
        self.policy = dispatch.resolve_policy(
            policy if policy is not None else arch.gemm_policy(), mesh)
        self.params = (_place(params, self.policy) if params is not None
                       else M.init_rank_params(self.mcfg, seed, self.device,
                                               self.policy.mesh))
        self.prepared = bool(prepare)
        if self.prepared:
            self.params = prepared.prepare_params(self.params, self.policy)
        # ``last_guard`` holds the per-batch delta of the guard counters; a
        # strict accuracy trip retries the whole batch with backoff before
        # surfacing (ContinuousEngine narrows this to the request).
        self.guard_retries = guard_retries
        self.guard_backoff = guard_backoff
        self.last_guard: dict[str, int] = {}
        self._tracker = telemetry.StepTracker() if telemetry.enabled() \
            else None
        self._batches = 0

    @torch.inference_mode()
    def prefill(self, prompts: torch.Tensor):
        """(logits (B, 1, vocab_padded), cache) of a (B, S) prompt batch."""
        with guard.ladder.consensus(self.policy.mesh):
            return M.forward_prefill(self.params, self.mcfg,
                                     {"tokens": prompts}, self.max_seq,
                                     self.policy)

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, pos: int, cache):
        """One lockstep step: (B, 1) ids at position ``pos``."""
        with guard.ladder.consensus(self.policy.mesh):
            return M.forward_decode(self.params, self.mcfg, tokens, pos,
                                    cache, self.policy)

    def _greedy(self, logits):
        return torch.argmax(logits[:, -1:, :self.mcfg.vocab], dim=-1)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 greedy: bool = True) -> np.ndarray:
        """prompts: (B, S) int32. Returns (B, n_tokens) greedy ids.

        ``greedy`` is the reference's call form; as there, decoding is
        greedy whatever it says (the reference's argmax never reads it).
        A strict guard trip retries the batch ``guard_retries`` times, with
        backoff, before it surfaces; with telemetry enabled one step record
        (kind 'serve') a batch is written."""
        del greedy
        before = guard.stats()
        t0 = time.time()
        attempt = 0
        while True:
            try:
                toks = self._generate_once(prompts, n_tokens)
                break
            except EmulationAccuracyError as e:
                if attempt >= self.guard_retries:
                    raise
                attempt += 1
                pause = self.guard_backoff * attempt
                print(f"[serve] guard trip (retry {attempt}/"
                      f"{self.guard_retries} after {pause:.2f}s): {e}")
                time.sleep(pause)
        dt = time.time() - t0
        after = guard.stats()
        self.last_guard = {
            f: getattr(after, f) - getattr(before, f) for f in _GUARD_FIELDS}
        self.last_guard["retries"] = attempt
        if self._tracker is None and telemetry.enabled():
            self._tracker = telemetry.StepTracker()
        if self._tracker is not None:
            self._tracker.step_metrics(
                self._batches, dt, kind="serve",
                tokens=int(prompts.shape[0]) * int(n_tokens),
                extra={"requests": int(prompts.shape[0]),
                       "guard_retries": attempt})
        self._batches += 1
        return toks

    def _generate_once(self, prompts: np.ndarray, n_tokens: int
                       ) -> np.ndarray:
        s = prompts.shape[1]
        logits, cache = self.prefill(
            torch.as_tensor(prompts, dtype=torch.int32, device=self.device))
        tok = self._greedy(logits)
        out = [tok]
        for i in range(1, n_tokens):
            logits, cache = self.decode(tok, s + i - 1, cache)
            tok = self._greedy(logits)
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
