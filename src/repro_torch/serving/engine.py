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

Not ported from the reference: the guard retries (ROADMAP.md § 1 item
5; ``+guard`` specs are refused by ``dispatch.resolve_policy``) and the
telemetry records (item 6).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.kernels import dispatch, prepared
from repro_torch.models import model as M
from repro_torch.serving.kv_cache import PagedKVCache, check_pageable
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
        check_pageable(arch.model)
        self.device = M.resolve_device(device)
        self.arch = arch
        self.mcfg = arch.model
        self.policy = dispatch.resolve_policy(
            policy if policy is not None else arch.gemm_policy())
        self.params = params if params is not None else M.init_params(
            self.mcfg, seed, self.device)
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


class LockstepEngine:
    """Legacy whole-batch engine: prefill the full batch once, decode all
    lanes in lockstep against a contiguous cache (``repro_torch.launch.
    serve.ServeEngine``). ``prepare`` prepares the dense weights once a
    session, as in the reference; unlike :class:`ContinuousEngine` it is
    never automatic."""

    def __init__(self, arch, mesh, max_seq: int, policy=None, params=None,
                 seed: int = 0, prepare: bool = False, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet (ROADMAP.md § 1 "
                "item 8); the slice serves on one card")
        self.device = M.resolve_device(device)
        self.arch = arch
        self.mcfg = arch.model
        self.max_seq = max_seq
        self.policy = dispatch.resolve_policy(
            policy if policy is not None else arch.gemm_policy())
        self.params = params if params is not None else M.init_params(
            self.mcfg, seed, self.device)
        self.prepared = bool(prepare)
        if self.prepared:
            self.params = prepared.prepare_params(self.params, self.policy)

    @torch.inference_mode()
    def prefill(self, prompts: torch.Tensor):
        """(logits (B, 1, vocab_padded), cache) of a (B, S) prompt batch."""
        return M.forward_prefill(self.params, self.mcfg, {"tokens": prompts},
                                 self.max_seq, self.policy)

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, pos: int, cache):
        """One lockstep step: (B, 1) ids at position ``pos``."""
        return M.forward_decode(self.params, self.mcfg, tokens, pos, cache,
                                self.policy)

    def _greedy(self, logits):
        return torch.argmax(logits[:, -1:, :self.mcfg.vocab], dim=-1)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 greedy: bool = True) -> np.ndarray:
        """prompts: (B, S) int32. Returns (B, n_tokens) greedy ids.

        ``greedy`` is the reference's call form; as there, decoding is
        greedy whatever it says (the reference's argmax never reads it)."""
        del greedy
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
