"""Serve CLI of the port: continuous batching over the emulated GEMMs.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --gemm ozaki1-p4 --requests 8 --prompt-len 48 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --smoke --lockstep --gemm ozaki1-p4+cached --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --smoke --lockstep --device cpu

The flags are the reference's (``repro.launch.serve``) plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).
``--lockstep`` runs the legacy whole-batch engine (``ServeEngine``), the
only one for recurrent blocks (recurrentgemma-2b, mamba2-780m: their
state caches are not paged) and the vision stub (internvl2-1b, text
prompts). An encoder-only arch (hubert-xlarge) exits: it has no decode.
``--prepare``, or a ``+cached`` spec on the continuous engine, prepares
the 2-D dense weights (an untied head) once a session. A guarded spec
(``--gemm ozaki1-p4+guard``) verifies every emulated GEMM and prints a
``[serve] guard:`` counter line; ``--metrics-jsonl FILE`` writes one
telemetry record a step (``python -m repro_torch.telemetry.report FILE``
aggregates it) and ``--metrics-port N`` serves Prometheus text on
127.0.0.1:N (both enable telemetry).

On N ranks (``torchrun --nproc-per-node N -m repro_torch.launch.serve
...``) the engines get ``make_host_mesh()``, the data-only mesh (N, 1),
as the reference's CLI builds it: every rank serves the same trace and
each dense call splits its rows over the ranks. Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import api, configs, guard, telemetry
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import GemmPolicy
from repro_torch.serving import ContinuousEngine, LockstepEngine, Request

# The reference's name for the legacy whole-batch engine.
ServeEngine = LockstepEngine


def build_trace(rng: np.random.Generator, vocab: int, requests: int,
                prompt_len: int, gen: int, poisson: float) -> list[Request]:
    """Uniform-random prompts; exponential(mean=``poisson``) interarrival
    gaps when ``poisson`` > 0, all-at-once otherwise."""
    arrivals = (np.cumsum(rng.exponential(poisson, requests))
                if poisson > 0 else np.zeros(requests))
    return [Request(prompt=rng.integers(0, vocab, prompt_len).tolist(),
                    max_new_tokens=gen, arrival=float(arrivals[i]))
            for i in range(requests)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--gemm", default=None,
                    help="precision spec (e.g. ozaki1-p4); omitted, the "
                         "ambient REPRO_TORCH_EMULATION env decides")
    ap.add_argument("--prepare", action="store_true",
                    help="prepare the 2-D dense weights (an untied head) "
                         "once per session; the continuous engine also does "
                         "so for +cached specs (a no-op on olmo-1b, as in "
                         "the reference)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--poisson", type=float, default=0.0)
    ap.add_argument("--queue-policy", default="fcfs", choices=("fcfs", "spf"))
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--lockstep", action="store_true",
                    help="run the legacy whole-batch engine instead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text-format metrics on this "
                         "port of 127.0.0.1 (GET /metrics; implies "
                         "telemetry; 0 picks a free port)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write one telemetry record per serve step to "
                         "this JSONL file (implies telemetry)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    metrics_server = sink = None
    if args.metrics_port is not None:
        telemetry.enable()
        metrics_server = telemetry.serve_metrics(args.metrics_port)
        print(f"[serve] metrics on http://127.0.0.1:"
              f"{metrics_server.port}/metrics")
    if args.metrics_jsonl:
        telemetry.enable()
        sink = telemetry.jsonl_sink(args.metrics_jsonl)
    try:
        return _serve(args)
    finally:
        if sink is not None:
            sink.close()
        if metrics_server is not None:
            metrics_server.close()


def _say(mesh):
    """print on rank 0 of a mesh (every rank serves the same trace)."""
    from repro_torch.launch.mesh import axis_index, axis_sizes, is_live
    if is_live(mesh) and axis_index(mesh, tuple(axis_sizes(mesh))) != 0:
        return lambda *a, **k: None
    return print


def _serve(args):
    arch = (configs.get_smoke_config(args.arch) if args.smoke
            else configs.get_config(args.arch))
    if not arch.model.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    mesh = make_host_mesh()
    say = _say(mesh)
    rng = np.random.default_rng(args.seed)
    policy = (GemmPolicy(default=api.precision(args.gemm))
              if args.gemm else None)
    max_seq = args.prompt_len + args.gen
    if args.lockstep:
        prompts = rng.integers(0, arch.model.vocab,
                               (args.requests, args.prompt_len)
                               ).astype(np.int32)
        eng = LockstepEngine(arch, mesh, max_seq, policy, seed=args.seed,
                             prepare=args.prepare, device=args.device)
        t0 = time.time()
        toks = eng.generate(prompts, args.gen).tolist()
        dt = time.time() - t0
        if eng.last_guard.get("calls"):
            say("[serve] guard:", eng.last_guard)
    else:
        trace = build_trace(rng, arch.model.vocab, args.requests,
                            args.prompt_len, args.gen, args.poisson)
        before = guard.stats()
        eng = ContinuousEngine(
            arch, mesh, max_seq=max_seq, policy=policy, seed=args.seed,
            prepare=True if args.prepare else None, max_lanes=args.lanes,
            chunk=args.chunk, page_size=args.page_size,
            num_pages=args.num_pages, queue_policy=args.queue_policy,
            token_budget=args.token_budget, device=args.device)
        t0 = time.time()
        results = eng.run(trace)
        dt = time.time() - t0
        toks = [results[r.rid].tokens for r in trace if r.rid in results]
        util = eng.utilization()
        ttfts = [results[r.rid].ttft for r in trace
                 if r.rid in results and results[r.rid].ttft is not None]
        say(f"[serve] {util['steps']} steps, {util['evictions']} "
              f"evictions, page high-water {util['kv']['high_water']}/"
              f"{util['kv']['num_pages']}, "
              + (f"ttft p50 {np.median(ttfts):.3f}s" if ttfts
                 else "no tokens emitted"))
        trips = sum(r.guard_trips for r in results.values())
        if trips:
            say(f"[serve] guard trips (per-request): {trips}")
        after = guard.stats()
        if after.calls > before.calls:
            say("[serve] guard:", {
                f: getattr(after, f) - getattr(before, f)
                for f in ("calls", "verified", "trips", "escalations",
                          "recoveries", "native_fallbacks", "masked")})
    say(f"[serve] {args.requests} requests x {args.gen} tokens in "
          f"{dt:.2f}s ({args.requests * args.gen / dt:.1f} tok/s)"
          + (" with prepared weights" if eng.prepared else ""))
    if toks:
        say("[serve] sample:", toks[0][:12])
    return toks


if __name__ == "__main__":
    main()
