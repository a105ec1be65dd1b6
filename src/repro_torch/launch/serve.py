"""Serve CLI of the port: continuous batching over the EmuGEMM-I kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --gemm ozaki1-p4 --requests 8 --prompt-len 48 --gen 16

The flags are the reference's (``repro.launch.serve``) plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions). Flags whose
subsystem is not ported yet raise: ``--lockstep`` (the legacy engine),
``--metrics-port`` / ``--metrics-jsonl`` (telemetry, ROADMAP.md § 1
item 6).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import api, configs
from repro_torch.models.common import GemmPolicy
from repro_torch.serving import ContinuousEngine, Request


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
                    help="decompose dense weights once per session (a no-op "
                         "on olmo-1b, as in the reference)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--poisson", type=float, default=0.0)
    ap.add_argument("--queue-policy", default="fcfs", choices=("fcfs", "spf"))
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--lockstep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--metrics-jsonl", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    if args.lockstep:
        raise NotImplementedError("the legacy lockstep engine is not ported; "
                                  "the continuous engine serves")
    if args.metrics_port is not None or args.metrics_jsonl:
        raise NotImplementedError("telemetry is not ported yet (ROADMAP.md "
                                  "§ 1 item 6)")
    arch = (configs.get_smoke_config(args.arch) if args.smoke
            else configs.get_config(args.arch))
    rng = np.random.default_rng(args.seed)
    policy = (GemmPolicy(default=api.precision(args.gemm))
              if args.gemm else None)
    trace = build_trace(rng, arch.model.vocab, args.requests,
                        args.prompt_len, args.gen, args.poisson)
    eng = ContinuousEngine(
        arch, max_seq=args.prompt_len + args.gen, policy=policy,
        seed=args.seed, prepare=True if args.prepare else None,
        max_lanes=args.lanes, chunk=args.chunk, page_size=args.page_size,
        num_pages=args.num_pages, queue_policy=args.queue_policy,
        token_budget=args.token_budget, device=args.device)
    t0 = time.time()
    results = eng.run(trace)
    dt = time.time() - t0
    toks = [results[r.rid].tokens for r in trace if r.rid in results]
    util = eng.utilization()
    ttfts = [results[r.rid].ttft for r in trace
             if r.rid in results and results[r.rid].ttft is not None]
    print(f"[serve] {util['steps']} steps, {util['evictions']} evictions, "
          f"page high-water {util['kv']['high_water']}/"
          f"{util['kv']['num_pages']}, "
          + (f"ttft p50 {np.median(ttfts):.3f}s" if ttfts
             else "no tokens emitted"))
    print(f"[serve] {args.requests} requests x {args.gen} tokens in "
          f"{dt:.2f}s ({args.requests * args.gen / dt:.1f} tok/s)")
    if toks:
        print("[serve] sample:", toks[0][:12])
    return toks


if __name__ == "__main__":
    main()
