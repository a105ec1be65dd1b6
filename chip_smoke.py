"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives repro_torch only (no jax, nothing of the reference package) on the
card, with no CPU fallback, in five phases:

1. build: nvcc compiles the port's CUDA kernels from this checkout;
2. kernel: every kernel of the serving path is held against its plain
   version bit for bit at the path's shapes (float32 and bfloat16,
   p in {3, 4, 6}), and timed beside its bound;
3. serve: the continuous-batching engine serves 8 requests (prompt 48,
   16 new tokens, 4 lanes, chunk 16, page 16) on full-width olmo-1b with
   seeded random weights under ozaki1-p4; the kernel's launch counts are
   read around that run, and request 0 served alone must give the same
   tokens as in the cohort;
4. parity: one full-width mixed step on the 'cuda' backend and on the
   'torch' backend (the plain versions) gives bit-identical logits;
5. profile: wall time of a mixed and a decode step under ozaki1-p4 and
   native, with the device-busy share and device time by kernel from
   torch.profiler.

Any failure exits non-zero and prints no result. The line before the
last is a JSON object listing each kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.core import scheme1  # noqa: E402
from repro_torch.kernels import build, ozaki1  # noqa: E402
from repro_torch.launch.serve import build_trace  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import GemmPolicy, pad_vocab  # noqa: E402
from repro_torch.serving import ContinuousEngine, Request  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
L2_BYTES = 50 * 2 ** 20

SOURCE = "src/repro_torch/kernels/csrc/emugemm1.cu"
SPEC = "ozaki1-p4"
P_MAIN = 4
REQUESTS, PROMPT, GEN, LANES, CHUNK, PAGE = 8, 48, 16, 4, 16, 16


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(batch, m, k, n, p, in_bytes, out_bytes):
    """Least time for the work: each input read once (operands and the
    scales), each output written once, against p(p+1)/2 int8 GEMMs at
    the int8 peak. Returns (ms, 'bytes' | 'operations')."""
    moved = batch * (in_bytes * (m * k + k * n) + 4 * (m + n)
                     + out_bytes * m * n)
    ops = batch * p * (p + 1) // 2 * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def conditioned(gen, shape, dtype, device):
    """Paper Eq. 19 matrices, (rand - 0.5) * exp(2 randn)."""
    x = (torch.rand(shape, generator=gen, device=device) - 0.5) * torch.exp(
        2 * torch.randn(shape, generator=gen, device=device))
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def path_shapes(mcfg, view_tokens, chunk):
    """The emulated GEMMs of one serve step of 4 lanes x ``chunk`` tokens
    (CHUNK: a mixed step, 1: a decode step), with their launch counts:
    (kind, batch, m, k, n, b_transposed, count)."""
    d, f, L = mcfg.d_model, mcfg.d_ff, mcfg.n_layers
    hd = mcfg.resolved_head_dim
    m = LANES * chunk
    bkv = LANES * mcfg.n_kv_heads
    g = mcfg.n_heads // mcfg.n_kv_heads
    vp = pad_vocab(mcfg.vocab)
    return [
        ("2d", 1, m, d, d, False, 4 * L),           # q, k, v, o
        ("2d", 1, m, d, f, False, 2 * L),           # gate, up
        ("2d", 1, m, f, d, False, L),               # down
        ("2d", 1, LANES, d, vp, True, 1),           # logits: x @ emb.T
        ("batched", bkv, chunk * g, hd, view_tokens, False, L),   # attn_qk
        ("batched", bkv, chunk * g, view_tokens, hd, False, L),   # attn_av
    ]


def kernel_phase(dev, mcfg, view_tokens):
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {"2d": 0.0, "batched": 0.0}
    checks = 0
    mixed = path_shapes(mcfg, view_tokens, CHUNK)
    decode = path_shapes(mcfg, view_tokens, 1)
    # Bit-identity at every path shape, every 2-D one at M = 4 (a decode
    # step) and M = 64 (a mixed step), and on a ragged shape, for both
    # operand types and p in {3, 4, 6}.
    cases = [(kind, bt, mm, k, n, tr) for kind, bt, m, k, n, tr, _ in mixed
             for mm in ((4, LANES * CHUNK) if kind == "2d" else (m,))]
    cases += [(kind, bt, m, k, n, tr) for kind, bt, m, k, n, tr, _ in decode
              if kind == "batched"]
    cases.append(("2d", 1, 37, 1000, 77, True))
    for dtype in (torch.float32, torch.bfloat16):
        for p in (3, 4, 6):
            for kind, bt, m, k, n, tr in cases:
                lead = () if kind == "2d" else (bt,)
                a = conditioned(gen, lead + (m, k), dtype, dev)
                b = (conditioned(gen, lead + (n, k), dtype, dev).transpose(-1, -2)
                     if tr else conditioned(gen, lead + (k, n), dtype, dev))
                mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
                out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7, dtype)
                ref = ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7, dtype)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                max_err[kind] = max(max_err[kind], err)
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"kernel != plain version: {kind} {(bt, m, k, n)} "
                        f"transposed={tr} {dtype} p={p}, max |diff| {err}")
                checks += 1
    log(f"[kernel] {checks} shape/type/p cases bit-identical to the plain "
        "version")

    # Timing at the main path's configuration (bf16, p = 4), per shape and
    # summed over one mixed and one decode step's launches.
    totals = {(step, kind): {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                             "bytes_ms": 0.0, "ops_ms": 0.0,
                             "yardstick_ms": 0.0}
              for step in ("mixed", "decode") for kind in ("2d", "batched")}
    bf = torch.bfloat16
    steps = [("mixed", sh) for sh in mixed] + [("decode", sh) for sh in decode]
    timed = {}
    for step, (kind, bt, m, k, n, tr, count) in steps:
        key = (kind, bt, m, k, n, tr)
        if key in timed:             # the logits GEMM is the same in both
            ms, plain, yard, bms, by = timed[key]
            _add(totals[step, kind], count, ms, plain, yard, bms, by)
            continue
        lead = () if kind == "2d" else (bt,)
        nbytes = 2 * bt * k * n
        # Rotate weight copies past the 50 MB L2, as a serve step finds
        # each weight cold.
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes)) if kind == "2d" else 1
        a = conditioned(gen, lead + (m, k), bf, dev)
        bs = [(conditioned(gen, lead + (n, k), bf, dev).transpose(-1, -2)
               if tr else conditioned(gen, lead + (k, n), bf, dev))
              for _ in range(copies)]
        mu = scheme1.pow2_scale(a, -1)
        nus = [scheme1.pow2_scale(b, -2) for b in bs]
        it = iter(range(10 ** 9))

        def run_kernel():
            i = next(it) % copies
            ozaki1.fused_matmul_scheme1(a, bs[i], mu, nus[i], P_MAIN, 7, bf)

        def run_plain():
            i = next(it) % copies
            ozaki1.fused_matmul_plain(a, bs[i], mu, nus[i], P_MAIN, 7, bf)

        # Library yardstick, not a kernel of the port: p(p+1)/2 int8 GEMMs
        # through torch._int_mm (which needs more than 16 rows, so M is
        # raised to 32 where smaller).
        my = max(m, 32)
        ai = torch.randint(-127, 128, lead + (my, k), generator=gen,
                           device=dev, dtype=torch.int8)
        bi = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        n_mm = P_MAIN * (P_MAIN + 1) // 2

        def run_yardstick():
            for _ in range(n_mm):
                if kind == "2d":
                    torch._int_mm(ai, bi)
                else:
                    for j in range(bt):
                        torch._int_mm(ai[j], bi)

        ms = time_ms(run_kernel, 20)
        plain = time_ms(run_plain, 3)
        yard = time_ms(run_yardstick, 5)
        bms, by = bound_ms(bt, m, k, n, P_MAIN, 2, 2)
        timed[key] = (ms, plain, yard, bms, by)
        _add(totals[step, kind], count, ms, plain, yard, bms, by)
        log(f"[kernel] {kind} B={bt} M={m} K={k} N={n}"
            f"{' (B transposed)' if tr else ''} x{count}/{step} step: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
            f"({by}), yardstick torch._int_mm x{n_mm} {yard:.4f} ms")
    for (step, kind), t in totals.items():
        log(f"[kernel] {kind} per {step} step: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms, "
            f"yardstick {t['yardstick_ms']:.3f} ms")
    return max_err, totals


def _add(t, count, ms, plain, yard, bms, by):
    t["ms"] += count * ms
    t["plain_ms"] += count * plain
    t["bound_ms"] += count * bms
    t["yardstick_ms"] += count * yard
    t["bytes_ms" if by == "bytes" else "ops_ms"] += count * bms


# ---------------------------------------------------------------------------
# Phases 3 and 4: serve, and backend parity.
# ---------------------------------------------------------------------------

def serve_phase(dev, arch, policy):
    eng = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy, seed=0,
                           max_lanes=LANES, chunk=CHUNK, page_size=PAGE,
                           device=dev)
    trace = build_trace(np.random.default_rng(0), arch.model.vocab, REQUESTS,
                        PROMPT, GEN, 0.0)
    torch.cuda.synchronize()
    eng.reset_clock()
    ozaki1.COUNTS.reset()
    t0 = time.perf_counter()
    results = eng.run(trace)
    dt = time.perf_counter() - t0
    counts = ozaki1.LaunchCounts(**vars(ozaki1.COUNTS))
    util = eng.utilization()
    toks = [results[r.rid].tokens for r in trace]
    ttft = float(np.median([results[r.rid].ttft for r in trace]))
    log(f"[serve] {util['steps']} steps, {REQUESTS} requests x {GEN} tokens "
        f"in {dt:.3f} s ({REQUESTS * GEN / dt:.1f} tok/s), ttft p50 "
        f"{ttft:.3f} s, launches: 2-D {counts.launches_2d}, batched "
        f"{counts.launches_batched}, plain version on CUDA "
        f"{counts.plain_cuda_calls}")
    if counts.launches_2d == 0 or counts.launches_batched == 0:
        raise AssertionError("the serve path did not launch the kernel")
    if counts.plain_cuda_calls != 0:
        raise AssertionError("the serve path ran the plain version on CUDA")
    if not all(len(t) == GEN and all(0 <= x < arch.model.vocab for x in t)
               for t in toks):
        raise AssertionError(f"malformed tokens {toks}")
    # Request 0 alone gives the tokens it got in the cohort.
    alone = ContinuousEngine(arch, max_seq=PROMPT + GEN, policy=policy,
                             params=eng.params, max_lanes=LANES, chunk=CHUNK,
                             page_size=PAGE, device=dev)
    r0 = Request(prompt=trace[0].prompt, max_new_tokens=GEN)
    if alone.run([r0])[r0.rid].tokens != toks[0]:
        raise AssertionError("request 0 alone differs from the cohort")
    log(f"[serve] request 0 alone == in cohort; sample {toks[0][:8]}")
    return eng, counts, {"steps": util["steps"], "seconds": dt,
                         "tok_per_s": REQUESTS * GEN / dt, "ttft_p50_s": ttft}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def parity_phase(dev, arch, params, view_tokens):
    mcfg = arch.model
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, mcfg.vocab, (LANES, CHUNK), generator=gen,
                           device=dev, dtype=torch.int32)
    start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
    n_new = torch.tensor([16, 16, 5, 1], device=dev, dtype=torch.int32)
    cache = M.init_cache(mcfg, LANES, view_tokens, dev)
    for leaf in cache["layers"]["b0"].values():
        leaf.normal_(generator=gen)
    logits = {}
    runs = ((SPEC + "@cuda", params), (SPEC + "@torch", params),
            ("native", params),
            ("native-f32", tree_map(lambda x: x.float(), params)))
    with torch.inference_mode():
        for name, prm in runs:
            views = {"layers": {"b0": {
                k: v.clone().to(prm["emb"].dtype)
                for k, v in cache["layers"]["b0"].items()}}}
            pol = GemmPolicy(default=api.precision(name.split("-")[0]
                                                   if name.startswith("native")
                                                   else name))
            logits[name], _ = M.forward_step(prm, mcfg, tokens, start,
                                             n_new, views, pol)
    torch.cuda.synchronize()
    a, b = logits[SPEC + "@cuda"], logits[SPEC + "@torch"]
    if not torch.equal(a, b):
        raise AssertionError("full-width logits differ between the cuda and "
                             "torch backends: max |diff| "
                             f"{(a.float() - b.float()).abs().max().item()}")
    if not torch.isfinite(a).all() or a.shape != (LANES,
                                                  pad_vocab(mcfg.vocab)):
        raise AssertionError(f"bad logits {a.shape}")
    # Against a float32 reference forward, the emulated bf16 model must be
    # about as close as the native bf16 model (both round every GEMM
    # output to bf16; the emulation rounds up to p more times).
    ref = logits["native-f32"]

    def rel(x):
        return ((x.float() - ref).norm() / ref.norm()).item()

    rel_emu, rel_nat = rel(a), rel(logits["native"])
    log(f"[parity] full-width mixed step: cuda == torch backend logits bit "
        f"for bit; relative distance to a float32 forward: {SPEC} bf16 "
        f"{rel_emu:.3e}, native bf16 {rel_nat:.3e}")
    if not rel_emu <= max(4 * rel_nat, 1e-3):
        raise AssertionError(f"emulated logits far from the float32 "
                             f"reference: {rel_emu} vs native {rel_nat}")
    return {"rel_f32_emulated": rel_emu, "rel_f32_native_bf16": rel_nat}


def profile_phase(dev, arch, params, view_tokens):
    """Where one serve step's time goes: host wall time of a mixed and a
    decode step under ozaki1-p4 and native, and under torch.profiler the
    device-busy share and device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mcfg = arch.model
    start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
    report = {}
    for step_kind, c, n_new in (("mixed", CHUNK, [16, 16, 5, 1]),
                                ("decode", 1, [1, 1, 1, 1])):
        tokens = torch.ones((LANES, c), device=dev, dtype=torch.int32)
        nn = torch.tensor(n_new, device=dev, dtype=torch.int32)
        cache = M.init_cache(mcfg, LANES, view_tokens, dev)
        for spec in (SPEC, "native"):
            pol = GemmPolicy(default=api.precision(spec))

            def step():
                with torch.inference_mode():
                    M.forward_step(params, mcfg, tokens, start, nn, cache, pol)
                torch.cuda.synchronize()

            step()
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                prof_wall_ms = (time.perf_counter() - t0) * 1e3
            spans, by_name = [], {}
            for e in prof.events():
                if e.device_type != DeviceType.CUDA:
                    continue
                s, t = e.time_range.start, e.time_range.end
                spans.append((s, t))
                by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e3
            busy, end = 0.0, -math.inf
            for s, t in sorted(spans):          # union of kernel intervals
                if t > end:
                    busy += t - max(s, end)
                    end = t
            busy_ms = busy / 1e3
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            entry = {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
                     "device_busy_ms": busy_ms if spans else None,
                     "idle_share": (1 - busy_ms / prof_wall_ms) if spans
                     else None,
                     "top_device_ms": {k[:60]: v for k, v in top}}
            report[f"{step_kind}/{spec}"] = entry
            log(f"[profile] {step_kind} step, {spec}: " + json.dumps(entry))
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    t0 = time.perf_counter()
    build.build("emugemm1")
    log(f"[build] emugemm1.cu built in {time.perf_counter() - t0:.1f} s")

    arch = configs.get_config("olmo-1b")
    view_tokens = PAGE * math.ceil((PROMPT + GEN - 1 + CHUNK) / PAGE)
    max_err, totals = kernel_phase(dev, arch.model, view_tokens)
    eng, counts, serve = serve_phase(
        dev, arch, GemmPolicy(default=api.precision(SPEC)))
    serve.update(parity_phase(dev, arch, eng.params, view_tokens))
    log("[serve] summary " + json.dumps(serve))
    profile_phase(dev, arch, eng.params, view_tokens)

    common = {"route": "cuda", "source": SOURCE, "library_ms": None}
    kernels = []
    for kind, name, replaces, launches in (
            ("2d", "emugemm1_2d", "src/repro/kernels/ozaki1.py:143",
             counts.launches_2d),
            ("batched", "emugemm1_batched",
             "src/repro/kernels/backends/gpu.py:240",
             counts.launches_batched)):
        t = totals["mixed", kind]
        kernels.append({
            "name": name, **common, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err[kind],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations",
            "int_mm_yardstick_ms": t["yardstick_ms"],
            "per": "one mixed serve step of olmo-1b (4 lanes x chunk 16)"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
