"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives repro_torch only (no jax, nothing of the reference package) on the
card, with no CPU fallback, in nine phases:

1. build: nvcc compiles the port's CUDA kernels from this checkout, one
   process per source, in parallel;
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
   torch.profiler;
6. train kernels: the prepared-weight kernels (the pair and rhs
   decompositions, EmuGEMM-I's mixed form) are held against their plain
   versions bit for bit at the shapes of a train step of 8 x 128 tokens
   (float32 and bfloat16, p in {3, 4, 6}), and timed beside their bounds;
7. train: full-width olmo-1b, AdamW, remat, under ozaki1-p4+cached on
   seeded synthetic batches of 8 x 128 tokens: one warm-up step and
   three timed ones, the launch counts read around them, then three
   steps traced by torch.profiler (device activity only), then two steps
   at the published context of 2048 tokens (2 sequences);
8. train parity: under deterministic algorithms, one step's loss and
   every gradient leaf at full width are bit-identical on the 'cuda' and
   'torch' backends (at 8 x 128 and at 2 x 2048 tokens), cached and
   uncached, and cached and uncached with bwd_p = 3 (which launches the
   rhs decomposition);
9. trainer: launch/train.py at smoke size on the card fails at step 2,
   resumes, and ends in the state of an uninterrupted run, bit for bit.

Any failure exits non-zero and prints no result. The line before the
last is a JSON object listing each kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# Deterministic cuBLAS for the parity phases; read when CUDA initialises.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import scheme1  # noqa: E402
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.kernels import build, decompose, ozaki1  # noqa: E402
from repro_torch.launch import steps as S, train as train_cli  # noqa: E402
from repro_torch.launch.serve import build_trace  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import GemmPolicy, pad_vocab  # noqa: E402
from repro_torch.serving import ContinuousEngine, Request  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
L2_BYTES = 50 * 2 ** 20

SOURCE = "src/repro_torch/kernels/csrc/emugemm1.cu"
DECOMPOSE_SOURCE = "src/repro_torch/kernels/csrc/decompose.cu"
SPEC = "ozaki1-p4"
P_MAIN = 4
REQUESTS, PROMPT, GEN, LANES, CHUNK, PAGE = 8, 48, 16, 4, 16, 16
# Training: the train CLI's defaults, 8 sequences of 128 tokens a step,
# and a shorter run at olmo-1b's published context of 2048 tokens.
TRAIN_SPEC = "ozaki1-p4+cached"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 3
TOKENS = TRAIN_BATCH * TRAIN_SEQ
LONG_BATCH, LONG_SEQ, LONG_STEPS = 2, 2048, 2
P_BWD = 3


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


def kernel_label(name: str) -> str:
    """A kernel's name without its parameter list, e.g.
    emugemm1_kernel<__nv_bfloat16, __nv_bfloat16, 4, true>."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return name.split("(")[0][:90]


def device_summary(prof, prof_wall_ms: float, top_n: int = 4) -> dict:
    """Device-busy time (the union of kernel intervals), idle share of the
    profiled wall time, and the device time of the top kernels by name."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        label = kernel_label(e.name)
        by_name[label] = by_name.get(label, 0.0) + (t - s) / 1e3
    busy, end = 0.0, -math.inf
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    busy_ms = busy / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    return {"profiled_wall_ms": prof_wall_ms,
            "device_busy_ms": busy_ms if spans else None,
            "idle_share": (1 - busy_ms / prof_wall_ms) if spans else None,
            "top_device_ms": dict(top)}


def profile_phase(dev, arch, params, view_tokens):
    """Where one serve step's time goes: host wall time of a mixed and a
    decode step under ozaki1-p4 and native, and under torch.profiler the
    device-busy share and device time by kernel name."""
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
            entry = {"wall_ms": wall_ms,
                     **device_summary(prof, prof_wall_ms)}
            report[f"{step_kind}/{spec}"] = entry
            log(f"[profile] {step_kind} step, {spec}: " + json.dumps(entry))
    return report


# ---------------------------------------------------------------------------
# Phase 6: the prepared-weight kernels of the training path.
# ---------------------------------------------------------------------------

def weight_shapes(mcfg):
    """Each dense weight of the train path: (K, N, read transposed, count
    per step). The tied head is emb.T, a strided view."""
    d, f, L = mcfg.d_model, mcfg.d_ff, mcfg.n_layers
    return [(d, d, False, 4 * L), (d, f, False, 2 * L), (f, d, False, L),
            (d, pad_vocab(mcfg.vocab), True, 1)]


def train_launches(mcfg):
    """Launches per cached train step with remat, by kernel: each layer's
    weight is prepared and multiplied in the forward and again in the
    recompute, and its twin multiplies dA once; the head, outside the
    checkpoints, once each. The bwd_p route (K2r) decomposes the forward
    layout and the twin separately."""
    n_pair = n_fwd = n_da = 0
    for _, _, tr, c in weight_shapes(mcfg):
        r = 1 if tr else 2
        n_pair += r * c
        n_fwd += r * c
        n_da += c
    return {"pair": n_pair, "mixed": n_fwd + n_da, "rhs": 2 * n_pair}


def pair_bound(k, n, p, in_bytes):
    kp, np_ = decompose.round_up(k), decompose.round_up(n)
    moved = in_bytes * k * n + 4 * (k + n) + p * (kp * n + np_ * k)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def rhs_bound(k, n, p, in_bytes):
    moved = in_bytes * k * n + 4 * n + p * decompose.round_up(k) * n
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def mixed_bound(m, k, n, p, in_bytes, out_bytes):
    moved = (in_bytes * m * k + p * decompose.round_up(k) * n + 4 * (m + n)
             + out_bytes * m * n)
    ops = p * (p + 1) // 2 * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def make_weight(gen, k, n, transposed, dtype, dev):
    """A (K, N) weight, or the (K, N) view of an (N, K) table (emb.T)."""
    if transposed:
        return conditioned(gen, (n, k), dtype, dev).T
    return conditioned(gen, (k, n), dtype, dev)


def train_kernel_phase(dev, mcfg):
    gen = torch.Generator(device=dev).manual_seed(2)
    max_err = {"pair": 0.0, "rhs": 0.0, "mixed": 0.0}
    checks = 0
    cases = [(TOKENS, k, n, tr) for k, n, tr, _ in weight_shapes(mcfg)]
    cases.append((100, 1000, 77, True))                    # ragged
    for dtype in (torch.float32, torch.bfloat16):
        for p in (3, 4, 6):
            for m, k, n, tr in cases:
                b = make_weight(gen, k, n, tr, dtype, dev)
                nu, tau = scheme1.pow2_scale(b, -2), scheme1.pow2_scale(b, -1).T
                fwd, twin = decompose.decompose_interleave_pair(b, nu, tau, p,
                                                                7, 7)
                rhs = decompose.decompose_interleave_rhs(b, nu, p, 7)
                rhs_t = decompose.decompose_interleave_rhs(b.T, tau, p, 7)
                ref_f, ref_t = decompose.decompose_pair_plain(b, nu, tau, p,
                                                              7, 7)
                a = conditioned(gen, (m, k), dtype, dev)
                g = conditioned(gen, (m, n), dtype, dev)
                mu, mug = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(g, -1)
                outs = [(ozaki1.fused_matmul_mixed(x, hat, s, sc, p, 7, dtype),
                         ozaki1.fused_matmul_mixed_plain(x, hat, s, sc, p, 7,
                                                         dtype))
                        for x, hat, s, sc in ((a, fwd, mu, nu),
                                              (g, twin, mug, tau))]
                torch.cuda.synchronize()
                for name, out, ref in (("pair", fwd, ref_f),
                                       ("pair", twin, ref_t),
                                       ("rhs", rhs, ref_f),
                                       ("rhs", rhs_t, ref_t),
                                       ("mixed", *outs[0]),
                                       ("mixed", *outs[1])):
                    err = (out.float() - ref.float()).abs().max().item()
                    max_err[name] = max(max_err[name], err)
                    if not torch.equal(out, ref):
                        raise AssertionError(
                            f"{name} kernel != plain version: {(m, k, n)} "
                            f"transposed={tr} {dtype} p={p}, max |diff| {err}")
                    checks += 1
    log(f"[train-kernel] {checks} shape/type/p cases bit-identical to the "
        "plain versions")

    # Timing at the training configuration (bf16, p = 4; the twin of the
    # bwd_p route at p = 3), per shape and summed over one train step.
    bf = torch.bfloat16
    n_mm = P_MAIN * (P_MAIN + 1) // 2
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "bytes_ms": 0.0, "ops_ms": 0.0, "yardstick_ms": 0.0}
              for name in ("pair", "rhs", "mixed")}
    for k, n, tr, count in weight_shapes(mcfg):
        r = 1 if tr else 2          # the head is not recomputed
        # Rotate weight copies past the 50 MB L2, as a step finds each
        # weight cold.
        copies = max(1, math.ceil(2 * L2_BYTES / (2 * k * n)))
        bs = [make_weight(gen, k, n, tr, bf, dev) for _ in range(copies)]
        nus = [scheme1.pow2_scale(b, -2) for b in bs]
        taus = [scheme1.pow2_scale(b, -1).T for b in bs]
        preps = [decompose.decompose_interleave_pair(b, nu, tau, P_MAIN, 7, 7)
                 for b, nu, tau in zip(bs, nus, taus)]
        a = conditioned(gen, (TOKENS, k), bf, dev)
        g = conditioned(gen, (TOKENS, n), bf, dev)
        mu, mug = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(g, -1)
        it = iter(range(10 ** 9))

        def rot(fn):
            def run():
                i = next(it) % copies
                fn(bs[i], nus[i], taus[i], preps[i])
            return run

        runs = {
            "pair": (rot(lambda b, nu, tau, _: decompose.decompose_interleave_pair(
                b, nu, tau, P_MAIN, 7, 7)),
                rot(lambda b, nu, tau, _: decompose.decompose_pair_plain(
                    b, nu, tau, P_MAIN, 7, 7))),
            "rhs": (rot(lambda b, nu, tau, _: decompose.decompose_interleave_rhs(
                b, nu, P_MAIN, 7)),
                rot(lambda b, nu, tau, _: decompose.decompose_rhs_plain(
                    b, nu, P_MAIN, 7))),
            "rhs_twin": (rot(lambda b, nu, tau, _: decompose.decompose_interleave_rhs(
                b.T, tau, P_BWD, 7)),
                rot(lambda b, nu, tau, _: decompose.decompose_rhs_plain(
                    b.T, tau, P_BWD, 7))),
            "fwd": (rot(lambda b, nu, tau, pr: ozaki1.fused_matmul_mixed(
                a, pr[0], mu, nu, P_MAIN, 7, bf)),
                rot(lambda b, nu, tau, pr: ozaki1.fused_matmul_mixed_plain(
                    a, pr[0], mu, nu, P_MAIN, 7, bf))),
            "da": (rot(lambda b, nu, tau, pr: ozaki1.fused_matmul_mixed(
                g, pr[1], mug, tau, P_MAIN, 7, bf)),
                rot(lambda b, nu, tau, pr: ozaki1.fused_matmul_mixed_plain(
                    g, pr[1], mug, tau, P_MAIN, 7, bf))),
        }
        # Library yardstick, not a kernel of the port: the p(p+1)/2 int8
        # GEMMs of each mixed launch through torch._int_mm.
        ai = torch.randint(-127, 128, (TOKENS, k), generator=gen, device=dev,
                           dtype=torch.int8)
        gi = torch.randint(-127, 128, (TOKENS, n), generator=gen, device=dev,
                           dtype=torch.int8)
        bi = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        bti = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                            dtype=torch.int8)
        yard = {"fwd": lambda: [torch._int_mm(ai, bi) for _ in range(n_mm)],
                "da": lambda: [torch._int_mm(gi, bti) for _ in range(n_mm)]}
        bounds = {"pair": pair_bound(k, n, P_MAIN, 2),
                  "rhs": rhs_bound(k, n, P_MAIN, 2),
                  "rhs_twin": rhs_bound(n, k, P_BWD, 2),
                  "fwd": mixed_bound(TOKENS, k, n, P_MAIN, 2, 2),
                  "da": mixed_bound(TOKENS, n, k, P_MAIN, 2, 2)}
        per_step = {"pair": ("pair", r * count), "rhs": ("rhs", r * count),
                    "rhs_twin": ("rhs", r * count),
                    "fwd": ("mixed", r * count), "da": ("mixed", count)}
        for key, (run_k, run_p) in runs.items():
            ms = time_ms(run_k, 10)
            plain = time_ms(run_p, 2)
            y = time_ms(yard[key], 3) if key in yard else 0.0
            bms, by = bounds[key]
            name, c = per_step[key]
            t = totals[name]
            t["ms"] += c * ms
            t["plain_ms"] += c * plain
            t["bound_ms"] += c * bms
            t["bytes_ms" if by == "bytes" else "ops_ms"] += c * bms
            t["yardstick_ms"] += c * y
            log(f"[train-kernel] {key} K={k} N={n}"
                f"{' (B transposed)' if tr else ''} x{c}/step: kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by})"
                + (f", yardstick torch._int_mm x{n_mm} {y:.4f} ms"
                   if key in yard else ""))
        del bs, preps
    for name, t in totals.items():
        log(f"[train-kernel] {name} per train step: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms"
            + (f", yardstick {t['yardstick_ms']:.3f} ms"
               if name == "mixed" else ""))
    return max_err, totals


# ---------------------------------------------------------------------------
# Phases 7-9: train, train parity, trainer.
# ---------------------------------------------------------------------------

def snapshot_counts():
    return (ozaki1.LaunchCounts(**vars(ozaki1.COUNTS)),
            decompose.LaunchCounts(**vars(decompose.COUNTS)))


def reset_counts():
    ozaki1.COUNTS.reset()
    decompose.COUNTS.reset()


def train_batches(arch, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    return make_batch_iterator(arch, ShapeSpec("chip", seq, batch, "train"),
                               seed=0)


def run_steps(step, run, batches, n):
    """``n`` train steps on ``run["state"]``, each synchronised: (losses,
    wall s). Only ``run`` holds the state, so while a step builds the
    new state the old one is the only other alive, as in the Trainer."""
    losses, walls = [], []
    for _ in range(n):
        _, batch = next(batches)
        t0 = time.perf_counter()
        run["state"], metrics = step(run["state"], batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return losses, walls


def train_phase(dev, arch, card: str):
    from torch.profiler import ProfilerActivity, profile
    step = S.make_train_step(arch, policy=GemmPolicy(
        default=api.precision(TRAIN_SPEC)))
    run = {"state": S.init_state(arch, 0, dev)}
    batches = train_batches(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    # One warm-up step, then the timed window; tokens/s is every token of
    # the window over its whole wall time.
    losses, warm = run_steps(step, run, batches, 1)
    timed, walls = run_steps(step, run, batches, TRAIN_STEPS)
    losses += timed
    k1, k2 = snapshot_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    tok_s = TRAIN_STEPS * TOKENS / sum(walls)
    log(f"[train] 1 + {TRAIN_STEPS} steps of {TOKENS} tokens under "
        f"{TRAIN_SPEC}: losses {losses}, warm-up wall s {warm[0]:.3f}, "
        f"timed step wall s {[round(w, 3) for w in walls]}, {tok_s:.1f} "
        f"tokens/s over the timed steps, peak memory "
        f"{peak / 2 ** 30:.2f} GiB on {card}; launches: pair "
        f"{k2.launches_pair}, "
        f"rhs {k2.launches_rhs}, mixed {k1.launches_mixed}, 2-D "
        f"{k1.launches_2d}, batched {k1.launches_batched}, plain versions on "
        f"CUDA {k1.plain_cuda_calls + k2.plain_cuda_calls}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if min(k2.launches_pair, k1.launches_mixed, k1.launches_2d,
           k1.launches_batched) == 0:
        raise AssertionError("the train path did not launch every kernel")
    # The per-step times of the kernel phase count these launches.
    expect = train_launches(arch.model)
    n_run = 1 + TRAIN_STEPS
    if (k2.launches_pair, k1.launches_mixed) != (
            n_run * expect["pair"], n_run * expect["mixed"]):
        raise AssertionError(f"launches differ from the per-step accounting "
                             f"{expect}")
    if k1.plain_cuda_calls or k2.plain_cuda_calls:
        raise AssertionError("the train path ran a plain version on CUDA")
    # The same number of steps again, traced: device activity only, so the
    # host runs as it does unprofiled; the idle share is that of the
    # whole window.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_losses, prof_walls = run_steps(step, run, batches, TRAIN_STEPS)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    profiled = device_summary(prof, prof_wall_ms, top_n=6)
    profiled["step_wall_s"] = prof_walls
    log(f"[train] {TRAIN_STEPS} profiled steps " + json.dumps(profiled))
    # At the published context: one chunk pair of flash attention is
    # skipped (causal) and one rescaled across chunks.
    torch.cuda.reset_peak_memory_stats(dev)
    long_losses, long_walls = run_steps(
        step, run, train_batches(arch, LONG_BATCH, LONG_SEQ), LONG_STEPS)
    long_peak = torch.cuda.max_memory_allocated(dev)
    log(f"[train] {LONG_STEPS} steps of {LONG_BATCH} x {LONG_SEQ} tokens: "
        f"losses {long_losses}, step wall s "
        f"{[round(w, 3) for w in long_walls]}, peak memory "
        f"{long_peak / 2 ** 30:.2f} GiB")
    if not all(math.isfinite(x) for x in prof_losses + long_losses):
        raise AssertionError(f"non-finite training loss "
                             f"{prof_losses + long_losses}")
    summary = {"losses": losses, "warmup_wall_s": warm[0],
               "step_wall_s": walls, "tokens_per_s": tok_s,
               "peak_memory_bytes": peak, "profile": profiled,
               "long_seq": {"tokens": LONG_BATCH * LONG_SEQ,
                            "losses": long_losses, "step_wall_s": long_walls,
                            "peak_memory_bytes": long_peak}}
    return run["state"]["params"], (k1, k2), summary


def grads_equal(name, run_a, run_b):
    (la, ga), (lb, gb) = run_a, run_b
    fa, fb = tree_flatten(ga), tree_flatten(gb)
    bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
    if not torch.equal(la, lb) or bad:
        raise AssertionError(f"train parity {name}: losses {la.item()} vs "
                             f"{lb.item()}, gradient leaves that differ: "
                             f"{bad[:5]}")
    log(f"[train-parity] {name}: loss {la.item()} and all {len(fa)} "
        "gradient leaves bit-identical")


def train_parity_phase(dev, arch, params):
    """One step's loss and gradients at full width, under deterministic
    algorithms (the embedding's gradient accumulates with atomics
    otherwise, and the tied emb also takes the head's dB)."""
    def run(spec, batches=None, **kw):
        _, batch = next(batches or train_batches(arch))
        loss_fn = S.make_loss_fn(arch, GemmPolicy(
            default=api.precision(spec, **kw)))
        return S.value_and_grad(loss_fn, params, S.batch_to(batch, dev))

    cached = run(TRAIN_SPEC + "@cuda")
    grads_equal("(a) cuda == torch backend", cached,
                run(TRAIN_SPEC + "@torch"))
    grads_equal("(b) cached == uncached", cached, run("ozaki1-p4"))
    del cached
    grads_equal(f"(d) at {LONG_BATCH} x {LONG_SEQ} tokens, cuda == torch "
                "backend",
                *(run(TRAIN_SPEC + backend,
                      train_batches(arch, LONG_BATCH, LONG_SEQ))
                  for backend in ("@cuda", "@torch")))
    reset_counts()
    cached_bwd = run(TRAIN_SPEC, bwd_p=P_BWD)
    _, k2 = snapshot_counts()
    grads_equal(f"(c) bwd_p={P_BWD}: cached == uncached", cached_bwd,
                run("ozaki1-p4", bwd_p=P_BWD))
    if k2.launches_rhs != train_launches(arch.model)["rhs"]:
        raise AssertionError(f"the bwd_p route launched the rhs kernel "
                             f"{k2.launches_rhs} times")
    log(f"[train-parity] the bwd_p={P_BWD} step launched the rhs kernel "
        f"{k2.launches_rhs} times")
    return k2.launches_rhs


def trainer_phase():
    """Fail at step 2, resume, and end in the uninterrupted run's state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = ["--arch", "olmo-1b", "--smoke", "--steps", "4", "--batch",
                "2", "--seq", "32", "--gemm", TRAIN_SPEC, "--device", "cuda",
                "--ckpt-every", "2"]
        ref, ft = os.path.join(tmp, "ref"), os.path.join(tmp, "ft")
        train_cli.main(argv + ["--ckpt-dir", ref])
        try:
            train_cli.main(argv + ["--ckpt-dir", ft, "--fail-at", "2"])
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("the injected failure did not fire")
        log_ft = train_cli.main(argv + ["--ckpt-dir", ft])
        if [m["step"] for m in log_ft] != [2, 3]:
            raise AssertionError(f"resume ran steps {log_ft}")
        a, b = (tree_flatten(CheckpointManager(d).restore(3))
                for d in (ref, ft))
        bad = [k for k in a if not (a[k].dtype == b[k].dtype
                                    and torch.equal(a[k], b[k]))]
        if sorted(a) != sorted(b) or bad:
            raise AssertionError(f"resumed state differs: {bad[:5]}")
        log(f"[trainer] failed at step 2, resumed, final state == "
            f"uninterrupted run's ({len(a)} leaves bit-identical)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_phase():
    """nvcc for each kernel source, all started together."""
    t0 = time.perf_counter()
    names = ("emugemm1", "decompose")
    with ThreadPoolExecutor(len(names)) as ex:
        for f in [ex.submit(build.build, n) for n in names]:
            f.result()
    log(f"[build] {', '.join(n + '.cu' for n in names)} built in "
        f"{time.perf_counter() - t0:.1f} s")


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
    build_phase()

    arch = configs.get_config("olmo-1b")
    view_tokens = PAGE * math.ceil((PROMPT + GEN - 1 + CHUNK) / PAGE)
    max_err, totals = kernel_phase(dev, arch.model, view_tokens)
    eng, counts, serve = serve_phase(
        dev, arch, GemmPolicy(default=api.precision(SPEC)))
    serve.update(parity_phase(dev, arch, eng.params, view_tokens))
    log("[serve] summary " + json.dumps(serve))
    profile_phase(dev, arch, eng.params, view_tokens)
    del eng

    t_err, t_totals = train_kernel_phase(dev, arch.model)
    params, (k1, k2), train = train_phase(dev, arch, smi.stdout.strip())
    log("[train] summary " + json.dumps(
        {k: v for k, v in train.items() if k != "profile"}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    rhs_launches = train_parity_phase(dev, arch, params)
    del params
    trainer_phase()
    torch.use_deterministic_algorithms(False)

    common = {"route": "cuda", "library_ms": None}
    kernels = []
    for kind, name, replaces, launches, train_n in (
            ("2d", "emugemm1_2d", "src/repro/kernels/ozaki1.py:143",
             counts.launches_2d, k1.launches_2d),
            ("batched", "emugemm1_batched",
             "src/repro/kernels/backends/gpu.py:240",
             counts.launches_batched, k1.launches_batched)):
        t = totals["mixed", kind]
        kernels.append({
            "name": name, **common, "source": SOURCE, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err[kind],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations",
            "int_mm_yardstick_ms": t["yardstick_ms"],
            "per": "one mixed serve step of olmo-1b (4 lanes x chunk 16)",
            "launches_in_train_run": train_n})
    train_per = (f"one {TRAIN_SPEC} train step of full-width olmo-1b "
                 f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens; launches: the "
                 f"warm-up and {TRAIN_STEPS} timed steps)")
    for key, name, source, replaces, launches, per in (
            ("mixed", "emugemm1_mixed", SOURCE,
             "src/repro/kernels/ozaki1.py:170", k1.launches_mixed, train_per),
            ("pair", "decompose_pair", DECOMPOSE_SOURCE,
             "src/repro/kernels/decompose.py:106", k2.launches_pair,
             train_per),
            ("rhs", "decompose_rhs", DECOMPOSE_SOURCE,
             "src/repro/kernels/decompose.py:71", rhs_launches,
             f"one train step with bwd_p={P_BWD} (launches: the parity "
             "step of that route)")):
        t = t_totals[key]
        row = {"name": name, **common, "source": source, "replaces": replaces,
               "launches": launches, "max_abs_err": t_err[key],
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"],
               "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
               else "operations", "per": per}
        if key == "mixed":
            row["int_mm_yardstick_ms"] = t["yardstick_ms"]
        kernels.append(row)
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
