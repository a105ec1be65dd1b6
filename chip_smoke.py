"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives repro_torch only (no jax, nothing of the reference package) on the
card, with no CPU fallback, in nineteen phases:

1. build: nvcc compiles the port's CUDA kernels from this checkout (seven
   sources), one process per source, in parallel;
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
   resumes, and ends in the state of an uninterrupted run, bit for bit;
10. Scheme-II kernels: EmuGEMM-II's 2-D, batched and residue forms are
    held against their plain versions bit for bit at the shapes of
    olmo-1b-emu's attention scores (serve; train at 8 x 128 and 2 x 2048
    tokens, forward and both backward transposes) and on a ragged
    shape, float32 and bfloat16, m in {4, 6, 8, 16}, and timed beside
    their bounds; the library routes of the 2-D and residue forms
    (``dispatch.emulated_matmul`` and ``ops.fused_scheme2_matmul`` under
    ozaki2-m6, on olmo-1b's dense shapes at 1024 tokens) are driven with
    their counts read around them;
11. emu serve: full-width olmo-1b-emu under its shipped gemm_sites
    (ozaki1-p4+cached, attn_qk ozaki2-m6, attn_av ozaki1-p4) serves the
    trace of phase 3; the launch counts of both kernels' modules are read
    around it, and request 0 alone must match the cohort;
12. emu parity and profile: one full-width mixed step on 'cuda' and
    'torch' gives bit-identical logits; step walls and device time by
    kernel of a mixed and a decode step;
13. emu train: full-width olmo-1b-emu, one warm-up and three timed steps
    of 8 x 128 tokens, launch counts read around them, three more traced;
14. emu train parity: under deterministic algorithms one step's loss and
    every gradient leaf are bit-identical on 'cuda' and 'torch', and with
    2 microbatches the weights prepared once for the step (the hoist,
    through EmuGEMM-I's pair and mixed forms) give the float32 mean of
    the halves' per-call-cached gradients, bit for bit;
15. scientific GEMMs: the plane route of DGEMM and ZGEMM (the encode
    kernels and the TMA-fed wgmma plane GEMM, real and 3M, 2-D and with a
    batch coordinate), the complex residue kernel K7 and EmuGEMM-II's
    batched form on float32 operands to a float64 output are held against
    their plain versions bit for bit (complex64 and complex128, m in {4,
    8, 12, 16}; float64, m in {8, 12, 16}; ragged, transposed, complex @
    real, rows of tiny magnitude, 1024^3, K = 131200 across the plane
    GEMM's in-kernel reduction); the front doors (``api.einsum`` on
    complex128, float64, a float64 batch and a complex128 batch, the
    residue routes of ``ops``, complex64 under ozaki1-p4) run with the
    launch counts read around them, and the float64 batch (8 x 512^3,
    m = 12) is timed beside cuBLAS's batched DGEMM with its encode /
    mainloop / CRT split; then DGEMM and ZGEMM at M = N = K = 4096 (m in
    {8, 12, 16}) and 8192 (m = 16) are timed beside their bounds, the
    plain versions, torch._int_mm and cuBLAS, with the encode, the
    mainloop (and its int8 rate) and the CRT epilogue timed apart, and the
    effective bits of the route and of cuBLAS against a longdouble
    product of 64 sampled rows on the host;
16. prepared kernel: EmuGEMM-II's prepared form on the plane route (a
    float lhs encoded once, a plane GEMM against the weight's (p, N, Kp)
    int8 planes, which one encode launch wrote when it was prepared) is
    held against its plain version on the reference-layout stack and
    against the float-rhs form bit for bit at olmo-1b's train shapes
    (forward and dA at 1024 and 512 tokens, ragged M, N and K, the tied
    head), bf16 and float32 at m in {6, 8, 16}, float32 against a bf16
    weight and float64 at m = 16, with each call's launches counted, and
    timed per hoisted step (lhs encode, mainloop and CRT apart, and the
    weights' encodes) beside its bound, its plain version and the
    float-rhs form;
17. hoisted train: full-width olmo-1b under ozaki2-m6+cached with 2
    microbatches of 4 x 128 tokens: one warm-up and three timed steps
    with the launch counts by kernel form (prepared calls, encodes and
    plane GEMMs) and the prepare_rhs calls read around them (each weight
    prepared once a step), then three steps traced by torch.profiler
    (device activity only: idle share, top kernels);
18. hoisted train parity: under deterministic algorithms, one step's loss
    and float32 gradients with the hoisted preps equal the mean of the
    halves' per-call-cached ones, the uncached ozaki2-m6 ones, and those
    of the 'torch' backend, bit for bit.
19. library: the kernels no model reaches. EmuGEMM-I on interleaved
    operands (K8) and the lhs decomposition (K11) are held against their
    plain versions bit for bit at olmo-1b's dense shapes at 1024 tokens
    and a ragged shape (float32 and bfloat16, p in {3, 4, 6}), and K11 +
    K2r -> K8 and the 'xla' route of ``ops.fused_scheme1_matmul`` against
    K1; the int8 GEMM (K9) bit for bit at 4096^3, 1024 x 2048 x 8192 and a
    ragged shape; then the library's entry points run with the counts read
    around them: the 'xla' route and the decompositions feeding K8 (bf16,
    p = 4), the naive Fig. 4 structure (p(p+1)/2 K9 launches) at 4096^3,
    which must equal K1, and fused attention (K10) at olmo-1b's heads
    (2 x 16 x 2048 x 128, causal, bf16 and float32, and a window of 1024),
    granite-3-8b's GQA (32 / 8 heads), recurrentgemma-2b's MQA (10 / 1
    heads of 256 over 4096, window 2048, bf16 and float32) and a
    rectangular non-causal case (128 / 512, D 64), within 2e-5 (float32)
    and 2e-2 (bf16) of its plain version (bf16 on the TMA-fed wgmma
    kernel, float32 on the 3xTF32 wgmma kernel after its pre-pass, which
    is held bit for bit against its plain version, and on the FFMA kernel
    at D = 256); each kernel is timed beside its bound (the float32 ones
    also beside the FFMA bound, with the device kernels a call runs),
    its plain version and, for K9 and K10, torch._int_mm and
    scaled_dot_product_attention.

Right after the build, one line names the device kernels that the
library yardsticks (cuBLAS's batched DGEMM, scaled_dot_product_attention
in bf16 and float32) run, and one those of the port's float32 attention,
from one torch.profiler pass each. Any failure
exits non-zero and prints no result. The line before the last is a JSON
object listing each kernel; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from repro_torch.core import complex3m, scheme1, scheme2  # noqa: E402
from repro_torch.core.precision import default_moduli  # noqa: E402
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.kernels import (build, decompose, dispatch,  # noqa: E402
                                 flash_attn, matmul_int8, ops, ozaki1, ozaki2,
                                 ozaki3m, prepared)
from repro_torch.launch import steps as S, train as train_cli  # noqa: E402
from repro_torch.launch.serve import build_trace  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import GemmPolicy, pad_vocab  # noqa: E402
from repro_torch.serving import ContinuousEngine, Request  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 ops/s,
# bf16 and TF32 tensor-core flop/s and float32 flop/s outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

SOURCE = "src/repro_torch/kernels/csrc/emugemm1.cu"
DECOMPOSE_SOURCE = "src/repro_torch/kernels/csrc/decompose.cu"
SOURCE2 = "src/repro_torch/kernels/csrc/emugemm2.cu"
EMU = "olmo-1b-emu"
M_MAIN = 6                       # olmo-1b-emu's attn_qk is ozaki2-m6
M_CHECK = (4, 6, 8, 16)
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
# The scientific GEMMs: DGEMM- and ZGEMM-grade Scheme II at the sizes the
# paper's users run (M = N = K), bit checks at m in SCI_M_CHECK (complex)
# and F64_M_CHECK (float64), the front doors at SCI_M_FRONT, effective bits
# on EVAL_ROWS sampled rows, bit identity at 8192 on the first SCI_ROWS.
SOURCE3M = "src/repro_torch/kernels/csrc/emugemm3m.cu"
SOURCE_PLANES = "src/repro_torch/kernels/csrc/emugemm2_planes.cu"
SCI_LONG_K = 131200               # past the plane GEMM's in-kernel reduction
SCI_SIZES = ((4096, (8, 12, 16)), (8192, (16,)))
SCI_M_CHECK = (4, 8, 12, 16)
F64_M_CHECK = (8, 12, 16)
SCI_M_FRONT = 12
SCI_BATCHED = (8, 512, 512)
SCI_BIG = SCI_4M_N = 1024
EVAL_ROWS, SCI_ROWS = 64, 256
# Training under Scheme II with the once-per-step weight hoist: TOKENS a
# step in HOIST_MICRO microbatches, the prepared form checked at
# HOIST_M_CHECK moduli.
HOIST_SPEC = f"ozaki2-m{M_MAIN}+cached"
HOIST_MICRO = 2
HOIST_M_CHECK = (6, 8, 16)
# The library kernels: EmuGEMM-I on interleaved operands and the lhs
# decomposition at olmo-1b's dense shapes (and LIB_RAGGED) at LIB_P
# slices; the int8 GEMM checked at INT8_CHECK and timed at INT8_TIMED,
# the naive Fig. 4 structure at NAIVE_N^3; attention at ATTN_CASES:
# (label, B, H, KVH, S_q, S_k, D, causal, window, dtype).
SOURCE_INT8 = "src/repro_torch/kernels/csrc/matmul_int8.cu"
SOURCE_FLASH = "src/repro_torch/kernels/csrc/flash_attn.cu"
LIB_P = (3, 4, 6)
LIB_RAGGED = (100, 1000, 77)
INT8_CHECK = ((4096, 4096, 4096), (1024, 2048, 8192), (1000, 3000, 777))
INT8_TIMED = (4096, 8192)
NAIVE_N = 4096
ATTN_CASES = (
    ("olmo-1b causal", 2, 16, 16, 2048, 2048, 128, True, None, "bfloat16"),
    ("olmo-1b causal", 2, 16, 16, 2048, 2048, 128, True, None, "float32"),
    ("granite-3-8b GQA causal", 1, 32, 8, 2048, 2048, 128, True, None,
     "bfloat16"),
    ("olmo-1b window 1024", 2, 16, 16, 2048, 2048, 128, True, 1024,
     "bfloat16"),
    ("recurrentgemma-2b MQA window 2048", 1, 10, 1, 4096, 4096, 256, True,
     2048, "bfloat16"),
    ("rectangular full", 1, 4, 4, 128, 512, 64, False, None, "float32"),
    ("recurrentgemma-2b MQA window 2048", 1, 10, 1, 4096, 4096, 256, True,
     2048, "float32"),
)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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
    reset_counts()
    t0 = time.perf_counter()
    results = eng.run(trace)
    dt = time.perf_counter() - t0
    counts, _, counts2 = snapshot_counts()
    util = eng.utilization()
    toks = [results[r.rid].tokens for r in trace]
    ttft = float(np.median([results[r.rid].ttft for r in trace]))
    tag = f"[serve {arch.model.name}]"
    log(f"{tag} {util['steps']} steps, {REQUESTS} requests x {GEN} tokens "
        f"in {dt:.3f} s ({REQUESTS * GEN / dt:.1f} tok/s), ttft p50 "
        f"{ttft:.3f} s, launches: emugemm1 2-D {counts.launches_2d}, "
        f"batched {counts.launches_batched}; emugemm2 batched "
        f"{counts2.launches_batched}, 2-D {counts2.launches_2d}; plain "
        f"versions on CUDA {counts.plain_cuda_calls} + "
        f"{counts2.plain_cuda_calls}")
    if counts.launches_2d == 0 or counts.launches_batched == 0:
        raise AssertionError("the serve path did not launch the kernel")
    if scheme2_sites(eng.policy) and counts2.launches_batched == 0:
        raise AssertionError("the serve path did not launch emugemm2")
    if counts.plain_cuda_calls or counts2.plain_cuda_calls:
        raise AssertionError("the serve path ran a plain version on CUDA")
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
    log(f"{tag} request 0 alone == in cohort; sample {toks[0][:8]}")
    return eng, (counts, counts2), {
        "steps": util["steps"], "seconds": dt,
        "tok_per_s": REQUESTS * GEN / dt, "ttft_p50_s": ttft}


def scheme2_sites(policy) -> bool:
    return any(c is not None and c.scheme == "ozaki2"
               for c in [policy.default] + [c for _, c in policy.overrides])


def on_backend(policy, backend):
    """``policy`` with every emulated site pinned to ``backend``."""
    def pin(cfg):
        if cfg is None or cfg.scheme == "native":
            return cfg
        return api.precision(cfg, backend=backend)
    return GemmPolicy(default=pin(policy.default),
                      overrides=tuple((s, pin(c)) for s, c in policy.overrides))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def parity_phase(dev, arch, params, view_tokens, policy, label):
    """One full-width mixed step under ``policy`` on the 'cuda' and 'torch'
    backends (bit for bit), and its distance to a float32 forward."""
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
    native = GemmPolicy(default=api.precision("native"))
    runs = (("cuda", params, on_backend(policy, "cuda")),
            ("torch", params, on_backend(policy, "torch")),
            ("native", params, native),
            ("native-f32", tree_map(lambda x: x.float(), params), native))
    with torch.inference_mode():
        for name, prm, pol in runs:
            views = {"layers": {"b0": {
                k: v.clone().to(prm["emb"].dtype)
                for k, v in cache["layers"]["b0"].items()}}}
            logits[name], _ = M.forward_step(prm, mcfg, tokens, start,
                                             n_new, views, pol)
    torch.cuda.synchronize()
    a, b = logits["cuda"], logits["torch"]
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
        f"for bit; relative distance to a float32 forward: {label} bf16 "
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
    profiled wall time, the device time of the top kernels by name and
    that of EmuGEMM-II (attn_qk under olmo-1b-emu)."""
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
            "top_device_ms": dict(top),
            "emugemm2_ms": sum(v for k, v in by_name.items()
                               if k.startswith("emugemm2"))}


def yardstick_kernels(fn, calls: int = 10) -> dict:
    """The device kernels that a library yardstick ran, by name, with
    their mean device ms a call, from one torch.profiler pass over
    ``calls`` calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            label = kernel_label(e.name)
            names[label] = (names.get(label, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / calls)
    return names


def yardstick_phase(dev):
    """Which device kernels the library yardsticks run: cuBLAS's batched
    DGEMM at SCI_BATCHED and scaled_dot_product_attention at the first two
    ATTN_CASES (bf16 and float32), on seeded inputs of those shapes, and
    the port's float32 K10 (its pre-pass and 3xTF32 kernel, by device
    time) at the second; returns the latter. It runs first: later in a
    long process the profiler was seen to keep only some of a short
    pass's kernel events."""
    gen = torch.Generator(device=dev).manual_seed(20)
    ba = torch.randn(SCI_BATCHED, generator=gen, device=dev,
                     dtype=torch.float64)
    out = {f"cuBLAS batched DGEMM (torch.matmul) {SCI_BATCHED} float64":
           yardstick_kernels(lambda: torch.matmul(ba, ba))}
    for case in ATTN_CASES[:2]:
        label, _, h, kvh, _, _, d, causal, _, dt = case
        q, k, v = attn_inputs(gen, dev, case)
        out[f"scaled_dot_product_attention {label} {dt} D={d}"] = (
            yardstick_kernels(lambda: torch.nn.functional.
                              scaled_dot_product_attention(
                                  q, k, v, is_causal=causal,
                                  enable_gqa=h != kvh)))
    log("[yardsticks] the device kernels each library call ran, ms a call: "
        + json.dumps(out))
    # The port's float32 K10 in the same pass: its pre-pass and kernel by
    # device time (CUDA events time the call with its host work).
    attn = yardstick_kernels(lambda: flash_attn.flash_attention(
        q, k, v, causal=causal))
    log(f"[yardsticks] the port's K10 {label} {dt} D={d}, device ms a call: "
        + json.dumps(attn))
    return attn


def profile_phase(dev, arch, params, view_tokens, runs):
    """Where one serve step's time goes: host wall time of a mixed and a
    decode step under each (label, policy) of ``runs``, and under
    torch.profiler the device-busy share and device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    mcfg = arch.model
    start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
    report = {}
    for step_kind, c, n_new in (("mixed", CHUNK, [16, 16, 5, 1]),
                                ("decode", 1, [1, 1, 1, 1])):
        tokens = torch.ones((LANES, c), device=dev, dtype=torch.int32)
        nn = torch.tensor(n_new, device=dev, dtype=torch.int32)
        cache = M.init_cache(mcfg, LANES, view_tokens, dev)
        for spec, pol in runs:

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
            decompose.LaunchCounts(**vars(decompose.COUNTS)),
            ozaki2.LaunchCounts(**vars(ozaki2.COUNTS)))


def reset_counts():
    ozaki1.COUNTS.reset()
    decompose.COUNTS.reset()
    ozaki2.COUNTS.reset()
    ozaki3m.COUNTS.reset()
    matmul_int8.COUNTS.reset()
    flash_attn.COUNTS.reset()


def train_batches(arch, batch=None, seq=None):
    return make_batch_iterator(arch, ShapeSpec(
        "chip", seq or TRAIN_SEQ, batch or TRAIN_BATCH, "train"), seed=0)


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


def train_phase(dev, arch, card: str, policy=None, long_seq: bool = True):
    """Train ``arch`` under ``policy`` (None: the arch's gemm_sites)."""
    from torch.profiler import ProfilerActivity, profile
    label = TRAIN_SPEC if policy is not None else arch.model.name
    tag = f"[train {arch.model.name}]"
    step = S.make_train_step(arch, policy=policy)
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
    k1, k2, k3 = snapshot_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    tok_s = TRAIN_STEPS * TOKENS / sum(walls)
    log(f"{tag} 1 + {TRAIN_STEPS} steps of {TOKENS} tokens under "
        f"{label}: losses {losses}, warm-up wall s {warm[0]:.3f}, "
        f"timed step wall s {[round(w, 3) for w in walls]}, {tok_s:.1f} "
        f"tokens/s over the timed steps, peak memory "
        f"{peak / 2 ** 30:.2f} GiB on {card}; launches: pair "
        f"{k2.launches_pair}, "
        f"rhs {k2.launches_rhs}, mixed {k1.launches_mixed}, 2-D "
        f"{k1.launches_2d}, batched {k1.launches_batched}, emugemm2 batched "
        f"{k3.launches_batched}, plain versions on CUDA "
        f"{k1.plain_cuda_calls + k2.plain_cuda_calls + k3.plain_cuda_calls}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if min(k2.launches_pair, k1.launches_mixed, k1.launches_2d,
           k1.launches_batched) == 0:
        raise AssertionError("the train path did not launch every kernel")
    # The per-step times of the kernel phase count these launches.
    expect = train_launches(arch.model)
    n_run = 1 + TRAIN_STEPS
    # attn_qk under Scheme II: the forward, the recompute, dA and dB of
    # each chunk pair.
    qk = (4 * chunk_pairs(arch.model, TRAIN_SEQ) * arch.model.n_layers
          if scheme2_sites(policy or arch.gemm_policy()) else 0)
    if (k2.launches_pair, k1.launches_mixed, k3.launches_batched) != (
            n_run * expect["pair"], n_run * expect["mixed"], n_run * qk):
        raise AssertionError(f"launches differ from the per-step accounting "
                             f"{expect}, attn_qk {qk}")
    if k1.plain_cuda_calls or k2.plain_cuda_calls or k3.plain_cuda_calls:
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
    log(f"{tag} {TRAIN_STEPS} profiled steps " + json.dumps(profiled))
    summary = {"losses": losses, "warmup_wall_s": warm[0],
               "step_wall_s": walls, "tokens_per_s": tok_s,
               "peak_memory_bytes": peak, "profile": profiled}
    if not all(math.isfinite(x) for x in prof_losses):
        raise AssertionError(f"non-finite training loss {prof_losses}")
    if not long_seq:
        return run["state"]["params"], (k1, k2, k3), summary
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
    if not all(math.isfinite(x) for x in long_losses):
        raise AssertionError(f"non-finite training loss {long_losses}")
    summary["long_seq"] = {"tokens": LONG_BATCH * LONG_SEQ,
                           "losses": long_losses, "step_wall_s": long_walls,
                           "peak_memory_bytes": long_peak}
    return run["state"]["params"], (k1, k2, k3), summary


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
    _, k2, _ = snapshot_counts()
    grads_equal(f"(c) bwd_p={P_BWD}: cached == uncached", cached_bwd,
                run("ozaki1-p4", bwd_p=P_BWD))
    if k2.launches_rhs != train_launches(arch.model)["rhs"]:
        raise AssertionError(f"the bwd_p route launched the rhs kernel "
                             f"{k2.launches_rhs} times")
    log(f"[train-parity] the bwd_p={P_BWD} step launched the rhs kernel "
        f"{k2.launches_rhs} times")
    return k2.launches_rhs


# ---------------------------------------------------------------------------
# Phase 10: EmuGEMM-II against its plain versions, and its library routes.
# ---------------------------------------------------------------------------

def chunk_pairs(mcfg, seq):
    """The (q chunk, kv chunk) pairs causal flash attention runs at
    ``seq`` tokens (q_chunk == kv_chunk), the later ones skipped."""
    nc = -(-seq // min(mcfg.q_chunk, seq))
    return nc * (nc + 1) // 2


def qk_shapes(mcfg, view_tokens):
    """attn_qk's strided-batched GEMMs under olmo-1b-emu with their
    launches per step: (label, batch, m, k, n, a transposed, b
    transposed, count). A train step runs each chunk pair's forward
    twice (remat) and the backward's dA = g b^T and dB = a^T g on
    transposed views; at 2 x 2048 tokens flash attention runs 3 of the
    2 x 2 chunk pairs."""
    L, hd = mcfg.n_layers, mcfg.resolved_head_dim
    g = mcfg.n_heads // mcfg.n_kv_heads
    kvh = mcfg.n_kv_heads
    out = [("serve mixed", LANES * kvh, CHUNK * g, hd, view_tokens, False,
            False, L),
           ("serve decode", LANES * kvh, g, hd, view_tokens, False, False, L)]
    for name, batch, seq in (("train", TRAIN_BATCH, TRAIN_SEQ),
                             ("long", LONG_BATCH, LONG_SEQ)):
        c, pairs = min(mcfg.q_chunk, seq), chunk_pairs(mcfg, seq)
        bt = batch * kvh
        out += [(f"{name} fwd", bt, c * g, hd, c, False, False,
                 2 * pairs * L),
                (f"{name} dA", bt, c * g, c, hd, False, True, pairs * L),
                (f"{name} dB", bt, hd, c * g, c, True, False, pairs * L)]
    return out


def operand(gen, lead, rows, cols, transposed, dtype, dev):
    """A (..., rows, cols) operand, or the transposed view of a
    (..., cols, rows) tensor."""
    if transposed:
        return conditioned(gen, lead + (cols, rows), dtype, dev).transpose(
            -1, -2)
    return conditioned(gen, lead + (rows, cols), dtype, dev)


def scheme2_bound(batch, m, k, n, p, in_bytes, out_bytes):
    """Least time: the float operands and scales read once, the output
    written once, against p int8 GEMMs at the int8 peak."""
    moved = batch * (in_bytes * (m * k + k * n + m + n) + out_bytes * m * n)
    ops_ = batch * p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def residue_bound(m, k, n, p):
    moved = p * (m * k + k * n + m * n)
    ops_ = p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def int_mm_yardstick(gen, dev, batch, m, k, n, p):
    """p torch._int_mm per batch element at the same shape (which needs
    more than 16 rows, so M is raised to 32 where smaller). A speed
    reference only, used nowhere in the port."""
    ai = torch.randint(-127, 128, (max(m, 32), k), generator=gen, device=dev,
                       dtype=torch.int8)
    bi = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)

    def run():
        for _ in range(p * batch):
            torch._int_mm(ai, bi)
    return run


def check_equal(what, out, ref, max_err, key):
    torch.cuda.synchronize()
    wide = torch.complex128 if out.is_complex() else torch.float64
    err = torch.where(out == ref, 0, out.to(wide) - ref.to(wide)).abs().max(
        ).item() if out.numel() else 0.0
    max_err[key] = max(max_err[key], err)
    if not torch.equal(out, ref):
        raise AssertionError(f"{what}: kernel != plain version, max |diff| "
                             f"{err}")
    return err


def scheme2_kernel_phase(dev, mcfg, view_tokens):
    gen = torch.Generator(device=dev).manual_seed(3)
    max_err = {"2d": 0.0, "batched": 0.0, "residues": 0.0}
    checks = 0
    shapes = qk_shapes(mcfg, view_tokens)
    for dtype in (torch.float32, torch.bfloat16):
        for p in M_CHECK:
            moduli = default_moduli(p)
            cases = [(lbl, (bt,), m, k, n, ta, tb)
                     for lbl, bt, m, k, n, ta, tb, _ in shapes]
            cases += [("ragged", (), 100, 200, 77, False, False),
                      ("ragged, B transposed", (), 100, 200, 77, False, True)]
            for lbl, lead, m, k, n, ta, tb in cases:
                a = operand(gen, lead, m, k, ta, dtype, dev)
                b = operand(gen, lead, k, n, tb, dtype, dev)
                mu, nu = scheme2.scales(a, b, moduli)
                out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, dtype)
                ref = ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli,
                                                        dtype)
                check_equal(f"emugemm2 {lbl} {lead + (m, k, n)} {dtype} "
                            f"m={p}", out, ref, max_err,
                            "batched" if lead else "2d")
                checks += 1
                del a, b, out, ref
            for m, k, n in ((100, 200, 77), (1024, 2048, 2048)):
                a_res = torch.randint(-128, 128, (p, m, k), generator=gen,
                                      device=dev, dtype=torch.int8)
                b_res = torch.randint(-128, 128, (p, k, n), generator=gen,
                                      device=dev, dtype=torch.int8)
                check_equal(f"emugemm2 residues {(p, m, k, n)}",
                            ozaki2.fused_residue_matmul(a_res, b_res, moduli),
                            ozaki2.fused_residue_matmul_plain(a_res, b_res,
                                                              moduli),
                            max_err, "residues")
                checks += 1
    log(f"[scheme2-kernel] {checks} shape/type/moduli cases bit-identical to "
        "the plain versions")

    # Timing at olmo-1b-emu's configuration (bf16, m = 6), per shape and
    # summed per step.
    bf = torch.bfloat16
    moduli = default_moduli(M_MAIN)
    steps = {"serve mixed": "mixed", "serve decode": "decode",
             "train fwd": "train", "train dA": "train", "train dB": "train",
             "long fwd": "long", "long dA": "long", "long dB": "long"}
    totals = {s: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bytes_ms": 0.0, "ops_ms": 0.0, "yardstick_ms": 0.0}
              for s in ("mixed", "decode", "train", "long")}
    for lbl, bt, m, k, n, ta, tb, count in shapes:
        a = operand(gen, (bt,), m, k, ta, bf, dev)
        b = operand(gen, (bt,), k, n, tb, bf, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        ms = time_ms(lambda: ozaki2.fused_matmul_scheme2(a, b, mu, nu,
                                                         moduli, bf), 20)
        plain = time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
            a, b, mu, nu, moduli, bf), 3)
        yard = time_ms(int_mm_yardstick(gen, dev, bt, m, k, n, M_MAIN), 3)
        bms, by = scheme2_bound(bt, m, k, n, M_MAIN, 2, 2)
        _add(totals[steps[lbl]], count, ms, plain, yard, bms, by)
        log(f"[scheme2-kernel] batched {lbl} B={bt} M={m} K={k} N={n}"
            f"{' (A transposed)' if ta else ''}"
            f"{' (B transposed)' if tb else ''} x{count}/step: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"yardstick torch._int_mm x{M_MAIN * bt} {yard:.4f} ms")
        del a, b
    for s, t in totals.items():
        log(f"[scheme2-kernel] batched per {s} step: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms, "
            f"yardstick {t['yardstick_ms']:.3f} ms")
    return max_err, totals


def dense_shapes(mcfg):
    """olmo-1b's dense GEMMs at 1024 tokens: (m, k, n)."""
    d, f = mcfg.d_model, mcfg.d_ff
    return [(TOKENS, d, d), (TOKENS, d, f), (TOKENS, f, d)]


def scheme2_library_phase(dev, mcfg):
    """The library routes of the 2-D and residue forms under ozaki2-m6 on
    olmo-1b's dense shapes (bf16): ``dispatch.emulated_matmul`` (the 2-D
    form) and ``ops.fused_scheme2_matmul`` (the residue form) agree bit
    for bit; their launches are counted around that run. Then each form
    is timed beside its bound."""
    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    spec = f"ozaki2-m{M_MAIN}"
    moduli = default_moduli(M_MAIN)
    shapes = dense_shapes(mcfg)
    xs = [(conditioned(gen, (m, k), bf, dev), conditioned(gen, (k, n), bf, dev))
          for m, k, n in shapes]
    torch.cuda.synchronize()
    reset_counts()
    for a, b in xs:
        fused = dispatch.emulated_matmul(a, b, cfg=spec)
        routed = ops.fused_scheme2_matmul(a, b, spec, out_dtype=bf)
        if not torch.equal(fused, routed):
            raise AssertionError(f"{spec}: the 2-D and residue routes differ "
                                 f"at {tuple(a.shape)} @ {tuple(b.shape)}")
    torch.cuda.synchronize()
    _, _, counts = snapshot_counts()
    log(f"[scheme2-library] {spec} on {len(shapes)} dense shapes: the 2-D "
        f"and residue routes agree bit for bit; launches 2-D "
        f"{counts.launches_2d}, residues {counts.launches_residues}, plain "
        f"versions on CUDA {counts.plain_cuda_calls}")
    if (counts.launches_2d, counts.launches_residues) != (len(shapes),) * 2:
        raise AssertionError("the library routes did not launch each form "
                             "once per shape")
    if counts.plain_cuda_calls:
        raise AssertionError("the library routes ran a plain version on CUDA")
    totals = {f: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bytes_ms": 0.0, "ops_ms": 0.0, "yardstick_ms": 0.0}
              for f in ("2d", "residues")}
    for (m, k, n), (a, b) in zip(shapes, xs):
        mu, nu = scheme2.scales(a, b, moduli)
        a_res = scheme2.balanced_residues(torch.trunc(a * mu), moduli)
        b_res = scheme2.balanced_residues(torch.trunc(b * nu), moduli)
        yard = time_ms(int_mm_yardstick(gen, dev, 1, m, k, n, M_MAIN), 5)
        for form, run_k, run_p, (bms, by) in (
                ("2d",
                 lambda: ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, bf),
                 lambda: ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu,
                                                           moduli, bf),
                 scheme2_bound(1, m, k, n, M_MAIN, 2, 2)),
                ("residues",
                 lambda: ozaki2.fused_residue_matmul(a_res, b_res, moduli),
                 lambda: ozaki2.fused_residue_matmul_plain(a_res, b_res,
                                                           moduli),
                 residue_bound(m, k, n, M_MAIN))):
            ms = time_ms(run_k, 10)
            plain = time_ms(run_p, 3)
            _add(totals[form], 1, ms, plain, yard, bms, by)
            log(f"[scheme2-library] {form} M={m} K={k} N={n}: kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
                f"({by}), yardstick torch._int_mm x{M_MAIN} {yard:.4f} ms")
    return counts, totals


# ---------------------------------------------------------------------------
# Phases 16-18: EmuGEMM-II's prepared form, and training under
# ozaki2-m6+cached with gradient accumulation and the once-per-step hoist.
# ---------------------------------------------------------------------------

def micro_arch(arch):
    """``arch`` accumulating gradients over HOIST_MICRO microbatches."""
    return dataclasses.replace(arch, train=dataclasses.replace(
        arch.train, microbatches=HOIST_MICRO))


@contextlib.contextmanager
def counting_preps():
    """Count every ``prepared.prepare_rhs`` call inside the block."""
    calls = {"n": 0}
    real = prepared.prepare_rhs

    def counted(*args, **kw):
        calls["n"] += 1
        return real(*args, **kw)

    prepared.prepare_rhs = counted
    try:
        yield calls
    finally:
        prepared.prepare_rhs = real


def hoisted_shapes(mcfg):
    """The prepared form's GEMMs in one hoisted train step of TOKENS
    tokens in HOIST_MICRO microbatches: (label, m, k, n, b transposed,
    count per step). Each layer weight's forward runs twice (remat) and
    its dA once per microbatch; the tied head (emb.T, prepared per call)
    once each."""
    m = TOKENS // HOIST_MICRO
    out = []
    for k, n, tr, c in weight_shapes(mcfg):
        r = 1 if tr else 2
        out += [(f"fwd K={k} N={n}", m, k, n, tr, HOIST_MICRO * r * c),
                (f"dA K={n} N={k}", m, n, k, not tr, HOIST_MICRO * c)]
    return out


def hoisted_launches(mcfg):
    """Launches and preps per hoisted step, by kernel form: each prepared
    GEMM is an lhs encode and a plane GEMM, each prep (with its twin) two
    encodes."""
    w = sum(c for _, _, tr, c in weight_shapes(mcfg) if not tr)
    prepared_ = sum(c for *_, c in hoisted_shapes(mcfg))
    preps = w + HOIST_MICRO                      # the head, per microbatch
    return {"prepared": prepared_, "planes": prepared_,
            "encode": prepared_ + 2 * preps,
            "2d": HOIST_MICRO * (w + 1),                      # dB
            "batched": HOIST_MICRO * 2 * 4 * chunk_pairs(mcfg, TRAIN_SEQ)
            * mcfg.n_layers,                     # attn_qk and attn_av
            "preps": preps}


def prepared_bound(m, k, n, p, in_bytes, out_bytes):
    """Least time of the prepared form: the lhs and both scales read once,
    the weight's p int8 planes read once, the output written once,
    against p int8 GEMMs at the int8 peak."""
    moved = in_bytes * (m * k + m + n) + p * k * n + out_bytes * m * n
    ops_ = p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def prepared_kernel_phase(dev, mcfg):
    """The prepared form on the plane route (one lhs encode and one plane
    GEMM against the weight's (p, N, Kp) planes, which one encode launch
    wrote) against its plain version on the reference-layout stack and
    against the float-rhs form on the same operands, bit for bit, at
    olmo-1b's train shapes (forward and dA, 1024 tokens and the hoisted
    step's 512), ragged M, N and K, the tied head, bf16 and float32 at m
    in HOIST_M_CHECK, float32 against a bf16 weight, float64 at one shape,
    every CUDA prep in the planes layout and every call's launches
    counted; then timed per hoisted step (the lhs encode, the plane
    GEMM's mainloop and its CRT apart, the weight encodes) beside its
    bound, its plain version and the float-rhs form."""
    gen = torch.Generator(device=dev).manual_seed(15)
    d, f = mcfg.d_model, mcfg.d_ff
    vp = pad_vocab(mcfg.vocab)
    max_err = {"prepared": 0.0}
    checks = 0

    def case(m, k, n, dtype, p, tr=False, w_dtype=None):
        w_dtype = w_dtype or dtype
        moduli = default_moduli(p)
        cfg = api.precision(f"ozaki2-m{p}")
        b = make_weight(gen, k, n, tr, w_dtype, dev)
        a = conditioned(gen, (m, k), dtype, dev)
        what = f"emugemm2 prepared {(m, k, n)} {dtype} @ {w_dtype} m={p}"
        reset_counts()
        prep = prepared.prepare_rhs(b, cfg)
        if (prep.layout != "planes"
                or prep.residues.shape != (p, n, ozaki2.plane_k(k))):
            raise AssertionError(f"{what}: a CUDA weight prepared as "
                                 f"{prep.layout} {tuple(prep.residues.shape)}")
        mu = scheme2._pow2_int_scale(a, -1, min(
            prep.budget_bits, scheme2.MANTISSA[dtype]))
        out = ozaki2.fused_matmul_scheme2_prepared(
            a, prep.residues, mu, prep.scale, moduli, dtype, n)
        c = ozaki2.COUNTS
        got = (c.launches_encode, c.launches_planes, c.launches_prepared,
               c.launches_2d, c.launches_batched, c.plain_cuda_calls)
        if got != (2, 1, 1, 0, 0, 0):
            raise AssertionError(f"{what}: launches (encode, planes, "
                                 f"prepared, 2d, batched, plain) {got}")
        ref = ozaki2.fused_matmul_scheme2_prepared_plain(
            a, prep.stacked(), mu, prep.scale, moduli, dtype, n)
        check_equal(what, out, ref, max_err, "prepared")
        if w_dtype == dtype:
            mu2, nu2 = scheme2.scales(a, b, moduli)
            float_rhs = ozaki2.fused_matmul_scheme2(a, b, mu2, nu2, moduli,
                                                    dtype)
            if not torch.equal(out, float_rhs):
                raise AssertionError(f"{what}: != the float-rhs form")

    cases = [(mm, k, n) for mm in (TOKENS, TOKENS // HOIST_MICRO)
             for k, n in ((d, d), (d, f), (f, d))]
    cases += [(1000, d, d), (TOKENS, d, 1990), (TOKENS, 2040, d)]
    for dtype in (torch.bfloat16, torch.float32):
        for p in HOIST_M_CHECK:
            for m, k, n in cases:
                case(m, k, n, dtype, p)
                checks += 1
    for m, k, n in cases[3:6] + cases[-3:]:
        case(m, k, n, torch.float32, M_MAIN, w_dtype=torch.bfloat16)
        checks += 1
    for m, k, n, tr in ((TOKENS // HOIST_MICRO, d, vp, True),
                        (TOKENS // HOIST_MICRO, vp, d, False)):
        case(m, k, n, torch.bfloat16, M_MAIN, tr)
        checks += 1
    case(TOKENS, d, d, torch.float64, 16)
    checks += 1
    log(f"[prepared-kernel] {checks} shape/type/moduli cases on the plane "
        "route (2 encodes a case, the weight's and the lhs's, and 1 plane "
        "GEMM; every prep in the planes layout) bit-identical to the plain "
        "version on the reference-layout stack and, for one operand type, "
        "to the float-rhs form")

    # Timing at the hoisted step's configuration (bf16, m = 6), per shape
    # and summed over one step; each weight's planes rotate past the L2.
    bf, moduli = torch.bfloat16, default_moduli(M_MAIN)
    cfg = api.precision(f"ozaki2-m{M_MAIN}")
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
              "ops_ms": 0.0, "yardstick_ms": 0.0, "float_rhs_ms": 0.0,
              "encode_ms": 0.0, "planes_ms": 0.0, "mainloop_ms": 0.0,
              "weight_encode_ms": 0.0}
    for lbl, m, k, n, tr, count in hoisted_shapes(mcfg):
        copies = max(1, math.ceil(2 * L2_BYTES / (M_MAIN * k * n)))
        bs = [make_weight(gen, k, n, tr, bf, dev) for _ in range(copies)]
        preps = [prepared.prepare_rhs(b, cfg) for b in bs]
        stacks = [pr.stacked() for pr in preps]
        a = conditioned(gen, (m, k), bf, dev)
        mu = scheme2._pow2_int_scale(a, -1, preps[0].budget_bits)
        nus = [scheme2._pow2_int_scale(b, -2, preps[0].budget_bits)
               for b in bs]
        ap = ozaki2.encode_planes(a, mu, moduli)
        out = torch.empty((m, n), dtype=bf, device=dev)
        it = iter(range(10 ** 9))

        def rot(fn):
            def run():
                i = next(it) % copies
                fn(bs[i], nus[i], preps[i], stacks[i])
            return run

        ms = time_ms(rot(lambda b, nu, pr, st: ozaki2.
                         fused_matmul_scheme2_prepared(
                             a, pr.residues, mu, pr.scale, moduli, bf, n)), 10)
        enc = time_ms(lambda: ozaki2.encode_planes(a, mu, moduli), 10)
        planes = time_ms(rot(lambda b, nu, pr, st: ozaki2.plane_matmul(
            ap, pr.residues, mu, pr.scale[:, :n], moduli, bf)), 10)
        main = time_ms(rot(lambda b, nu, pr, st: ozaki2.launch_planes(
            ap[:, None], pr.residues[:, None], mu, pr.scale[:, :n], moduli,
            out, epilogue=False)), 10)
        plain = time_ms(rot(
            lambda b, nu, pr, st: ozaki2.fused_matmul_scheme2_prepared_plain(
                a, st, mu, pr.scale, moduli, bf, n)), 2)
        float_rhs = time_ms(rot(lambda b, nu, pr, st: ozaki2.
                                fused_matmul_scheme2(a, b, mu, nu, moduli,
                                                     bf)), 5)
        yard = time_ms(int_mm_yardstick(gen, dev, 1, m, k, n, M_MAIN), 3)
        bms, by = prepared_bound(m, k, n, M_MAIN, 2, 2)
        _add(totals, count, ms, plain, yard, bms, by)
        for key, t in (("float_rhs_ms", float_rhs), ("encode_ms", enc),
                       ("planes_ms", planes), ("mainloop_ms", main)):
            totals[key] += count * t
        # The weight's encode (planes and twin): once a step for a layer
        # weight (at its forward entry), once a microbatch for the head.
        wenc = 0.0
        if lbl.startswith("fwd"):
            wenc = time_ms(rot(lambda b, nu, pr, st: prepared.prepare_rhs(
                b, cfg, with_twin=True)), 5)
            reps = HOIST_MICRO if tr else count // (HOIST_MICRO * 2)
            totals["weight_encode_ms"] += reps * wenc
        log(f"[prepared-kernel] {lbl} M={m}{' (B transposed)' if tr else ''}"
            f" x{count}/step: route {ms:.4f} ms (lhs encode {enc:.4f}, plane "
            f"GEMM {planes:.4f}: mainloop {main:.4f}, CRT {planes - main:.4f}"
            f"), plain {plain:.4f} ms, float-rhs form {float_rhs:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), yardstick torch._int_mm x{M_MAIN} "
            f"{yard:.4f} ms" + (f"; weight + twin encode {wenc:.4f} ms"
                                if wenc else ""))
        del bs, preps, stacks
    totals["crt_ms"] = totals["planes_ms"] - totals["mainloop_ms"]
    log(f"[prepared-kernel] per hoisted step: route {totals['ms']:.3f} ms "
        f"(lhs encodes {totals['encode_ms']:.3f}, plane GEMMs "
        f"{totals['planes_ms']:.3f}: mainloop {totals['mainloop_ms']:.3f}, "
        f"CRT {totals['crt_ms']:.3f}), weight encodes "
        f"{totals['weight_encode_ms']:.3f} ms, plain {totals['plain_ms']:.3f}"
        f" ms, float-rhs form {totals['float_rhs_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.3f} ms")
    return max_err, totals


def hoisted_train_phase(dev, arch, card: str):
    """Full-width ``arch`` under HOIST_SPEC with HOIST_MICRO microbatches:
    one warm-up and TRAIN_STEPS timed steps with the launch counts and
    prepare_rhs calls read around them, then TRAIN_STEPS traced."""
    from torch.profiler import ProfilerActivity, profile
    arch = micro_arch(arch)
    mcfg = arch.model
    tag = f"[hoist {mcfg.name}]"
    step = S.make_train_step(arch, policy=GemmPolicy(
        default=api.precision(HOIST_SPEC)))
    run = {"state": S.init_state(arch, 0, dev)}
    batches = train_batches(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with counting_preps() as calls:
        reset_counts()
        losses, warm = run_steps(step, run, batches, 1)
        timed, walls = run_steps(step, run, batches, TRAIN_STEPS)
        k1, k2, k3 = snapshot_counts()
        n_preps = calls["n"]
    losses += timed
    peak = torch.cuda.max_memory_allocated(dev)
    tok_s = TRAIN_STEPS * TOKENS / sum(walls)
    n_run = 1 + TRAIN_STEPS
    plain = k1.plain_cuda_calls + k2.plain_cuda_calls + k3.plain_cuda_calls
    launches = {"prepared": k3.launches_prepared,
                "encode": k3.launches_encode, "planes": k3.launches_planes,
                "2d": k3.launches_2d, "batched": k3.launches_batched,
                "residues": k3.launches_residues,
                "emugemm1": k1.launches_2d + k1.launches_batched
                + k1.launches_mixed,
                "decompose": k2.launches_pair + k2.launches_rhs,
                "plain_on_cuda": plain}
    log(f"{tag} 1 + {TRAIN_STEPS} steps of {HOIST_MICRO} x "
        f"{TOKENS // HOIST_MICRO} tokens under {HOIST_SPEC}: losses {losses}, "
        f"warm-up wall s {warm[0]:.3f}, timed step wall s "
        f"{[round(w, 3) for w in walls]}, {tok_s:.1f} tokens/s over the "
        f"timed steps, peak memory {peak / 2 ** 30:.2f} GiB on {card}; "
        f"launches {json.dumps(launches)}; prepare_rhs calls {n_preps}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    expect = hoisted_launches(mcfg)
    got = (k3.launches_prepared, k3.launches_encode, k3.launches_planes,
           k3.launches_2d, k3.launches_batched, n_preps)
    want = tuple(n_run * expect[k] for k in ("prepared", "encode", "planes",
                                             "2d", "batched", "preps"))
    if got != want or launches["emugemm1"] or launches["decompose"]:
        raise AssertionError(f"launches or preps {got} differ from the "
                             f"per-step accounting {want} ({expect})")
    if plain:
        raise AssertionError("the hoisted step ran a plain version on CUDA")
    w = expect["preps"] - HOIST_MICRO
    log(f"{tag} preps built once per step: {n_preps // n_run} prepare_rhs "
        f"calls a step, one for each of the {w} layer weights and one for "
        f"the tied head in each of the {HOIST_MICRO} microbatches (preparing "
        f"in every microbatch's forward and recompute would make "
        f"{2 * HOIST_MICRO * w + HOIST_MICRO})")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_losses, prof_walls = run_steps(step, run, batches, TRAIN_STEPS)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    profiled = device_summary(prof, prof_wall_ms, top_n=6)
    profiled["step_wall_s"] = prof_walls
    log(f"{tag} {TRAIN_STEPS} profiled steps " + json.dumps(profiled))
    if not all(math.isfinite(x) for x in prof_losses):
        raise AssertionError(f"non-finite training loss {prof_losses}")
    summary = {"spec": HOIST_SPEC, "microbatches": HOIST_MICRO,
               "losses": losses, "warmup_wall_s": warm[0],
               "step_wall_s": walls, "tokens_per_s": tok_s,
               "peak_memory_bytes": peak, "launches_per_step": expect,
               "prepare_rhs_calls": n_preps, "profile": profiled}
    return run["state"]["params"], k3, summary


def hoisted_parity_phase(dev, arch, params, policy, label, uncached=None,
                         torch_backend=False):
    """One step's loss and float32 gradients at full width, bit for bit:
    hoisted preps (each weight prepared once, the tied head once per
    microbatch) == the per-call cache on each half (the float32 mean of
    two microbatches=1 evaluations), == ``uncached`` when given, and the
    'cuda' == the 'torch' backend when asked."""
    _, batch = next(train_batches(arch))
    halves = S.split_batch(S.batch_to(batch, dev), HOIST_MICRO)

    def grads(pol, hoist):
        preps = prepared.build_step_preps(params, pol) if hoist else None
        return S.accumulate_grads(S.make_loss_fn(arch, pol), params, halves,
                                  preps)

    with counting_preps() as calls:
        hoisted = grads(policy, True)
    want = hoisted_launches(arch.model)["preps"]
    if calls["n"] != want:
        raise AssertionError(f"({label}) the hoisted step prepared "
                             f"{calls['n']} times, not {want}")
    grads_equal(f"({label}) hoisted == mean of the halves' per-call cache",
                hoisted, grads(policy, False))
    if uncached is not None:
        grads_equal(f"({label}) hoisted == uncached", hoisted,
                    grads(uncached, False))
    if torch_backend:
        grads_equal(f"({label}) hoisted, cuda == torch backend", hoisted,
                    grads(on_backend(policy, "torch"), True))


# ---------------------------------------------------------------------------
# Phase 15: the scientific GEMMs, DGEMM- and ZGEMM-grade.
# ---------------------------------------------------------------------------

def eq19(gen, shape, dtype, dev):
    """Paper Eq. 19 matrices drawn in the working type (a complex one has
    two such parts), so float64 carries all 53 mantissa bits, which
    ``conditioned`` (float32, then cast) would not."""
    part = (torch.float64 if dtype in (torch.float64, torch.complex128)
            else torch.float32)

    def draw():
        return (torch.rand(shape, generator=gen, device=dev, dtype=part)
                - 0.5) * torch.exp(2 * torch.randn(shape, generator=gen,
                                                   device=dev, dtype=part))
    return torch.complex(draw(), draw()) if dtype.is_complex else draw()


def timed(fn):
    """(ms, result) of one synchronised call, CUDA events."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def threem_bound(m, k, n, p, part_bytes):
    """Least time of a complex GEMM by 3M: both complex operands and the
    scales read once, the complex output written once, against 3p int8
    GEMMs at the int8 peak."""
    moved = part_bytes * (2 * (m * k + k * n) + m + n + 2 * m * n)
    ops_ = 3 * p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def threem_residue_bound(m, k, n, p):
    moved = p * (3 * (m * k + k * n) + 2 * m * n)
    ops_ = 3 * p * 2 * m * n * k
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def extended_reference(a_rows, b, pool):
    """a_rows @ b in numpy longdouble on the host, in column chunks on a
    thread pool; returns a function that waits for the product."""
    cplx = a_rows.is_complex() or b.is_complex()
    ar, br = a_rows.real.cpu().numpy(), b.real.cpu().numpy()
    ai, bi = ((a_rows.imag.cpu().numpy(), b.imag.cpu().numpy()) if cplx
              else (None, None))
    cols = np.array_split(np.arange(br.shape[1]), 32)

    def mm(x, y):
        return x.astype(np.longdouble) @ y.astype(np.longdouble)

    def part(c):
        if not cplx:
            return mm(ar, br[:, c])
        return (mm(ar, br[:, c]) - mm(ai, bi[:, c])
                + 1j * (mm(ar, bi[:, c]) + mm(ai, br[:, c])))

    futures = [pool.submit(part, c) for c in cols]
    return lambda: np.concatenate([f.result() for f in futures], axis=1)


def effective_bits(c_rows, ref) -> float:
    """-log2(max |c - ref| / max |ref|) over the sampled rows, in
    longdouble."""
    c = c_rows.cpu().numpy()
    c = c.astype(np.clongdouble if np.iscomplexobj(c) else np.longdouble)
    return float(-np.log2(float(np.abs(c - ref).max() / np.abs(ref).max())))


def scientific_kernel_checks(dev, gen, max_err):
    """The plane route (K7g, float64 K5g), K7 and float64 EmuGEMM-II
    against their plain versions, bit for bit: the encode kernels alone
    (float64, complex64 and complex128 operands, a transposed view, a
    real operand of a complex product); complex64 and complex128 at m in
    {4, 8, 12, 16} (ragged, a transposed view, complex @ real, real @
    complex, rows of tiny magnitude, 1024^3); K7 on random residues;
    float64 at m in {8, 12, 16} (the 2-D plane route and the batched
    form, float64 and float32 outputs, float32 operands to a float64
    output, and the residue route) and at K = SCI_LONG_K, m = 16. One row
    a case, with its maximum absolute difference, which must be 0."""
    rows = []
    # The plane route's own cases draw from a generator of their own, so
    # that the timed inputs are those of earlier runs.
    gen17 = torch.Generator(device=dev).manual_seed(17)

    def case(what, out, ref, key):
        err = check_equal(what, out, ref, max_err, key)
        rows.append(what)
        log(f"[scientific] case {what}: max |kernel - plain| {err}")
    for p in SCI_M_CHECK:
        moduli = default_moduli(p)
        for dtype in (torch.float64, torch.complex64, torch.complex128):
            x, y = (eq19(gen17, (200, 136), dtype, dev),
                    eq19(gen17, (136, 72), dtype, dev))
            if dtype == torch.float64:
                mu, nu = scheme2.scales(x, y, moduli)
                enc, plain, key = (ozaki2.encode_planes,
                                   ozaki2.encode_planes_plain, "encode")
                ops_ = ((x, mu), (y.T, nu.T))
            else:
                mu, nu = complex3m.scales(x, y, moduli)
                enc, plain, key = (ozaki3m.encode_planes_3m,
                                   ozaki3m.encode_planes_3m_plain,
                                   "encode_3m")
                ops_ = ((x, mu), (y.T, nu.T), (x.real.contiguous(), mu))
            for v, sc in ops_:
                case(f"encode {tuple(v.shape)} {v.dtype} strides "
                     f"{v.stride()} m={p}", enc(v, sc, moduli),
                     plain(v, sc, moduli), key)
    for dtype in (torch.complex64, torch.complex128):
        part = torch.float64 if dtype == torch.complex128 else torch.float32
        tiny = 2.0 ** -1000 if part == torch.float64 else 2.0 ** -120
        for p in SCI_M_CHECK:
            moduli = default_moduli(p)
            a = eq19(gen, (200, 136), dtype, dev)
            a[:3] *= tiny                  # 1 / (mu * nu) subnormal or 0
            b = eq19(gen, (136, 72), dtype, dev)
            bt = eq19(gen, (72, 136), dtype, dev).T
            big = (eq19(gen, (SCI_BIG, SCI_BIG), dtype, dev),
                   eq19(gen, (SCI_BIG, SCI_BIG), dtype, dev))
            for lbl, x, y in (("ragged", a, b), ("B transposed", a, bt),
                              ("complex @ real", a, b.real.contiguous()),
                              ("real @ complex", a.real.contiguous(), b),
                              (f"{SCI_BIG}^3", *big)):
                mu, nu = complex3m.scales(x, y, moduli)
                case(f"emugemm3m {lbl} {tuple(x.shape)} @ {tuple(y.shape)} "
                     f"{x.dtype} @ {y.dtype} m={p}",
                     ozaki3m.fused_matmul_3m(x, y, mu, nu, moduli, part),
                     ozaki3m.fused_matmul_3m_plain(x, y, mu, nu, moduli,
                                                   part), "3m_2d")
            del a, b, bt, big
    for p in SCI_M_CHECK:
        moduli = default_moduli(p)
        for m, k, n in ((200, 136, 72), (SCI_BIG,) * 3):
            a3 = torch.randint(-128, 128, (p, 3, m, k), generator=gen,
                               device=dev, dtype=torch.int8)
            b3 = torch.randint(-128, 128, (p, 3, k, n), generator=gen,
                               device=dev, dtype=torch.int8)
            out = ozaki3m.fused_3m_residue_matmul(a3, b3, moduli)
            ref = ozaki3m.fused_3m_residue_matmul_plain(a3, b3, moduli)
            case(f"emugemm3m residues {(p, 3, m, k, n)} m={p}",
                 torch.stack(out), torch.stack(ref), "3m_residues")
    f64 = torch.float64
    for p in F64_M_CHECK:
        moduli = default_moduli(p)
        for lbl, lead, m, k, n, tb in (
                ("ragged", (), 200, 136, 72, False),
                ("B transposed", (), 200, 136, 72, True),
                (f"{SCI_BIG}^3", (), SCI_BIG, SCI_BIG, SCI_BIG, False),
                ("batched", (8,), 128, 128, 128, False),
                ("batched, B transposed", (8,), 128, 128, 128, True)):
            a = eq19(gen, lead + (m, k), f64, dev)
            b = (eq19(gen, lead + (n, k), f64, dev).transpose(-1, -2) if tb
                 else eq19(gen, lead + (k, n), f64, dev))
            for x, y, out_t in ((a, b, f64), (a, b, torch.float32),
                                (a.float(), b.float(), f64)):
                mu, nu = scheme2.scales(x, y, moduli)
                case(f"emugemm2 {lbl} {tuple(x.shape)} @ {tuple(y.shape)} "
                     f"{x.dtype} -> {out_t} m={p}",
                     ozaki2.fused_matmul_scheme2(x, y, mu, nu, moduli, out_t),
                     ozaki2.fused_matmul_scheme2_plain(x, y, mu, nu, moduli,
                                                       out_t),
                     "f64_batched" if lead else "f64_2d")
        a, b = eq19(gen, (200, 136), f64, dev), eq19(gen, (136, 72), f64, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        case(f"emugemm2 residue route (200, 136) @ (136, 72) float64 m={p}",
             ops.fused_scheme2_matmul(a, b, f"ozaki2-m{p}", out_dtype=f64),
             ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli, f64),
             "f64_residues")
    # Past the plane GEMM's in-kernel reduction: its K tiles between
    # reductions (1023 at m = 256) cover 130944 < SCI_LONG_K.
    moduli = default_moduli(16)
    a = eq19(gen17, (64, SCI_LONG_K), f64, dev)
    b = eq19(gen17, (SCI_LONG_K, 64), f64, dev)
    mu = scheme2._pow2_int_scale(a, -1, 52)
    nu = scheme2._pow2_int_scale(b, -2, 52)
    case(f"emugemm2 plane route (64, {SCI_LONG_K}) @ ({SCI_LONG_K}, 64) "
         "float64 m=16", ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, f64),
         ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli, f64),
         "f64_2d")
    log(f"[scientific] {len(rows)} complex64/complex128/float64 kernel "
        "cases bit-identical to the plain versions")


def scientific_main_path(dev, gen, za, zb, da, db):
    """The front doors a user calls, with every count zeroed just before
    and read just after: ZGEMM and DGEMM through ``api.einsum`` (the
    plane route: two encodes and one plane GEMM each, and no fused
    EmuGEMM-II 2-D launch) and the residue routes (K7, K5 with a float64
    CRT), a float64 and a complex128 batched einsum (K6 and batched K7g:
    the batched plane route, two encodes and one plane GEMM each, and no
    fused batched launch) and a complex64 GEMM under ozaki1-p4 (four
    EmuGEMM-I launches). Then the float64 batch is timed, with its
    encode / mainloop / CRT split, beside its bound, its plain version
    and cuBLAS's batched DGEMM."""
    spec = f"ozaki2-m{SCI_M_FRONT}"
    moduli = default_moduli(SCI_M_FRONT)
    ba = eq19(gen, SCI_BATCHED, torch.float64, dev)
    bb = eq19(gen, SCI_BATCHED, torch.float64, dev)
    # The complex batch draws from a generator of its own, so that the
    # inputs drawn after it are those of earlier runs.
    gen18 = torch.Generator(device=dev).manual_seed(18)
    zba = eq19(gen18, SCI_BATCHED, torch.complex128, dev)
    zbb = eq19(gen18, SCI_BATCHED, torch.complex128, dev)
    n4m = SCI_4M_N
    ca, cb = (za[:n4m, :n4m].to(torch.complex64),
              zb[:n4m, :n4m].to(torch.complex64))
    torch.cuda.synchronize()
    reset_counts()
    out = {
        "zgemm": api.einsum("mk,kn->mn", za, zb, precision=spec),
        "zgemm_residues": ops.fused_3m_matmul(za, zb, spec),
        "dgemm": api.einsum("mk,kn->mn", da, db, precision=spec),
        "dgemm_residues": ops.fused_scheme2_matmul(da, db, spec,
                                                   out_dtype=torch.float64),
        "batched": api.einsum("bmk,bkn->bmn", ba, bb, precision=spec),
        "zbatched": api.einsum("bmk,bkn->bmn", zba, zbb, precision=spec),
        "4m": api.einsum("mk,kn->mn", ca, cb, precision="ozaki1-p4"),
    }
    torch.cuda.synchronize()
    c1, _, c2 = snapshot_counts()
    c3 = ozaki3m.LaunchCounts(**vars(ozaki3m.COUNTS))
    counts = {"emugemm3m_encode": c3.launches_encode,
              "emugemm3m_planes": c3.launches_planes,
              "emugemm3m_residues": c3.launches_residues,
              "emugemm2_encode": c2.launches_encode,
              "emugemm2_planes": c2.launches_planes,
              "emugemm2_2d": c2.launches_2d,
              "emugemm2_residues": c2.launches_residues,
              "emugemm2_batched": c2.launches_batched,
              "emugemm1_2d": c1.launches_2d}
    plain = c1.plain_cuda_calls + c2.plain_cuda_calls + c3.plain_cuda_calls
    log(f"[scientific] main path launches {json.dumps(counts)}; plain "
        f"versions on CUDA {plain}")
    if counts != {"emugemm3m_encode": 4, "emugemm3m_planes": 2,
                  "emugemm3m_residues": 1, "emugemm2_encode": 4,
                  "emugemm2_planes": 2, "emugemm2_2d": 0,
                  "emugemm2_residues": 1, "emugemm2_batched": 0,
                  "emugemm1_2d": 4} or plain:
        raise AssertionError("the scientific front doors did not launch "
                             "each kernel as expected")
    for kind in ("zgemm", "dgemm"):
        if not torch.equal(out[kind], out[kind + "_residues"]):
            raise AssertionError(f"{kind}: the fused and residue routes "
                                 "differ")
    if not torch.equal(out["4m"], dispatch.emulated_matmul(
            ca, cb, cfg="ozaki1-p4", backend="torch")):
        raise AssertionError("complex64 ozaki1-p4: four EmuGEMM-I launches "
                             "!= matmul_complex_4m on the torch backend")
    mu, nu = scheme2.scales(ba, bb, moduli)
    if not torch.equal(out["batched"], ozaki2.fused_matmul_scheme2_plain(
            ba, bb, mu, nu, moduli, torch.float64)):
        raise AssertionError("float64 batched einsum != its plain version")
    for e in range(SCI_BATCHED[0]):
        if not torch.equal(out["batched"][e], scheme2.matmul(
                ba[e], bb[e], api.precision(spec))):
            raise AssertionError(f"float64 batched einsum, element {e} != "
                                 "scheme2.matmul")
    if not torch.equal(out["zbatched"][-1], api.einsum(
            "mk,kn->mn", zba[-1], zbb[-1], precision=spec)):
        raise AssertionError("complex128 batched einsum != the 2-D einsum "
                             "of its element")
    del zba, zbb
    b_ms = time_ms(lambda: ozaki2.fused_matmul_scheme2(
        ba, bb, mu, nu, moduli, torch.float64), 10)
    b_plain = time_ms(lambda: ozaki2.fused_matmul_scheme2_plain(
        ba, bb, mu, nu, moduli, torch.float64), 1)
    b_bms, b_by = scheme2_bound(*SCI_BATCHED, SCI_BATCHED[-1], SCI_M_FRONT,
                                8, 8)
    b_lib = time_ms(lambda: torch.matmul(ba, bb), 10)
    enc_ms, main_ms, gemm_ms, _ = plane_split("dgemm", ba, bb, mu, nu, moduli,
                                              10)
    bt, m, k = SCI_BATCHED
    # The same split on the wide tile, which the route leaves for the
    # narrow one on a grid this small.
    tile_n = ozaki2.plane_tile_n(bt, m, k, dev)
    _, wide_main, wide_gemm, _ = plane_split("dgemm", ba, bb, mu, nu, moduli,
                                             10, ozaki2.PLANE_TILE[1])
    batched = {"ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bms,
               "bound_by": b_by, "library_ms": b_lib, "encode_ms": enc_ms,
               "mainloop_ms": main_ms, "planes_ms": gemm_ms,
               "crt_ms": gemm_ms - main_ms,
               "mainloop_tops": bt * SCI_M_FRONT * 2 * m * k * k / main_ms
               / 1e9,
               "encode_bound_ms": encode_bound(m, k, k, SCI_M_FRONT, 8, 1,
                                               bt)[0],
               "tile_n": tile_n,
               "wide_tile": {"tile_n": ozaki2.PLANE_TILE[1],
                             "mainloop_ms": wide_main, "planes_ms": wide_gemm,
                             "crt_ms": wide_gemm - wide_main,
                             "route_ms": enc_ms + wide_gemm}}
    log(f"[scientific] front doors: ZGEMM and DGEMM fused == residue route, "
        f"4M == matmul_complex_4m, the float64 batch == its plain version "
        f"and scheme2.matmul per element, the complex128 batch == the 2-D "
        f"einsum, bit for bit; float64 batched {SCI_BATCHED} "
        f"m={SCI_M_FRONT}: route {b_ms:.4f} ms (encode {enc_ms:.4f}, "
        f"mainloop {main_ms:.4f} at {batched['mainloop_tops']:.1f} int8 "
        f"TOPS, CRT {gemm_ms - main_ms:.4f}; tile 128 x {tile_n}; on the "
        f"128 x {ozaki2.PLANE_TILE[1]} tile: mainloop {wide_main:.4f}, CRT "
        f"{wide_gemm - wide_main:.4f}, route {enc_ms + wide_gemm:.4f}), "
        f"plain {b_plain:.3f} ms, bound {b_bms:.4f} ms ({b_by}), cuBLAS "
        f"{b_lib:.4f} ms")
    return counts, out, batched


def encode_bound(m, k, n, p, part_bytes, phases, batch=1):
    """Least time of the two encodes of a ([batch,] M, K) @ ([batch,] K,
    N): the operands' parts and scales read once, the int8 planes
    (p * phases of them, K padded to the plane GEMM's tile) written
    once."""
    parts = 2 if phases == 3 else 1
    moved = (part_bytes * (parts * (m * k + k * n) + m + n)
             + p * phases * ozaki2.plane_k(k) * (m + n))
    return 1e3 * batch * moved / HBM_BYTES_PER_S, "bytes"


def planes_bound(m, k, n, p, out_bytes, phases):
    """Least time of the plane GEMM: the planes and scales read once and
    the output written once, against p * phases int8 GEMMs at the int8
    peak."""
    kp = ozaki2.plane_k(k)
    moved = p * phases * kp * (m + n) + 8 * (m + n) + out_bytes * m * n
    ops_ = p * phases * 2 * m * n * kp
    t_b, t_o = moved / HBM_BYTES_PER_S, ops_ / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def plane_split(kind, a, b, mu, nu, moduli, iters, tile_n=None):
    """The plane route's kernels timed apart on a route's operands, 2-D or
    batched: (the two encodes, the plane GEMM's mainloop alone, the plane
    GEMM with its CRT epilogue), ms; and the planes. ``tile_n`` sets the
    plane GEMM's tile width (default: the one the route chooses)."""
    bt, nut = b.transpose(-1, -2), nu.transpose(-1, -2)
    shape = (*a.shape[:-1], b.shape[-1])
    if kind == "dgemm":
        def enc():
            return (ozaki2.encode_planes(a, mu, moduli)[:, None],
                    ozaki2.encode_planes(bt, nut, moduli)[:, None])
        out = torch.empty(shape, dtype=torch.float64, device=a.device)
    else:
        def enc():
            return (ozaki3m.encode_planes_3m(a, mu, moduli),
                    ozaki3m.encode_planes_3m(bt, nut, moduli))
        out = torch.empty(shape, dtype=torch.complex128, device=a.device)
    enc_ms = time_ms(enc, iters)
    ap, bp = enc()
    main_ms = time_ms(lambda: ozaki2.launch_planes(
        ap, bp, mu, nu, moduli, out, epilogue=False, tile_n=tile_n), iters)
    gemm_ms = time_ms(lambda: ozaki2.launch_planes(
        ap, bp, mu, nu, moduli, out, tile_n=tile_n), iters)
    return enc_ms, main_ms, gemm_ms, (ap, bp)


def scientific_phase(dev):
    """DGEMM- and ZGEMM-grade Scheme II: the kernels against their plain
    versions, the front doors, then M = N = K = 4096 at m in {8, 12, 16}
    and 8192 at m = 16, float64 and complex128 on the plane route,
    beside their bounds, the plain versions (4096 only; at 8192 the
    route's first 256 rows are held against the plain version of those
    rows, which is exact because mu is per row and nu depends on b
    alone), the torch._int_mm yardstick and cuBLAS DGEMM / ZGEMM, with
    the encode, the mainloop and the CRT epilogue timed apart and the
    effective bits of the route and of cuBLAS against a longdouble
    product of 64 sampled rows computed on the host. At 4096^3, m = 16,
    each plane kernel is timed beside its plain version."""
    gen = torch.Generator(device=dev).manual_seed(14)
    max_err = dict.fromkeys(("encode", "encode_3m", "3m_2d", "3m_residues",
                             "f64_2d", "f64_batched", "f64_residues"), 0.0)
    t0 = time.perf_counter()
    scientific_kernel_checks(dev, gen, max_err)
    inputs = {(n, kind): (eq19(gen, (n, n), dtype, dev),
                          eq19(gen, (n, n), dtype, dev))
              for n, _ in SCI_SIZES
              for kind, dtype in (("dgemm", torch.float64),
                                  ("zgemm", torch.complex128))}
    n0, p_last = SCI_SIZES[0][0], SCI_SIZES[0][1][-1]
    counts, front, batched = scientific_main_path(
        dev, gen, *inputs[n0, "zgemm"], *inputs[n0, "dgemm"])
    pool = ThreadPoolExecutor(os.cpu_count() or 4)
    table, timings = [], {}
    try:
        # The host references run while the card works.
        samples, exact = {}, {}
        for (n, kind), (a, b) in inputs.items():
            samples[n, kind] = torch.randperm(n, generator=gen,
                                              device=dev)[:EVAL_ROWS]
            exact[n, kind] = extended_reference(a[samples[n, kind]], b, pool)
        for n, ps in SCI_SIZES:
            for kind in ("dgemm", "zgemm"):
                a, b = inputs[n, kind]
                lib_ms = time_ms(lambda: torch.matmul(a, b), 3)
                lib_out = torch.matmul(a, b)
                for p in ps:
                    moduli = default_moduli(p)
                    if kind == "dgemm":
                        mu, nu = scheme2.scales(a, b, moduli)
                        kern, plain = (ozaki2.fused_matmul_scheme2,
                                       ozaki2.fused_matmul_scheme2_plain)
                        bms, by = scheme2_bound(1, n, n, n, p, 8, 8)
                        n_mm = p
                    else:
                        mu, nu = complex3m.scales(a, b, moduli)
                        kern, plain = (ozaki3m.fused_matmul_3m,
                                       ozaki3m.fused_matmul_3m_plain)
                        bms, by = threem_bound(n, n, n, p, 8)
                        n_mm = 3 * p
                    f64 = torch.float64
                    out = kern(a, b, mu, nu, moduli, f64)      # warm-up
                    if n == n0:
                        ms = time_ms(lambda: kern(a, b, mu, nu, moduli, f64),
                                     3)
                        plain_ms, ref = timed(lambda: plain(a, b, mu, nu,
                                                            moduli, f64))
                        rows = slice(None)
                        if p == SCI_M_FRONT and not torch.equal(out,
                                                                front[kind]):
                            raise AssertionError(f"{kind}: einsum != the "
                                                 "direct kernel call")
                    else:
                        ms = time_ms(lambda: kern(a, b, mu, nu, moduli, f64),
                                     1)
                        plain_ms, rows = None, slice(0, SCI_ROWS)
                        ref = plain(a[rows], b, mu[rows], nu, moduli, f64)
                    check_equal(f"{kind} {n}^3 m={p} rows {rows}", out[rows],
                                ref, max_err,
                                "f64_2d" if kind == "dgemm" else "3m_2d")
                    del ref
                    phases = 1 if kind == "dgemm" else 3
                    enc_ms, main_ms, gemm_ms, planes = plane_split(
                        kind, a, b, mu, nu, moduli, 3 if n == n0 else 1)
                    split = {
                        "encode_ms": enc_ms, "mainloop_ms": main_ms,
                        "planes_ms": gemm_ms, "crt_ms": gemm_ms - main_ms,
                        "mainloop_tops": phases * p * 2 * n ** 3 / main_ms
                        / 1e9,
                        "encode_bound_ms": encode_bound(n, n, n, p, 8,
                                                        phases)[0],
                        **dict(zip(("planes_bound_ms", "planes_bound_by"),
                                   planes_bound(n, n, n, p,
                                                8 if phases == 1 else 16,
                                                phases)))}
                    if n == n0 and p == p_last:
                        # The plane kernels beside their plain versions.
                        if kind == "dgemm":
                            enc_p, mm_p = (ozaki2.encode_planes_plain,
                                           ozaki2.plane_matmul_plain)
                        else:
                            enc_p, mm_p = (ozaki3m.encode_planes_3m_plain,
                                           ozaki3m.plane_matmul_3m_plain)
                        split["encode_plain_ms"] = timed(lambda: (
                            enc_p(a, mu, moduli), enc_p(b.T, nu.T, moduli)))[0]
                        ap, bp = (x.squeeze(1) if kind == "dgemm" else x
                                  for x in planes)
                        split["planes_plain_ms"] = timed(lambda: mm_p(
                            ap, bp, mu, nu, moduli, f64))[0]
                        del ap, bp
                    del planes
                    yard = time_ms(int_mm_yardstick(gen, dev, 1, n, n, n,
                                                    n_mm), 1)
                    ref_rows = exact[n, kind]()
                    bits = effective_bits(out[samples[n, kind]], ref_rows)
                    lib_bits = effective_bits(lib_out[samples[n, kind]],
                                              ref_rows)
                    row = {"kind": kind, "n": n, "m": p, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bms,
                           "bound_by": by, "int_mm_yardstick_ms": yard,
                           "library_ms": lib_ms, "bits": bits,
                           "library_bits": lib_bits, **split}
                    table.append(row)
                    timings[kind, n, p] = row
                    plain_txt = ("not run" if plain_ms is None
                                 else f"{plain_ms:.3f} ms")
                    log(f"[scientific] {kind} {n}^3 m={p}: route {ms:.3f} "
                        f"ms (encode {enc_ms:.3f}, mainloop {main_ms:.3f} at "
                        f"{split['mainloop_tops']:.1f} int8 TOPS, CRT "
                        f"{gemm_ms - main_ms:.3f}), bound {bms:.4f} ms "
                        f"({by}), plain {plain_txt}, yardstick "
                        f"torch._int_mm x{n_mm} {yard:.3f} ms, cuBLAS "
                        f"{lib_ms:.3f} ms; effective bits {bits:.2f} (cuBLAS "
                        f"{lib_bits:.2f})")
                    del out
                del lib_out
            for kind in ("dgemm", "zgemm"):
                if n != n0:
                    del inputs[n, kind]
            torch.cuda.empty_cache()
        # The residue forms at the DGEMM / ZGEMM shape and moduli.
        p = SCI_SIZES[0][1][-1]
        moduli = default_moduli(p)
        res = {}
        for form, phases, run_k, run_p, bound in (
                ("3m_residues", 3, ozaki3m.fused_3m_residue_matmul,
                 ozaki3m.fused_3m_residue_matmul_plain, threem_residue_bound),
                ("residues", None, ozaki2.fused_residue_matmul,
                 ozaki2.fused_residue_matmul_plain, residue_bound)):
            lead = (p, phases) if phases else (p,)
            a_r = torch.randint(-128, 128, lead + (n0, n0), generator=gen,
                                device=dev, dtype=torch.int8)
            b_r = torch.randint(-128, 128, lead + (n0, n0), generator=gen,
                                device=dev, dtype=torch.int8)
            ms = time_ms(lambda: run_k(a_r, b_r, moduli), 3)
            plain_ms = time_ms(lambda: run_p(a_r, b_r, moduli), 1)
            bms, by = bound(n0, n0, n0, p)
            res[form] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by}
            log(f"[scientific] {form} p={p} {n0}^3 (int8 in and out): "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bms:.4f} ms ({by})")
            del a_r, b_r
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    log("[scientific] table " + json.dumps(table))
    log(f"[scientific] phase took {time.perf_counter() - t0:.1f} s")
    return max_err, counts, timings, res, batched


def emu_train_parity_phase(dev, arch, params):
    """One full-width step of olmo-1b-emu under its gemm_sites: loss and
    gradients bit-identical on the 'cuda' and 'torch' backends."""
    def run(backend):
        _, batch = next(train_batches(arch))
        loss_fn = S.make_loss_fn(arch, on_backend(arch.gemm_policy(),
                                                  backend))
        return S.value_and_grad(loss_fn, params, S.batch_to(batch, dev))

    grads_equal(f"(e) {arch.model.name}, cuda == torch backend",
                run("cuda"), run("torch"))


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


# ---------------------------------------------------------------------------
# Phase 19: the library kernels (K8, K11, K9, K10).
# ---------------------------------------------------------------------------

def lhs_bound(m, k, p, in_bytes):
    """K11: A and mu read once, the p planes of (M, Kp) written once."""
    moved = in_bytes * m * k + 4 * m + p * m * decompose.round_up(k)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def int8_bound(m, k, n):
    moved = m * k + k * n + 4 * m * n
    t_b, t_o = moved / HBM_BYTES_PER_S, 2 * m * n * k / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def attn_bound(b, h, kvh, sq, sk, d, causal, window, kernel):
    """q, k, v and o moved once, against 4 D flops for every (q, k) pair
    a head sees (half the pairs, plus the diagonal, when causal with
    S_q = S_k) at the peak of the kernel's arithmetic: the bf16 tensor
    cores ('wgmma'), three times the flops at the TF32 peak
    ('wgmma-3xtf32'), or float32 outside the tensor cores ('ffma')."""
    size = 2 if kernel == "wgmma" else 4
    moved = size * d * (2 * b * h * sq + 2 * b * kvh * sk)
    pairs = int(flash_attn.visible(sq, sk, causal, window).sum())
    flops = 4 * b * h * d * pairs
    t_b = moved / HBM_BYTES_PER_S
    t_o = {"wgmma": flops / BF16_FLOPS_PER_S,
           "wgmma-3xtf32": 3 * flops / TF32_FLOPS_PER_S,
           "ffma": flops / FP32_FLOPS_PER_S}[kernel]
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def split_bound(b, h, kvh, sq, sk, d):
    """The 3xTF32 pre-pass: float32 q, k, v read once, both parts of q, k
    and of v^T (keys padded to 32) written once."""
    skp = -(-sk // 32) * 32
    moved = 4 * d * (3 * b * h * sq + 4 * b * kvh * sk + 2 * b * kvh * skp)
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def library_counts():
    return {"emugemm1": ozaki1.LaunchCounts(**vars(ozaki1.COUNTS)),
            "decompose": decompose.LaunchCounts(**vars(decompose.COUNTS)),
            "int8": matmul_int8.LaunchCounts(**vars(matmul_int8.COUNTS)),
            "flash": flash_attn.LaunchCounts(**vars(flash_attn.COUNTS))}


def scheme1_cfg(p, decomp):
    return dataclasses.replace(api.precision(f"ozaki1-p{p}"), decomp=decomp)


def naive_scheme1(a, b, p, beta):
    """Paper Fig. 4's naive emulation: split both operands, p(p+1)/2 int8
    GEMMs (K9), each written to device memory, summed into p int32
    accumulators, then a separate shift-reduce."""
    a_sl, mu = scheme1.split(a, p, beta, dim=1)
    b_sl, nu = scheme1.split(b, p, beta, dim=0)
    accs = []
    for s in range(p):
        acc = ops.int8_matmul(a_sl[0], b_sl[s])
        for i in range(1, s + 1):
            acc = acc + ops.int8_matmul(a_sl[i], b_sl[s - i])
        accs.append(acc)
    return scheme1.shift_reduce(torch.stack(accs), beta, mu, nu,
                                torch.float32)


def fused_scheme1(a, b, p, beta):
    """The same GEMM in one EmuGEMM-I launch (K1), scales included."""
    mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
    return ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, beta, torch.float32)


def attn_inputs(gen, dev, case):
    _, b, h, kvh, sq, sk, d, _, _, dt = case
    dtype = getattr(torch, dt)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, h, sq, d), (b, kvh, sk, d),
                               (b, kvh, sk, d)))


def check_close(what, out, ref, tol, max_err, key):
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    max_err[key] = max(max_err[key], err)
    if bool((diff > tol + tol * ref.float().abs()).any()) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"{what}: kernel differs from the plain version "
                             f"beyond {tol}, max |diff| {err}")
    return err


def library_phase(dev, mcfg):
    """K11 and K8 (the 'xla' route of ops.fused_scheme1_matmul and the
    lhs + rhs decompositions feeding the interleaved form), K9 (the int8
    baseline and the naive structure it composes) and K10 (fused
    attention at the head layouts of olmo-1b, granite-3-8b and
    recurrentgemma-2b): checked against their plain versions, driven
    through the library's entry points with the counts read around them,
    and timed beside their bounds and library calls."""
    gen = torch.Generator(device=dev).manual_seed(19)
    max_err = {"interleaved": 0.0, "lhs": 0.0, "int8": 0.0, "flash": 0.0,
               "flash_f32": 0.0, "split": 0.0}
    shapes = dense_shapes(mcfg)

    # (a) K11 and K8, bit for bit: against the plain versions, K11 + K2r
    # -> K8 against K1 on the same operands, the 'xla' route against the
    # 'kernel' route.
    checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for p in LIB_P:
            for m, k, n in shapes + [LIB_RAGGED]:
                a = conditioned(gen, (m, k), dtype, dev)
                b = conditioned(gen, (k, n), dtype, dev)
                beta = scheme1_cfg(p, "xla").resolved_beta(k)
                mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
                what = f"{(m, k, n)} {dtype} p={p}"
                a_hat = decompose.decompose_interleave(a, mu, p, beta)
                check_equal(f"K11 {what}", a_hat,
                            decompose.decompose_lhs_plain(a, mu, p, beta),
                            max_err, "lhs")
                b_hat = decompose.decompose_interleave_rhs(b, nu, p, beta)
                out = ozaki1.fused_matmul_interleaved(a_hat, b_hat, mu, nu,
                                                      p, beta, dtype)
                check_equal(f"K8 {what}", out,
                            ozaki1.fused_matmul_interleaved_plain(
                                a_hat, b_hat, mu, nu, p, beta, dtype),
                            max_err, "interleaved")
                if not torch.equal(out, ozaki1.fused_matmul_scheme1(
                        a, b, mu, nu, p, beta, dtype)):
                    raise AssertionError(f"K11 + K2r -> K8 != K1 at {what}")
                routes = [ops.fused_scheme1_matmul(
                    a, b, scheme1_cfg(p, d), out_dtype=dtype)
                    for d in ("xla", "kernel")]
                if not torch.equal(*routes):
                    raise AssertionError(f"ops.fused_scheme1_matmul: 'xla' "
                                         f"!= 'kernel' at {what}")
                checks += 1
                del a, b, a_hat, b_hat, out, routes
    log(f"[library] K11 and K8: {checks} shape/type/p cases bit-identical to "
        "their plain versions; K11 + K2r -> K8 == K1 and the 'xla' route "
        "== the 'kernel' route in every case")

    # (b) K9, bit for bit.
    for m, k, n in INT8_CHECK:
        a8 = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        b8 = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        check_equal(f"K9 {(m, k, n)}", matmul_int8.int8_matmul(a8, b8),
                    matmul_int8.int8_matmul_plain(a8, b8), max_err, "int8")
    log(f"[library] K9 bit-identical to its plain version at {INT8_CHECK}")

    # The main path: the library's entry points, counts zeroed just before
    # and read just after. Nothing here compares with a plain version.
    bf, p = torch.bfloat16, P_MAIN
    xs = [(conditioned(gen, (m, k), bf, dev), conditioned(gen, (k, n), bf, dev))
          for m, k, n in shapes]
    na = conditioned(gen, (NAIVE_N, NAIVE_N), torch.float32, dev)
    nb = conditioned(gen, (NAIVE_N, NAIVE_N), torch.float32, dev)
    naive_beta = scheme1_cfg(p, "xla").resolved_beta(NAIVE_N)
    qkvs = [attn_inputs(gen, dev, c) for c in ATTN_CASES]
    torch.cuda.synchronize()
    reset_counts()
    routed = [ops.fused_scheme1_matmul(a, b, scheme1_cfg(p, "xla"),
                                       out_dtype=bf) for a, b in xs]
    composed = []
    for a, b in xs:
        beta = scheme1_cfg(p, "xla").resolved_beta(a.shape[1])
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        composed.append(ozaki1.fused_matmul_interleaved(
            decompose.decompose_interleave(a, mu, p, beta),
            decompose.decompose_interleave_rhs(b, nu, p, beta), mu, nu, p,
            beta, bf))
    naive = naive_scheme1(na, nb, p, naive_beta)
    attn = [flash_attn.flash_attention(q, k, v, causal=c[7], window=c[8])
            for c, (q, k, v) in zip(ATTN_CASES, qkvs)]
    torch.cuda.synchronize()
    counts = library_counts()
    e1, dc = counts["emugemm1"], counts["decompose"]
    n_mm = p * (p + 1) // 2
    kernels = [flash_attn.instance(getattr(torch, c[9]), c[6]).kernel
               for c in ATTN_CASES]
    log(f"[library] main path: K8 {e1.launches_interleaved}, K11 "
        f"{dc.launches_lhs}, K2r {dc.launches_rhs}, K9 "
        f"{counts['int8'].launches}, K10 {counts['flash'].launches} "
        f"({', '.join(kernels)}; the 3xTF32 pre-pass "
        f"{counts['flash'].launches_split}), K1 {e1.launches_2d}, plain "
        f"versions on CUDA {sum(c.plain_cuda_calls for c in counts.values())}")
    fl = counts["flash"]
    expected = (2 * len(shapes), len(shapes), len(shapes), n_mm,
                len(ATTN_CASES), kernels.count("wgmma-3xtf32"),
                kernels.count("ffma"), kernels.count("wgmma-3xtf32"), 0)
    got = (e1.launches_interleaved, dc.launches_lhs, dc.launches_rhs,
           counts["int8"].launches, fl.launches, fl.launches_3xtf32,
           fl.launches_ffma, fl.launches_split, e1.launches_2d)
    if got != expected:
        raise AssertionError(f"library main path launches {got}, expected "
                             f"{expected}")
    if any(c.plain_cuda_calls for c in counts.values()):
        raise AssertionError("the library path ran a plain version on CUDA")
    for (a, b), r, c in zip(xs, routed, composed):
        if not (torch.equal(r, c) and torch.equal(r, ops.fused_scheme1_matmul(
                a, b, scheme1_cfg(p, "kernel"), out_dtype=bf))):
            raise AssertionError(f"the 'xla' route, the decompositions + K8 "
                                 f"and K1 differ at {tuple(a.shape)} @ "
                                 f"{tuple(b.shape)}")
    if not torch.equal(naive, fused_scheme1(na, nb, p, naive_beta)):
        raise AssertionError("the naive K9 composition != K1")
    for c, (q, k, v), out in zip(ATTN_CASES, qkvs, attn):
        check_close(f"K10 {c}", out, flash_attn.flash_attention_plain(
            q, k, v, c[7], c[8]), ATTN_TOL[c[9]], max_err,
            "flash" if c[9] == "bfloat16" else "flash_f32")
    for c, (q, k, v), kernel in zip(ATTN_CASES, qkvs, kernels):
        if kernel == "wgmma-3xtf32":
            parts = flash_attn.split_3xtf32(q, k, v)
            plain = flash_attn.split_3xtf32_plain(q, k, v)
            for x, y in zip(parts, plain):
                check_equal(f"K10 3xTF32 pre-pass {c}", x, y, max_err,
                            "split")
            del parts, plain
    log(f"[library] on the main path the 'xla' route == K11 + K2r -> K8 == "
        f"K1, the naive K9 composition at {NAIVE_N}^3 == K1, and K10 within "
        f"its bars in {len(ATTN_CASES)} cases (max |diff| bf16 "
        f"{max_err['flash']:.3g}, float32 {max_err['flash_f32']:.3g}); the "
        "3xTF32 pre-pass bit-identical to its plain version")
    del routed, composed, naive, attn

    # Times. K8 and K11 summed over one launch at each dense shape.
    t8, t11 = ({"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
                "ops_ms": 0.0, "yardstick_ms": 0.0} for _ in range(2))
    for (m, k, n), (a, b) in zip(shapes, xs):
        beta = scheme1_cfg(p, "xla").resolved_beta(k)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        a_hat = decompose.decompose_interleave(a, mu, p, beta)
        b_hat = decompose.decompose_interleave_rhs(b, nu, p, beta)
        for tot, run_k, run_p, (bms, by) in (
                (t8, lambda: ozaki1.fused_matmul_interleaved(
                    a_hat, b_hat, mu, nu, p, beta, bf),
                 lambda: ozaki1.fused_matmul_interleaved_plain(
                     a_hat, b_hat, mu, nu, p, beta, bf),
                 bound_ms(1, m, k, n, p, p, 2)),     # p bytes an element in
                (t11, lambda: decompose.decompose_interleave(a, mu, p, beta),
                 lambda: decompose.decompose_lhs_plain(a, mu, p, beta),
                 lhs_bound(m, k, p, 2))):
            _add(tot, 1, time_ms(run_k, 10), time_ms(run_p, 3), 0.0, bms, by)
        log(f"[library] M={m} K={k} N={n} bf16 p={p}: K8 and K11 running "
            f"totals {t8['ms']:.4f} / {t11['ms']:.4f} ms")
    log(f"[library] K8 per {len(shapes)} dense shapes: kernel "
        f"{t8['ms']:.4f} ms, plain {t8['plain_ms']:.4f} ms, bound "
        f"{t8['bound_ms']:.4f} ms; K11: kernel {t11['ms']:.4f} ms, plain "
        f"{t11['plain_ms']:.4f} ms, bound {t11['bound_ms']:.4f} ms (bytes)")
    del xs

    # K9 beside torch._int_mm (the library call) and its bound.
    t9 = []
    for n_ in INT8_TIMED:
        a8 = torch.randint(-128, 128, (n_, n_), generator=gen, device=dev,
                           dtype=torch.int8)
        b8 = torch.randint(-128, 128, (n_, n_), generator=gen, device=dev,
                           dtype=torch.int8)
        ms = time_ms(lambda: matmul_int8.int8_matmul(a8, b8), 10)
        plain = time_ms(lambda: matmul_int8.int8_matmul_plain(a8, b8), 3)
        lib = time_ms(lambda: torch._int_mm(a8, b8), 10)
        bms, by = int8_bound(n_, n_, n_)
        t9.append({"n": n_, "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": bms, "bound_by": by})
        log(f"[library] K9 {n_}^3: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch._int_mm {lib:.4f} ms, bound {bms:.4f} ms ({by})")
        del a8, b8
    naive_ms = time_ms(lambda: naive_scheme1(na, nb, p, naive_beta), 3)
    fused_ms = time_ms(lambda: fused_scheme1(na, nb, p, naive_beta), 3)
    log(f"[library] Fig. 4 at {NAIVE_N}^3, float32, p={p}: naive ({n_mm} K9 "
        f"launches, split and shift-reduce in torch) {naive_ms:.3f} ms, "
        f"fused (K1, one launch) {fused_ms:.3f} ms, naive/fused "
        f"{naive_ms / fused_ms:.3f}")
    del na, nb

    # K10 beside its bound and, where it runs the case without an explicit
    # mask, scaled_dot_product_attention (the library call).
    # The float32 rows also beside the FFMA bound, with the pre-pass timed
    # alone and the device kernels one call runs (torch.profiler).
    t10 = []
    for c, (q, k, v), kernel in zip(ATTN_CASES, qkvs, kernels):
        label, b_, h, kvh, sq, sk, d, causal, window, dt = c

        def run():
            return flash_attn.flash_attention(q, k, v, causal=causal,
                                              window=window)
        ms = time_ms(run, 10)
        plain = time_ms(lambda: flash_attn.flash_attention_plain(
            q, k, v, causal, window), 3)
        lib = None
        if window is None:
            lib = time_ms(lambda: torch.nn.functional.
                          scaled_dot_product_attention(
                              q, k, v, is_causal=causal,
                              enable_gqa=h != kvh), 10)
        bms, by = attn_bound(b_, h, kvh, sq, sk, d, causal, window, kernel)
        row = {"case": label, "shape": [b_, h, kvh, sq, sk, d],
               "causal": causal, "window": window, "dtype": dt,
               "instance": dataclasses.asdict(
                   flash_attn.instance(getattr(torch, dt), d)),
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bms, "bound_by": by}
        if dt == "float32":
            row["bound_ffma_ms"] = attn_bound(b_, h, kvh, sq, sk, d, causal,
                                              window, "ffma")[0]
            row["device_kernels_ms"] = yardstick_kernels(run, 3)
        if kernel == "wgmma-3xtf32":
            row["split_ms"] = time_ms(
                lambda: flash_attn.split_3xtf32(q, k, v), 10)
            row["split_plain_ms"] = time_ms(
                lambda: flash_attn.split_3xtf32_plain(q, k, v), 3)
            row["split_bound_ms"] = split_bound(b_, h, kvh, sq, sk, d)[0]
        t10.append(row)
        log(f"[library] K10 {label} {dt} B={b_} H={h}/{kvh} S={sq}/{sk} "
            f"D={d} ({kernel}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bms:.4f} ms ({by})" + "".join(
                f", {key} {row[key]}" for key in (
                    "bound_ffma_ms", "split_ms", "split_plain_ms",
                    "split_bound_ms", "device_kernels_ms") if key in row))
    del qkvs

    f32 = next(r for r in t10 if r["instance"]["kernel"] == "wgmma-3xtf32")
    ffma = next(r for r in t10 if r["instance"]["kernel"] == "ffma")

    def totals(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                else "operations"}

    common = {"route": "cuda"}
    lib_per = (f"one launch at each of olmo-1b's dense shapes at {TOKENS} "
               f"tokens, bf16, p = {p} (launches: phase 19's main path)")
    return [
        {"name": "emugemm1_interleaved", **common, "source": SOURCE,
         "replaces": "src/repro/kernels/ozaki1.py:118",
         "launches": e1.launches_interleaved,
         "max_abs_err": max_err["interleaved"], **totals(t8),
         "library_ms": None, "per": lib_per},
        {"name": "decompose_lhs", **common, "source": DECOMPOSE_SOURCE,
         "replaces": "src/repro/kernels/decompose.py:42",
         "launches": dc.launches_lhs, "max_abs_err": max_err["lhs"],
         **totals(t11), "library_ms": None, "per": lib_per},
        {"name": "int8_matmul", **common, "source": SOURCE_INT8,
         "replaces": "src/repro/kernels/matmul_int8.py:38",
         "launches": counts["int8"].launches, "max_abs_err": max_err["int8"],
         **{key: t9[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
         "per": f"one {INT8_TIMED[0]}^3 GEMM; library: torch._int_mm "
                f"(launches: the naive Fig. 4 structure at {NAIVE_N}^3)",
         "cases": t9, "naive_fig4_ms": naive_ms, "fused_k1_ms": fused_ms},
        {"name": "flash_attention", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches - fl.launches_3xtf32 - fl.launches_ffma,
         "max_abs_err": max_err["flash"],
         **{key: t10[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
         "per": f"one call at {ATTN_CASES[0][0]} {ATTN_CASES[0][9]} "
                f"{list(t10[0]['shape'])} on the bf16 wgmma kernel; "
                "library: scaled_dot_product_attention (launches: one per "
                "bf16 case)",
         "cases": t10},
        {"name": "flash_attention_3xtf32", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches_3xtf32, "max_abs_err": max_err["flash_f32"],
         **{key: f32[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "bound_ffma_ms", "split_ms")},
         "per": f"one call at {f32['case']} float32 {list(f32['shape'])}: "
                "the pre-pass and the 3xTF32 wgmma kernel; bound: 3 TF32 "
                "products at the TF32 peak; library: "
                "scaled_dot_product_attention (launches: one per float32 "
                "case at D <= 128)"},
        {"name": "flash_split_3xtf32", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches_split, "max_abs_err": max_err["split"],
         "ms": f32["split_ms"], "plain_ms": f32["split_plain_ms"],
         "bound_ms": f32["split_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "per": f"the 3xTF32 pre-pass of one call at {f32['case']} float32 "
                "(launches: one per 3xTF32 call)"},
        {"name": "flash_attention_ffma", **common, "source": SOURCE_FLASH,
         "replaces": "src/repro/kernels/flash_attn.py:75",
         "launches": fl.launches_ffma, "max_abs_err": max_err["flash_f32"],
         **{key: ffma[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
         "per": f"one call at {ffma['case']} float32 {list(ffma['shape'])} "
                "(D = 256: the 3xTF32 kernel's q parts would not fit); "
                "library: none without an explicit mask"},
    ]


def build_phase():
    """nvcc for each kernel source, all started together."""
    t0 = time.perf_counter()
    names = ("emugemm1", "decompose", "emugemm2", "emugemm2_planes",
             "emugemm3m", "matmul_int8", "flash_attn")
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
    card = smi.stdout.strip()
    log(card)
    build_phase()
    k10_f32_kernels = yardstick_phase(dev)

    arch = configs.get_config("olmo-1b")
    view_tokens = PAGE * math.ceil((PROMPT + GEN - 1 + CHUNK) / PAGE)
    spec_policy = GemmPolicy(default=api.precision(SPEC))
    max_err, totals = kernel_phase(dev, arch.model, view_tokens)
    eng, (counts, _), serve = serve_phase(dev, arch, spec_policy)
    serve.update(parity_phase(dev, arch, eng.params, view_tokens,
                              spec_policy, SPEC))
    log("[serve] summary " + json.dumps(serve))
    profile_phase(dev, arch, eng.params, view_tokens,
                  ((SPEC, spec_policy),
                   ("native", GemmPolicy(default=api.precision("native")))))
    del eng

    t_err, t_totals = train_kernel_phase(dev, arch.model)
    params, (k1, k2, _), train = train_phase(
        dev, arch, card, GemmPolicy(default=api.precision(TRAIN_SPEC)))
    log("[train] summary " + json.dumps(
        {k: v for k, v in train.items() if k != "profile"}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    rhs_launches = train_parity_phase(dev, arch, params)
    del params
    trainer_phase()
    torch.use_deterministic_algorithms(False)

    # olmo-1b-emu: Scheme II on attn_qk, under the config's gemm_sites.
    emu = configs.get_config(EMU)
    s2_err, s2_totals = scheme2_kernel_phase(dev, emu.model, view_tokens)
    lib_counts, lib_totals = scheme2_library_phase(dev, emu.model)
    eng, (e1, e2), emu_serve = serve_phase(dev, emu, None)
    emu_serve.update(parity_phase(dev, emu, eng.params, view_tokens,
                                  eng.policy, EMU))
    log(f"[serve {EMU}] summary " + json.dumps(emu_serve))
    profile_phase(dev, emu, eng.params, view_tokens, ((EMU, eng.policy),))
    del eng
    params, (ek1, ek2, ek3), emu_train = train_phase(dev, emu, card,
                                                      long_seq=False)
    log(f"[train {EMU}] summary " + json.dumps(
        {k: v for k, v in emu_train.items() if k != "profile"}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    emu_train_parity_phase(dev, emu, params)
    hoisted_parity_phase(dev, micro_arch(emu), params,
                         dispatch.resolve_policy(emu.gemm_policy()), "f")
    del params
    torch.use_deterministic_algorithms(False)

    # DGEMM- and ZGEMM-grade Scheme II.
    sci_err, sci_counts, sci_t, sci_res, sci_batched = scientific_phase(dev)

    # olmo-1b trained under ozaki2-m6+cached with gradient accumulation:
    # EmuGEMM-II's prepared form and the once-per-step hoist.
    p_err, p_totals = prepared_kernel_phase(dev, arch.model)
    params, hk, hoist = hoisted_train_phase(dev, arch, card)
    log("[hoist] summary " + json.dumps(
        {k: v for k, v in hoist.items() if k != "profile"}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    hoisted_parity_phase(
        dev, micro_arch(arch), params,
        GemmPolicy(default=api.precision(HOIST_SPEC)), "g",
        uncached=GemmPolicy(default=api.precision(f"ozaki2-m{M_MAIN}")),
        torch_backend=True)
    del params
    torch.use_deterministic_algorithms(False)

    # The library kernels.
    library_rows = library_phase(dev, arch.model)

    def bound_by(t):
        return "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"

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
            "bound_ms": t["bound_ms"], "bound_by": bound_by(t),
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
               "bound_ms": t["bound_ms"], "bound_by": bound_by(t), "per": per}
        if key == "mixed":
            row["int_mm_yardstick_ms"] = t["yardstick_ms"]
        kernels.append(row)
    lib_per = (f"one launch at each of olmo-1b's dense shapes at {TOKENS} "
               f"tokens under ozaki2-m{M_MAIN}, bf16 (launches: the library "
               "route's run)")
    for form, name, replaces, launches in (
            ("2d", "emugemm2_2d", "src/repro/kernels/backends/gpu.py:359",
             lib_counts.launches_2d),
            ("residues", "emugemm2_residues", "src/repro/kernels/ozaki2.py:52",
             lib_counts.launches_residues)):
        t = lib_totals[form]
        kernels.append({
            "name": name, **common, "source": SOURCE2, "replaces": replaces,
            "launches": launches, "max_abs_err": s2_err[form],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": bound_by(t),
            "int_mm_yardstick_ms": t["yardstick_ms"], "per": lib_per})
    t = s2_totals["mixed"]
    kernels.append({
        "name": "emugemm2_batched", **common, "source": SOURCE2,
        "replaces": "src/repro/kernels/backends/gpu.py:409",
        "launches": e2.launches_batched, "max_abs_err": s2_err["batched"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": bound_by(t), "int_mm_yardstick_ms": t["yardstick_ms"],
        "per": f"one mixed serve step of {EMU} (attn_qk, ozaki2-m{M_MAIN})",
        "launches_in_train_run": ek3.launches_batched,
        "per_train_step": {k: s2_totals["train"][k]
                           for k in ("ms", "plain_ms", "bound_ms",
                                     "yardstick_ms")}})
    hoist_per = (f"one {HOIST_SPEC} train step of full-width olmo-1b "
                 f"({HOIST_MICRO} microbatches of {TOKENS // HOIST_MICRO} "
                 f"tokens; launches: the warm-up and {TRAIN_STEPS} timed "
                 "steps)")
    kernels.append({
        "name": "emugemm2_prepared", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/backends/gpu.py:359",
        "launches": hk.launches_prepared, "max_abs_err": p_err["prepared"],
        "ms": p_totals["ms"], "plain_ms": p_totals["plain_ms"],
        "bound_ms": p_totals["bound_ms"], "bound_by": bound_by(p_totals),
        **{k: p_totals[k] for k in ("encode_ms", "planes_ms", "mainloop_ms",
                                    "crt_ms", "weight_encode_ms",
                                    "float_rhs_ms")},
        "launches_encode": hk.launches_encode,
        "launches_planes": hk.launches_planes,
        "int_mm_yardstick_ms": p_totals["yardstick_ms"],
        "per": hoist_per + "; the plane route: an lhs encode (real float32 "
               "/ bf16 instances) and a plane GEMM a call, the weights' "
               "encodes apart"})
    for row in kernels:
        if row["name"] in ("emugemm2_2d", "emugemm2_batched"):
            row["launches_in_hoisted_train"] = (
                hk.launches_2d if row["name"] == "emugemm2_2d"
                else hk.launches_batched)
    # The float64 entry of EmuGEMM-II's residue row, the plane route of
    # DGEMM, ZGEMM and the float64 batch, and K7.
    n0, p_sci = SCI_SIZES[0][0], SCI_SIZES[0][1][-1]
    dgemm, zgemm = sci_t["dgemm", n0, p_sci], sci_t["zgemm", n0, p_sci]
    sci_per = (f"one {{}} {n0}^3 at m = {p_sci} (launches: the scientific "
               f"front doors at m = {SCI_M_FRONT})")
    f64_rows = {
        "emugemm2_residues": {**sci_res["residues"], "library_ms": None,
                              "max_abs_err": sci_err["f64_residues"],
                              "launches": sci_counts["emugemm2_residues"],
                              "per": sci_per.format(
                                  "residue GEMM of the DGEMM route")}}
    for row in kernels:
        if row["name"] in f64_rows:
            row["float64"] = f64_rows[row["name"]]
    for t, prefix, replaces, what, enc_err in (
            (dgemm, "emugemm2", "src/repro/kernels/backends/gpu.py:359",
             "DGEMM-grade float64 GEMM", "encode"),
            (zgemm, "emugemm3m", "src/repro/kernels/backends/gpu.py:522",
             "ZGEMM-grade complex128 GEMM", "encode_3m")):
        kernels.append({
            "name": f"{prefix}_encode", **common, "source": SOURCE_PLANES,
            "replaces": replaces,
            "launches": sci_counts[f"{prefix}_encode"],
            "max_abs_err": sci_err[enc_err], "ms": t["encode_ms"],
            "plain_ms": t["encode_plain_ms"],
            "bound_ms": t["encode_bound_ms"], "bound_by": "bytes",
            "per": sci_per.format(f"pair of operand encodes of a {what}")})
        kernels.append({
            "name": f"{prefix}_planes", **common, "source": SOURCE_PLANES,
            "replaces": replaces,
            "launches": sci_counts[f"{prefix}_planes"],
            "max_abs_err": sci_err["f64_2d" if prefix == "emugemm2"
                                   else "3m_2d"],
            "ms": t["planes_ms"], "plain_ms": t["planes_plain_ms"],
            "bound_ms": t["planes_bound_ms"],
            "bound_by": t["planes_bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("mainloop_ms", "crt_ms", "mainloop_tops",
                                 "bits", "library_bits",
                                 "int_mm_yardstick_ms")},
            "route_ms": t["ms"], "route_plain_ms": t["plain_ms"],
            "route_bound_ms": t["bound_ms"],
            "per": sci_per.format(what) + "; library: cuBLAS on the "
                   "float operands; route: the encodes and the plane GEMM"})
    kernels.append({
        "name": "emugemm2_planes_batched", **common, "source": SOURCE_PLANES,
        "replaces": "src/repro/kernels/backends/gpu.py:409",
        "launches": sci_counts["emugemm2_planes"],
        "max_abs_err": sci_err["f64_batched"], **sci_batched,
        "per": f"one float64 batched GEMM {SCI_BATCHED} at m = "
               f"{SCI_M_FRONT}: the route, its 2 encodes and the plane GEMM "
               "with the batch coordinate; library: cuBLAS batched DGEMM "
               "(launches: the plane GEMM's on the scientific front doors, "
               "the DGEMM's and the float64 batch's)"})
    kernels.append({
        "name": "emugemm3m_residues", **common, "source": SOURCE3M,
        "replaces": "src/repro/kernels/ozaki3m.py:72",
        "launches": sci_counts["emugemm3m_residues"],
        "max_abs_err": sci_err["3m_residues"], **sci_res["3m_residues"],
        "int_mm_yardstick_ms": zgemm["int_mm_yardstick_ms"],
        "per": sci_per.format("3p-product residue GEMM of the ZGEMM route")})
    for row in library_rows:
        if row["name"] in ("flash_attention_3xtf32", "flash_split_3xtf32"):
            row["device_kernels_ms"] = {
                k: v for k, v in k10_f32_kernels.items()
                if ("split" in k) == (row["name"] == "flash_split_3xtf32")}
    kernels += library_rows
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
