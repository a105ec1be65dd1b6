"""Analytical HBM-traffic models from the paper (Eqs. 9, 10, 14, 15, 17,
18), the port's copy of ``repro.core.traffic``.

These feed the telemetry's modeled bytes (``telemetry.record``), the
roofline projections (``utils.roofline``) and the per-site bounds of
``utils.perf_probe``. All results in bytes; ``out_bytes`` is the output
element size (4 = FP32, 8 = FP64). Every model is the reference's, integer
for integer; the peak table below differs (its comment says how).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GemmShape:
    m: int
    n: int
    k: int


def scheme1_naive_bytes(s: GemmShape, p: int, out_bytes: int = 8) -> int:
    """Paper Eq. 9: per-slice-pair kernel launches + INT32 round-trips."""
    operand = p * (p + 1) // 2 * (s.m + s.n) * s.k
    int32_traffic = 4 * p * (p + 1) * s.m * s.n
    return operand + int32_traffic + out_bytes * s.m * s.n


def scheme1_fused_bytes(s: GemmShape, p: int, out_bytes: int = 8) -> int:
    """Paper Eq. 10: each slice loaded once; accumulators never leave chip."""
    return p * (s.m + s.n) * s.k + out_bytes * s.m * s.n


def scheme2_naive_bytes_per_modulus(s: GemmShape) -> int:
    """Paper Eq. 14: INT32 write+read round-trip plus INT8 residue write."""
    return (s.m + s.n) * s.k + 8 * s.m * s.n + s.m * s.n


def scheme2_fused_bytes_per_modulus(s: GemmShape) -> int:
    """Paper Eq. 15: in-epilogue mod reduce — only the INT8 residue leaves."""
    return (s.m + s.n) * s.k + s.m * s.n


def scheme2_3m_naive_bytes_per_modulus(s: GemmShape) -> int:
    """Paper Eq. 17: three INT32 round-trips + two INT8 writes."""
    return 3 * (s.m + s.n) * s.k + 24 * s.m * s.n + 2 * s.m * s.n


def scheme2_3m_fused_bytes_per_modulus(s: GemmShape) -> int:
    """Paper Eq. 18: the 24MN intermediate term vanishes."""
    return 3 * (s.m + s.n) * s.k + 2 * s.m * s.n


def int8_gemm_flops(s: GemmShape) -> int:
    """MAC-pair ops of one int8 GEMM (2MNK)."""
    return 2 * s.m * s.n * s.k


def scheme1_flops(s: GemmShape, p: int) -> int:
    return p * (p + 1) // 2 * int8_gemm_flops(s)


def scheme2_flops(s: GemmShape, p: int, complex_3m: bool = False) -> int:
    mult = 3 if complex_3m else 1
    return mult * p * int8_gemm_flops(s)


def arithmetic_intensity(flops: int, traffic_bytes: int) -> float:
    return flops / max(1, traffic_bytes)


def scheme1_intensity_gain(p: int) -> float:
    """Fused/naive intensity ratio ~ (p+1)/2 for operand-dominated sizes."""
    return (p + 1) / 2


def scheme1_workspace_bytes(s: GemmShape, p: int) -> int:
    """Interleaved Ahat (M, pK) + Bhat (pK, N), int8."""
    return p * s.k * (s.m + s.n)


# ---------------------------------------------------------------------------
# Decomposition-side traffic (beyond the paper's Eqs. 9/10, which only
# charge the GEMM: the split/interleave preprocessing has its own HBM
# round-trips, and at practical training sizes they dominate once the
# GEMM itself is fused — Mukunoki'25 / Uchino'25 observation).
#
# Counting convention, per operand of `elems` elements (fp32 source,
# p int8 slices): every HBM read/write of fp32 operand data or slice
# intermediates is decomposition-side; streaming the *finished* int8
# interleaved slices into the GEMM kernel is GEMM-side (the Eq. 10
# p(M+N)K term) and NOT counted — except on the prologue path, where the
# kernel's operand stream carries the raw fp32 (decomposition input), so
# that read is charged here instead.
# ---------------------------------------------------------------------------


def scheme1_decomp_xla_bytes(elems: int, p: int, uses: int = 1) -> int:
    """The split -> interleave XLA pipeline, per decomposition:

    4*elems   fp32 read for the power-of-two scale reduction
    4*elems   fp32 re-read by the truncate-subtract slicing pass
    p*elems   int8 write of the (p, M, K) slice stack
    2p*elems  interleave_k transpose: slice read + interleaved write

    ``uses`` = decompositions per step: forward, remat re-forward, and
    the backward's B^T split each pay in full (3x per layer per step).
    """
    return uses * (8 + 3 * p) * elems


def scheme1_decomp_prologue_bytes(elems: int, p: int, uses: int = 1) -> int:
    """The in-kernel prologue: 4*elems scale read + the 4*elems fp32
    operand stream the kernel decomposes in VMEM. No slice intermediates
    ever touch HBM."""
    return uses * 8 * elems


def scheme1_decomp_prepared_bytes(elems: int, p: int,
                                  preps: int = 1) -> int:
    """PreparedOperand: one prep emits forward + twin layouts from a
    single fp32 read (decompose_interleave_pair): 4*elems for the two
    fused scale reductions, 4*elems for the pass itself, 2p*elems of
    int8 slice writes. Consumption streams finished slices (GEMM-side).
    """
    return preps * (8 + 2 * p) * elems


def scheme1_decomp_reduction(p: int, uses: int = 3) -> tuple[float, float]:
    """(prologue, prepared) decomposition-byte reduction factors vs the
    XLA pipeline for one weight over ``uses`` per-step decompositions."""
    xla = scheme1_decomp_xla_bytes(1, p, uses)
    return (xla / scheme1_decomp_prologue_bytes(1, p, uses),
            xla / scheme1_decomp_prepared_bytes(1, p, 1))


# ---------------------------------------------------------------------------
# Scheme-II residue-side traffic (the scheme1 trio's counterpart).
#
# Unlike Scheme I — where the Eq. 9/10 GEMM models already charged the
# int32 output round-trips and only the *operand* decomposition needed a
# per-elems model — the Scheme-II reference pipeline round-trips residue
# intermediates on BOTH sides of the GEMM: the (p, M, K)/(p, K, N)
# balanced residue stacks on the way in, and the (p, M, N) int32
# accumulators -> modular-reduced canonical residues on the way out to
# the CRT.  The fused kernel (gpu backend) keeps all of it on-chip, so
# the honest model is per-GemmShape, not per-operand-elems:
#
#   encode, per operand elem:  4 fp32 scale read + 4 fp32 encode read
#                              + p int8 residue write          = 8 + p
#   (3M complex doubles the fp reads and adds the re-balanced sum
#    phase: 2p int8 reads + p writes                           = 16 + 5p)
#   output side, per MN elem:  int32 accumulator write + read by the
#                              modular reduce (8p) + canonical residue
#                              write + read by the CRT (8p)    = 16p
#   (3M: three int32 accumulator round-trips per modulus (24p, the
#    Eq. 17 term) + two canonical residue round-trips (16p)    = 40p)
#
# Streaming the finished residues into the GEMM is GEMM-side (the
# Eq. 14/15 (M+N)K term) and NOT counted — except on the prologue path,
# where the kernel's operand stream carries the raw fp32, so that read
# is charged here instead (same convention as the scheme1 trio).
# ---------------------------------------------------------------------------


def scheme2_decomp_xla_bytes(s: GemmShape, p: int, uses: int = 1,
                             complex_3m: bool = False) -> int:
    """Residue-side HBM bytes of the XLA reference Scheme-II pipeline
    (encode both operands + the int32/canonical output round-trips),
    re-paid ``uses`` times per step."""
    if complex_3m:
        operand = (16 + 5 * p) * (s.m + s.n) * s.k
        out_side = 40 * p * s.m * s.n
    else:
        operand = (8 + p) * (s.m + s.n) * s.k
        out_side = 16 * p * s.m * s.n
    return uses * (operand + out_side)


def scheme2_decomp_prologue_bytes(s: GemmShape, p: int, uses: int = 1,
                                  complex_3m: bool = False) -> int:
    """The fused residue pipeline: the scale pass and the fp32 operand
    stream are all that touches HBM — residues, accumulators, Garner
    digits and the double-double reconstruction stay on-chip."""
    del p
    mult = 2 if complex_3m else 1
    return uses * 8 * mult * (s.m + s.n) * s.k


def scheme2_decomp_prepared_bytes(s: GemmShape, p: int, uses: int = 1,
                                  preps: int = 1,
                                  complex_3m: bool = False) -> int:
    """PreparedResidues: the rhs is encoded ``preps`` times (scale read
    + encode read + p int8 residue writes) and every use streams the
    finished stack (GEMM-side); the lhs still runs the fused prologue
    per use.  The complex model is analytic only — the prepared path is
    real-valued."""
    enc = (16 + 5 * p) if complex_3m else (8 + p)
    lhs_stream = 16 if complex_3m else 8
    return preps * enc * s.k * s.n + uses * lhs_stream * s.m * s.k


def scheme2_decomp_reduction(s: GemmShape, p: int,
                             uses: int = 3) -> tuple[float, float]:
    """(fused, prepared) residue-side byte reduction factors vs the XLA
    reference for one GEMM over ``uses`` per-step encodes."""
    xla = scheme2_decomp_xla_bytes(s, p, uses)
    return (xla / scheme2_decomp_prologue_bytes(s, p, uses),
            xla / scheme2_decomp_prepared_bytes(s, p, uses, 1))


# ---------------------------------------------------------------------------
# Decode-step traffic (serving; repro.serving, docs/serving.md).
#
# A decode step is a batch of B single-token rows against a full
# projection weight: x (B, K) @ W (K, N).  The weight stream dominates
# and is batch-invariant — it is paid once per *step*, not once per
# token — so the per-token cost is the step cost divided by B.  That
# quotient is the analytic case for continuous batching: a scheduler
# that keeps the decode lanes full divides the (huge) weight term by
# the lane count, while a lockstep engine draining a ragged batch pays
# it over however few lanes are still live.
#
# Weight-side bytes per step, by decomposition path (p int8 slices):
#
#   prepared  p*K*N        finished slice stack streamed from the
#                          PreparedOperand cache (decomposed once per
#                          session by engine.prepare_params)
#   prologue  8*K*N        raw fp32 weight stream + scale read,
#                          re-decomposed in VMEM every step
#   xla       (8+4p)*K*N   split -> interleave round-trips (the
#                          scheme1_decomp_xla_bytes model) plus the
#                          finished-slice GEMM stream
#
# The activation side always runs the in-kernel prologue on the fresh
# tokens (8*B*K: scale read + fp32 stream — activations change every
# step, so preparing them buys nothing), and the logits row write adds
# out_bytes*B*N.
# ---------------------------------------------------------------------------

_DECODE_WEIGHT_PATHS = ("prepared", "prologue", "xla")


def scheme1_decode_step_bytes(k: int, n: int, batch: int, p: int,
                              path: str = "prepared",
                              out_bytes: int = 4) -> int:
    """HBM bytes of one decode-step GEMM x(B, K) @ W(K, N)."""
    if path not in _DECODE_WEIGHT_PATHS:
        raise ValueError(f"unknown decode weight path {path!r}")
    weight = {"prepared": p * k * n,
              "prologue": 8 * k * n,
              "xla": (8 + 4 * p) * k * n}[path]
    return weight + 8 * batch * k + out_bytes * batch * n


def scheme1_decode_per_token_bytes(k: int, n: int, batch: int, p: int,
                                   path: str = "prepared",
                                   out_bytes: int = 4) -> float:
    """Per-token share of one decode step's bytes at batch ``batch``."""
    return scheme1_decode_step_bytes(k, n, batch, p, path, out_bytes) / batch


def decode_batch_amortization(k: int, n: int, p: int, batch: int,
                              path: str = "prepared") -> float:
    """Per-token byte reduction of decoding at ``batch`` vs batch 1 —
    the weight-stream amortization a full continuous-batching step
    realizes over a lockstep engine's last straggler lane."""
    return (scheme1_decode_per_token_bytes(k, n, 1, p, path)
            / scheme1_decode_per_token_bytes(k, n, batch, p, path))


# ---------------------------------------------------------------------------
# Strided-batched contractions (dispatch.emulated_matmul_batched).
#
# A stack of B same-shape GEMMs can run two ways:
#
#   fused  — ONE pallas_call over a (B, bM, bN) grid with strided operand
#            indexing (gpu backend, BackendCapabilities.batched): every
#            batch element decomposes in the kernel prologue, so the
#            decomposition side is B x the prologue model (raw fp32
#            stream + scale read; slice intermediates never touch HBM),
#   vmap   — the fallback lifts a batch axis over the 2-D call; on the
#            route it actually takes (the XLA expansion — the fused 2-D
#            kernel cannot carry a vmap axis) every element re-pays the
#            full slice/residue round-trip pipeline, and the stack costs
#            B kernel launches.
#
# The GEMM-side stream (Eq. 10/15 operand + output terms) is identical
# per element on both routes, so the modeled win is launch count (B -> 1)
# plus the decomposition-byte ratio — (8+3p)/8 per operand elem for
# Scheme I (2.1x at p=3, 3.25x at p=6), and for Scheme II the output-side
# int32/canonical round-trips (16p*MN) on top of (8+p)/8 per operand
# elem.  benchmarks/bench_traffic.py gates both ratios per batched cell.
# ---------------------------------------------------------------------------


def _batched_paths(gemm_per_elem: int, fused_decomp: int, vmap_decomp: int,
                   batch: int) -> dict:
    gemm = batch * gemm_per_elem
    return {
        "fused": {"launches": 1,
                  "decomp_bytes": int(fused_decomp),
                  "gemm_bytes": int(gemm),
                  "total_bytes": int(fused_decomp + gemm)},
        "vmap": {"launches": int(batch),
                 "decomp_bytes": int(vmap_decomp),
                 "gemm_bytes": int(gemm),
                 "total_bytes": int(vmap_decomp + gemm)},
    }


def scheme1_batched_bytes(s: GemmShape, p: int, batch: int,
                          out_bytes: int = 4) -> dict:
    """Modeled HBM bytes + launch counts of a B-stack of Scheme-I GEMMs,
    fused strided-batched vs the vmapped 2-D fallback.  Returns
    ``{"fused": {launches, decomp_bytes, gemm_bytes, total_bytes},
    "vmap": {...}}``."""
    elems = (s.m + s.n) * s.k
    return _batched_paths(
        scheme1_fused_bytes(s, p, out_bytes),
        batch * scheme1_decomp_prologue_bytes(elems, p),
        batch * scheme1_decomp_xla_bytes(elems, p),
        batch)


def scheme2_batched_bytes(s: GemmShape, p: int, batch: int,
                          out_bytes: int = 4) -> dict:
    """Scheme-II analogue of :func:`scheme1_batched_bytes` (``p`` counts
    moduli); the vmap route re-pays the residue encode AND the int32 /
    canonical-residue output round-trips per batch element."""
    return _batched_paths(
        p * scheme2_fused_bytes_per_modulus(s) + out_bytes * s.m * s.n,
        batch * scheme2_decomp_prologue_bytes(s, p),
        batch * scheme2_decomp_xla_bytes(s, p),
        batch)


def batched_decomp_reduction(s: GemmShape, p: int, batch: int,
                             scheme: str = "ozaki1") -> float:
    """vmap/fused decomposition-byte ratio of one batched stack."""
    fn = scheme1_batched_bytes if scheme == "ozaki1" else scheme2_batched_bytes
    d = fn(s, p, batch)
    return d["vmap"]["decomp_bytes"] / max(1, d["fused"]["decomp_bytes"])


# ---------------------------------------------------------------------------
# Per-backend hardware peak tables.
#
# The paper's headline numbers are fractions of INT8 Tensor Core peak on
# NVIDIA Hopper (H100) and Blackwell (B200) — up to 83% and 81%
# respectively — so projected-throughput reporting needs those peaks per
# kernel backend. Keys mirror the backends' capability ``peak_key``
# ('gpu' for both of the port's); the 'cuda' and 'torch' backend names
# resolve to the same table, since both run on the card. The table has
# no TPU entry, and an unknown backend raises instead of falling back to
# one (ROADMAP.md § 3).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwarePeak:
    """Dense (non-sparsity) peaks of one accelerator.

    ``fp64_flops`` is the native FP64 rate the D/ZGEMM baselines run at
    (tensor-core FP64 on NVIDIA; 0 for accelerators without FP64 units,
    which suppresses the baseline-speedup report).
    """
    name: str
    int8_ops: float      # int8 MAC-pair ops/s (Top/s * 1e12)
    flops: float         # dense fp16/bf16 FLOP/s
    hbm_bw: float        # bytes/s
    fp64_flops: float = 0.0


BACKEND_PEAKS: dict[str, dict[str, HardwarePeak]] = {
    "gpu": {
        "h100": HardwarePeak("H100 SXM (Hopper)", 1979e12, 989e12, 3350e9,
                             fp64_flops=67e12),
        "b200": HardwarePeak("B200 (Blackwell)", 4500e12, 2250e12, 8000e9,
                             fp64_flops=40e12),
    },
}
BACKEND_PEAKS["cuda"] = BACKEND_PEAKS["torch"] = BACKEND_PEAKS["gpu"]


def backend_peaks(backend: str) -> dict[str, HardwarePeak]:
    """Peak table for a backend name ('gpu-h100'-style names resolve by
    family prefix); an unknown backend raises."""
    found = (BACKEND_PEAKS.get(backend)
             or BACKEND_PEAKS.get(backend.split("-")[0]))
    if found is None:
        raise KeyError(f"no peak table for backend {backend!r}; known: "
                       f"{sorted(BACKEND_PEAKS)}")
    return found


# ---------------------------------------------------------------------------
# Collective traffic of the shard_map'ed fused GEMM (repro.parallel
# .shard_gemm).  The per-shard kernel keeps its decomposition traffic
# on-chip exactly like the single-device numbers above; what the mesh
# adds is interconnect bytes, and those depend only on the partitioning:
#
#   column (N on 'model')  — collective-free: each shard owns whole
#                            output columns and the full K,
#   row (K on 'model')     — one psum of the (M, N) partial products,
#                            modeled as a ring all-reduce,
#   batch (data axes only) — collective-free for the GEMM itself.
#
# Ring cost convention (the standard bound): an all-reduce moves
# 2(n-1)/n * payload per device, all-gather / reduce-scatter (n-1)/n.
# ---------------------------------------------------------------------------


def ring_all_reduce_bytes(payload_bytes: int, n_dev: int) -> int:
    """Per-device interconnect bytes of a ring all-reduce."""
    if n_dev <= 1:
        return 0
    return int(2 * (n_dev - 1) * payload_bytes // n_dev)


def all_gather_bytes(payload_bytes: int, n_dev: int) -> int:
    """Per-device interconnect bytes of a ring all-gather of a tensor
    whose *global* size is ``payload_bytes``."""
    if n_dev <= 1:
        return 0
    return int((n_dev - 1) * payload_bytes // n_dev)


reduce_scatter_bytes = all_gather_bytes  # same ring volume, one phase


def _mesh_axis_sizes(mesh_shape) -> dict:
    """{axis: size} of a mapping or of ``((axis, size), ...)`` pairs; the
    arithmetic needs no mesh object."""
    if mesh_shape is None:
        return {}
    if hasattr(mesh_shape, "items"):
        return {str(a): int(sz) for a, sz in mesh_shape.items()}
    return {str(a): int(sz) for a, sz in mesh_shape}


def sharded_gemm_traffic(s: GemmShape, p: int, mesh_shape,
                         partition: str = "column",
                         scheme: str = "ozaki1", out_bytes: int = 4,
                         complex_3m: bool = False) -> dict:
    """Per-shard fused HBM bytes + per-device collective bytes of one
    shard_map'ed emulated (M, K) @ (K, N) on a mesh.

    ``mesh_shape`` is a mesh's axis sizes (a mapping or ``((axis, size),
    ...)`` tuples, ``kernels.dispatch._mesh_shape_tuple`` of a mesh);
    ``partition`` is one of the reference's ``GemmPartition`` kinds
    ('column' | 'row' | 'batch').  The fused bytes
    are the paper's Eq. 10/15/18 models evaluated on the *shard-local*
    shape; collective bytes follow the ring conventions above.
    """
    axes = _mesh_axis_sizes(mesh_shape)
    dp = axes.get("pod", 1) * axes.get("data", 1)
    tp = axes.get("model", 1)
    m_l, n_l, k_l = s.m, s.n, s.k
    if dp > 1 and s.m % dp == 0:
        m_l = s.m // dp
    coll = 0
    if partition == "column":
        if tp > 1 and s.n % tp:
            raise ValueError(f"N={s.n} does not divide model={tp}")
        n_l = s.n // tp if tp > 1 else s.n
    elif partition == "row":
        if tp > 1 and s.k % tp:
            raise ValueError(f"K={s.k} does not divide model={tp}")
        k_l = s.k // tp if tp > 1 else s.k
        n_out = 2 if complex_3m else 1
        coll = ring_all_reduce_bytes(n_out * out_bytes * m_l * n_l, tp)
    elif partition != "batch":
        raise ValueError(f"unknown partition {partition!r}")
    local = GemmShape(m_l, n_l, k_l)
    if scheme == "ozaki1":
        fused = scheme1_fused_bytes(local, p, out_bytes)
        flops = scheme1_flops(local, p)
    elif scheme == "ozaki2":
        per_mod = (scheme2_3m_fused_bytes_per_modulus(local) if complex_3m
                   else scheme2_fused_bytes_per_modulus(local))
        n_out = 2 if complex_3m else 1
        fused = p * per_mod + n_out * out_bytes * local.m * local.n
        flops = scheme2_flops(local, p, complex_3m=complex_3m)
    else:
        raise ValueError(f"no sharded traffic model for scheme {scheme!r}")
    return {
        "partition": partition,
        "shard_m": m_l, "shard_n": n_l, "shard_k": k_l,
        "devices": dp * tp,
        "fused_bytes_per_shard": int(fused),
        "int8_flops_per_shard": int(flops),
        "collective_bytes_per_device": int(coll),
    }


# ---------------------------------------------------------------------------
# Guard verification traffic (docs/robustness.md cost model).
#
# The a posteriori verifier (repro.guard.verify.verify_gemm) checks
# C @ x against A @ (B @ x) for r Rademacher probe vectors — three GEMVs
# (well, skinny (., r) GEMMs) against matrices the guarded GEMM already
# owns.  Two accounting conventions:
#
#   fused    — the probes piggyback on the GEMM's own operand streams
#              (A, B and C are charged to the GEMM, not the verifier);
#              only the probe-sized vectors round-trip:
#                2Nr  x read by B@x and by C@x,
#                2Kr  Bx written + re-read by A@(Bx),
#                 Mr  Cx written once; the compare runs in the A@(Bx)
#                     epilogue, so A(Bx) never leaves chip.
#              total = 4r (M + 2K + 2N) bytes.  This is the model the
#              benchmark gates at <= 5% of the fused GEMM bytes.
#   unfused  — the XLA reference path re-reads everything: B, A and C
#              once per GEMV, plus the row/col abs-reductions of the
#              error normalizer re-reading A and B.  Reported alongside,
#              not gated (it is the price of verifying a kernel you
#              cannot touch).
# ---------------------------------------------------------------------------


def guard_verify_bytes_fused(s: GemmShape, probes: int = 2) -> int:
    return 4 * probes * (s.m + 2 * s.k + 2 * s.n)


def guard_verify_bytes_unfused(s: GemmShape, probes: int = 2,
                               out_bytes: int = 4) -> int:
    gemv_reads = 4 * (s.m * s.k + s.k * s.n) + out_bytes * s.m * s.n
    vectors = 4 * probes * (3 * s.m + 2 * s.k + 2 * s.n)
    normalizer = 4 * (s.m * s.k + s.k * s.n)
    return gemv_reads + vectors + normalizer


def guard_verify_flops(s: GemmShape, probes: int = 2) -> int:
    """MAC-pair ops of the three probe GEMVs (the O(MK + KN) normalizer
    reductions are add-only and amortize across seeds; not counted)."""
    return 2 * probes * (s.k * s.n + s.m * s.k + s.m * s.n)


def guard_overhead_model(s: GemmShape, p: int, scheme: str = "ozaki1",
                         probes: int = 2, out_bytes: int = 4,
                         peak: "HardwarePeak | None" = None) -> dict:
    """Modeled verification overhead of one guarded fused GEMM.

    Roofline convention: GEMM time = max(fused bytes / HBM BW,
    int8 flops / int8 peak); verify time = max(fused verify bytes /
    HBM BW, verify flops / fp peak) — the probes are fp32 math.  The
    returned ``time_ratio`` uses the given ``peak`` (default: the H100,
    the card the port runs on; the reference's default is a TPU).
    """
    if peak is None:
        peak = BACKEND_PEAKS["gpu"]["h100"]
    if scheme == "ozaki1":
        gemm_bytes = scheme1_fused_bytes(s, p, out_bytes)
        gemm_flops = scheme1_flops(s, p)
    elif scheme == "ozaki2":
        gemm_bytes = (p * scheme2_fused_bytes_per_modulus(s)
                      + out_bytes * s.m * s.n)
        gemm_flops = scheme2_flops(s, p)
    else:
        raise ValueError(f"no guard overhead model for scheme {scheme!r}")
    v_bytes = guard_verify_bytes_fused(s, probes)
    v_flops = guard_verify_flops(s, probes)
    t_gemm = max(gemm_bytes / peak.hbm_bw, gemm_flops / peak.int8_ops)
    t_verify = max(v_bytes / peak.hbm_bw, v_flops / peak.flops)
    return {
        "gemm_bytes": int(gemm_bytes),
        "gemm_flops": int(gemm_flops),
        "verify_bytes_fused": int(v_bytes),
        "verify_bytes_unfused": int(
            guard_verify_bytes_unfused(s, probes, out_bytes)),
        "verify_flops": int(v_flops),
        "bytes_ratio": v_bytes / max(1, gemm_bytes),
        "time_ratio": t_verify / t_gemm,
    }


def telemetry_counter_bytes(counters: int = 4,
                            labels: int = 6,
                            label_bytes: int = 16) -> int:
    """Device->host payload of one instrumented GEMM's execution-time
    telemetry callbacks: a handful of scalar counter bumps plus their
    (statically captured, but transferred once per flush) label strings.

    ``counters`` scalars at 8 bytes each, ``labels`` key/value pairs at
    ``label_bytes`` each — tens of bytes, NOT proportional to the GEMM.
    """
    return 8 * counters + labels * 2 * label_bytes


def telemetry_overhead_model(s: GemmShape, p: int, scheme: str = "ozaki1",
                             out_bytes: int = 4,
                             peak: "HardwarePeak | None" = None) -> dict:
    """Modeled observability overhead of one instrumented fused GEMM
    (docs/observability.md), mirroring ``guard_overhead_model``.

    The reference's telemetry path adds (a) trace-time registry bumps —
    host-side, zero device cost, not modeled here — and (b) one device
    callback per executed GEMM whose device-side cost is the transfer of
    its payload (``telemetry_counter_bytes``) over HBM/PCIe. The port
    records on the host, eagerly; the model is kept as the reference's.  Roofline
    convention as in the guard model: GEMM time = max(fused bytes /
    HBM BW, int8 flops / int8 peak); telemetry time = payload bytes /
    HBM BW; ``peak`` defaults to the H100, as in
    :func:`guard_overhead_model`.
    """
    if peak is None:
        peak = BACKEND_PEAKS["gpu"]["h100"]
    if scheme == "ozaki1":
        gemm_bytes = scheme1_fused_bytes(s, p, out_bytes)
        gemm_flops = scheme1_flops(s, p)
    elif scheme == "ozaki2":
        gemm_bytes = (p * scheme2_fused_bytes_per_modulus(s)
                      + out_bytes * s.m * s.n)
        gemm_flops = scheme2_flops(s, p)
    else:
        raise ValueError(
            f"no telemetry overhead model for scheme {scheme!r}")
    t_bytes = telemetry_counter_bytes()
    t_gemm = max(gemm_bytes / peak.hbm_bw, gemm_flops / peak.int8_ops)
    t_tele = t_bytes / peak.hbm_bw
    return {
        "gemm_bytes": int(gemm_bytes),
        "gemm_flops": int(gemm_flops),
        "telemetry_bytes": int(t_bytes),
        "bytes_ratio": t_bytes / max(1, gemm_bytes),
        "time_ratio": t_tele / t_gemm,
    }


def scheme2_workspace_bytes(s: GemmShape, p: int,
                            complex_inputs: bool = False) -> int:
    """p residue matrices per operand + p per-modulus output residues
    (paper Sec. V-F: Scheme II workspace exceeds Scheme I at matched p)."""
    operand_ws = p * s.k * (s.m + s.n) * (2 if complex_inputs else 1)
    out_res = p * s.m * s.n * (2 if complex_inputs else 1)
    return operand_ws + out_res
