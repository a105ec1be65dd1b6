"""Roofline terms of the port's steps (``repro.utils.roofline``).

The reference walks a compiled program's HLO (``parse_hlo`` /
``analyze_hlo``) because ``cost_analysis`` counts a scanned loop's body
once. The port runs eagerly, so :func:`analyze_step` counts one real step
instead: every aten op it dispatches, loops included as they run (no
trip-count correction is needed), plus the work of the hand-written
kernels, which are called through ``ctypes`` and so are invisible to a
dispatch mode.

Hardware model: one NVIDIA H100 SXM (``core.traffic.BACKEND_PEAKS["gpu"]
["h100"]``: 989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s HBM3; NVIDIA's
data sheet, dense rates at 700 W) and NVLink 4 between cards, 450 GB/s
each way (the same data sheet's 900 GB/s per card, both ways).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import traffic as T

_H100 = T.BACKEND_PEAKS["gpu"]["h100"]
PEAK_FLOPS = _H100.flops           # bf16 tensor cores
PEAK_INT8_OPS = _H100.int8_ops     # int8 tensor cores
HBM_BW = _H100.hbm_bw              # bytes/s
NVLINK_BW = 450e9                  # bytes/s, one direction, per card


# ---------------------------------------------------------------------------
# One eager step, counted.
# ---------------------------------------------------------------------------

def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(x) for x in tree.values())
    return 0


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(x) for x in tree)
    if isinstance(tree, dict):
        return any(_on_cuda(x) for x in tree.values())
    return False


def _boundary_mode():
    """A dispatch mode that sums op-boundary bytes: result plus operand
    bytes of every op that is not a view."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class BoundaryBytes(TorchDispatchMode):
        mem_bytes = 0
        cuda = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not func.is_view:
                self.mem_bytes += (_tensor_bytes(out) + _tensor_bytes(args)
                                   + _tensor_bytes(kwargs))
                self.cuda = self.cuda or _on_cuda(out)
            return out

    return BoundaryBytes()


def gemm_work(call: dict) -> tuple[int, int]:
    """(int8 ops, modeled bytes) of one emulated GEMM as telemetry records
    it (``telemetry.record.OBSERVERS``): the int8 GEMMs of
    ``scheme1_flops`` (four of them for a complex 4M product) or
    ``scheme2_flops``, times the batch; the modeled bytes are telemetry's
    own (Eq. 10 / 15 / 18)."""
    s = T.GemmShape(call["m"], call["n"], call["k"])
    scheme = call["scheme"]
    if scheme.startswith("ozaki2"):
        ops = T.scheme2_flops(s, call["count"],
                              complex_3m=scheme == "ozaki2-3m")
    else:
        ops = (4 if scheme.endswith("-4m") else 1) * T.scheme1_flops(
            s, call["count"])
    return ops * (call["batch"] or 1), call["modeled_bytes"]


def attention_work(call: dict) -> tuple[int, int]:
    """(flops, bytes) of one fused-attention launch
    (``kernels.flash_attn.OBSERVERS``): 4 B H Sq Sk D, halved when causal,
    and q, k, v and o each moved once."""
    flops = 4 * call["b"] * call["h"] * call["sq"] * call["sk"] * call["d"]
    if call["causal"]:
        flops //= 2
    size = torch.empty((), dtype=call["dtype"]).element_size()
    moved = size * call["d"] * (2 * call["b"] * call["h"] * call["sq"]
                                + 2 * call["b"] * call["kvh"] * call["sk"])
    return flops, moved


def analyze_step(fn, *args, **kwargs) -> dict:
    """Per-device {flops, mem_bytes, coll_bytes} of one eager call of
    ``fn(*args, **kwargs)``, the counterpart of :func:`analyze_hlo` on the
    reference's compiled HLO.

    * flops: aten matmul-like ops by ``torch.utils.flop_counter``'s
      formulas (2 M N K a product, as the HLO walk counts a dot);
    * mem_bytes: op-boundary bytes, result plus operand bytes of every
      op that is not a view (the reference's proxy; in eager mode every
      op is a boundary);
    * coll_bytes: this rank's modeled collective bytes of the step's
      partitioned GEMMs on a mesh (telemetry's
      ``MODELED_COLLECTIVE_BYTES``: the row partitions' sums and the
      column gathers); 0 on one device.

    The hand-written kernels launched on a card are added from their own
    models: each emulated GEMM's int8 ops and telemetry's modeled bytes
    (telemetry is on for the step), each fused attention's flops and its
    q, k, v and o bytes. On the CPU the wrappers run their plain
    versions, whose aten ops the mode already sees, so nothing is added.
    The step runs once, for real: loops count as they run.
    """
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import telemetry
    from repro_torch.kernels import flash_attn
    from repro_torch.telemetry import record

    gemms, attns = [], []
    record.OBSERVERS.append(gemms.append)
    flash_attn.OBSERVERS.append(attns.append)
    boundary = _boundary_mode()
    try:
        with telemetry.recording() as reg, \
                FlopCounterMode(display=False) as fc, boundary:
            coll0 = reg.total(record.MODELED_COLLECTIVE_BYTES)
            fn(*args, **kwargs)
            coll = reg.total(record.MODELED_COLLECTIVE_BYTES) - coll0
    finally:
        record.OBSERVERS.remove(gemms.append)
        flash_attn.OBSERVERS.remove(attns.append)
    flops, mem = float(fc.get_total_flops()), float(boundary.mem_bytes)
    if boundary.cuda:
        for ops, moved in ([gemm_work(c) for c in gemms]
                           + [attention_work(c) for c in attns]):
            flops += ops
            mem += moved
    return {"flops": flops, "mem_bytes": mem, "coll_bytes": float(coll)}


def roofline_terms(per_device_flops: float, per_device_mem_bytes: float,
                   per_device_coll_bytes: float) -> dict:
    """The three §Roofline terms, in seconds (per step)."""
    t_compute = per_device_flops / PEAK_FLOPS
    t_memory = per_device_mem_bytes / HBM_BW
    t_coll = per_device_coll_bytes / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(t_compute, t_memory, t_coll)
    terms["roofline_fraction_compute"] = t_compute / total if total else 0.0
    return terms


def projected_throughput(m: int, k: int, n: int, p: int,
                         scheme: str = "ozaki1", backend: str = "gpu",
                         out_bytes: int = 4,
                         complex_3m: bool = False) -> dict:
    """Roofline-projected Top/s of one fused emulated GEMM, per hardware
    peak of the selected kernel backend (paper Fig. 4/5 framing: fraction
    of INT8 Tensor Core peak).

    Uses the analytical fused-traffic models (Eq. 10 / Eq. 15 / Eq. 18)
    and the per-backend peak tables in ``core.traffic.BACKEND_PEAKS`` —
    the Hopper (H100) and Blackwell (B200) entries.

    On hardware with a native FP64 rate each entry also carries the
    paper's headline framing: ``baseline_speedup`` — projected fused
    time vs an FP64 BLAS baseline (``zgemm`` for ``complex_3m``, else
    ``dgemm``) of the same logical GEMM at that hardware's FP64 peak
    (the 2.3x-over-cuBLAS-ZGEMM-on-Hopper number of Sec. V).
    """
    s = T.GemmShape(m, n, k)
    if scheme == "ozaki1":
        flops = T.scheme1_flops(s, p)
        bytes_ = T.scheme1_fused_bytes(s, p, out_bytes)
    elif scheme == "ozaki2":
        flops = T.scheme2_flops(s, p, complex_3m=complex_3m)
        per_mod = (T.scheme2_3m_fused_bytes_per_modulus(s) if complex_3m
                   else T.scheme2_fused_bytes_per_modulus(s))
        n_out = 2 if complex_3m else 1
        bytes_ = p * per_mod + n_out * out_bytes * s.m * s.n
    else:
        raise ValueError(f"no projection for scheme {scheme!r}")
    # FP64 BLAS baseline of the same logical GEMM: ZGEMM does 8 real
    # flops per complex MAC over complex128 operands, DGEMM 2 over f64.
    if complex_3m:
        base_name, base_flops, elem = "zgemm", 8 * s.m * s.n * s.k, 16
    else:
        base_name, base_flops, elem = "dgemm", 2 * s.m * s.n * s.k, 8
    base_bytes = elem * ((s.m + s.n) * s.k + s.m * s.n)
    out = {"backend": backend, "scheme": scheme,
           "int8_flops": float(flops), "traffic_bytes": float(bytes_),
           "hardware": {}}
    for key, peak in T.backend_peaks(backend).items():
        t_c = flops / peak.int8_ops
        t_m = bytes_ / peak.hbm_bw
        t = max(t_c, t_m)
        cell = {
            "name": peak.name,
            "peak_int8_tops": peak.int8_ops / 1e12,
            "projected_tops": flops / t / 1e12 if t else 0.0,
            "fraction_of_peak": (flops / t) / peak.int8_ops if t else 0.0,
            "bound": "compute" if t_c >= t_m else "memory",
        }
        if peak.fp64_flops and t:
            t_base = max(base_flops / peak.fp64_flops,
                         base_bytes / peak.hbm_bw)
            cell["fp64_baseline"] = base_name
            cell["baseline_speedup"] = t_base / t
        out["hardware"][key] = cell
    return out


def batched_projected_throughput(m: int, k: int, n: int, batch: int, p: int,
                                 scheme: str = "ozaki1",
                                 backend: str = "gpu",
                                 out_bytes: int = 4) -> dict:
    """Roofline projection of one strided-batched emulated GEMM stack,
    fused single-launch vs the per-element 2-D fallback ('vmap', the
    reference's name).

    Uses the batched traffic models (``core.traffic
    .scheme{1,2}_batched_bytes``): the compute side is identical on both
    routes (B x the per-element int8 flops), so the projected columns
    differ only by the decomposition-byte term. Per hardware entry the
    cell carries ``fused_projected_tops`` / ``vmap_projected_tops`` and
    their ratio ``projected_speedup``.
    """
    s = T.GemmShape(m, n, k)
    if scheme == "ozaki1":
        model = T.scheme1_batched_bytes(s, p, batch, out_bytes)
        flops = batch * T.scheme1_flops(s, p)
    elif scheme == "ozaki2":
        model = T.scheme2_batched_bytes(s, p, batch, out_bytes)
        flops = batch * T.scheme2_flops(s, p)
    else:
        raise ValueError(f"no batched projection for scheme {scheme!r}")
    out = {"backend": backend, "scheme": scheme, "batch": int(batch),
           "int8_flops": float(flops), "paths": model, "hardware": {}}
    for key, peak in T.backend_peaks(backend).items():
        cell = {"name": peak.name}
        for path in ("fused", "vmap"):
            t = max(flops / peak.int8_ops,
                    model[path]["total_bytes"] / peak.hbm_bw)
            cell[f"{path}_projected_tops"] = flops / t / 1e12 if t else 0.0
        vm = cell["vmap_projected_tops"]
        cell["projected_speedup"] = (
            cell["fused_projected_tops"] / vm if vm else 0.0)
        out["hardware"][key] = cell
    return out


def sharded_projected_throughput(m: int, k: int, n: int, p: int,
                                 mesh_shape,
                                 partition: str = "column",
                                 scheme: str = "ozaki1",
                                 backend: str = "gpu", out_bytes: int = 4,
                                 complex_3m: bool = False) -> dict:
    """Roofline projection of one sharded emulated GEMM: per-shard fused
    Top/s next to the interconnect bytes the mesh adds.

    ``mesh_shape`` / ``partition`` follow ``core.traffic
    .sharded_gemm_traffic`` (axis sizes; no mesh object is needed): the
    fused-traffic models are evaluated on the shard-local (m, n, k) and
    the collective cost (zero for the column/batch layouts, a ring
    all-reduce of the output partials for row) is reported beside it in
    bytes and in seconds at ``NVLINK_BW``. Each hardware entry carries the
    per-shard projection plus an ``effective_tops`` that charges the
    collective time against the shard's useful int8 flops.
    """
    cell = T.sharded_gemm_traffic(
        T.GemmShape(m, n, k), p, mesh_shape, partition,
        scheme=scheme, out_bytes=out_bytes, complex_3m=complex_3m)
    shard = projected_throughput(
        cell["shard_m"], cell["shard_k"], cell["shard_n"], p,
        scheme=scheme, backend=backend, out_bytes=out_bytes,
        complex_3m=complex_3m)
    coll_bytes = cell["collective_bytes_per_device"]
    coll_s = coll_bytes / NVLINK_BW
    out = {
        "backend": backend, "scheme": scheme, "partition": partition,
        "devices": cell["devices"],
        "shard_shape": (cell["shard_m"], cell["shard_k"], cell["shard_n"]),
        "fused_bytes_per_shard": cell["fused_bytes_per_shard"],
        "int8_flops_per_shard": cell["int8_flops_per_shard"],
        "collective_bytes_per_device": coll_bytes,
        "collective_s": coll_s,
        "hardware": {},
    }
    flops = cell["int8_flops_per_shard"]
    for key, hw in shard["hardware"].items():
        t_shard = flops / hw["projected_tops"] / 1e12 \
            if hw["projected_tops"] else 0.0
        t_total = t_shard + coll_s
        out["hardware"][key] = {
            "name": hw["name"],
            "peak_int8_tops": hw["peak_int8_tops"],
            "shard_projected_tops": hw["projected_tops"],
            "effective_tops": flops / t_total / 1e12 if t_total else 0.0,
            "bound": ("collective" if coll_s > t_shard else hw["bound"]),
        }
    return out


def scheme1_decomposition_terms(m: int, k: int, n: int, p: int,
                                uses: int = 3) -> dict:
    """Decomposition-side HBM bytes (and seconds at HBM_BW) for one
    emulated (M, K) @ (K, N) weight GEMM per training step, under the
    three Scheme-I data paths (``core.traffic`` counting):

      xla      — split -> interleave -> kernel, re-decomposed ``uses``
                 times (forward, remat re-forward, backward B^T),
      prologue — in-kernel slicing, only the scale pass and the fp32
                 operand stream touch HBM,
      prepared — one dual-layout prep per step, reused by every use.

    Both operands count for xla/prologue (each call decomposes lhs and
    rhs); 'prepared' preps only the rhs — its lhs (the activation) still
    runs the prologue.
    """
    lhs, rhs = m * k, k * n
    out = {}
    out["xla_bytes"] = T.scheme1_decomp_xla_bytes(lhs + rhs, p, uses)
    out["prologue_bytes"] = T.scheme1_decomp_prologue_bytes(lhs + rhs, p,
                                                            uses)
    out["prepared_bytes"] = (T.scheme1_decomp_prologue_bytes(lhs, p, uses)
                             + T.scheme1_decomp_prepared_bytes(rhs, p, 1))
    for key in ("xla", "prologue", "prepared"):
        out[f"{key}_s"] = out[f"{key}_bytes"] / HBM_BW
    return out


def scheme2_decomposition_terms(m: int, k: int, n: int, p: int,
                                uses: int = 3,
                                complex_3m: bool = False) -> dict:
    """Residue-side HBM bytes (and seconds at HBM_BW) for one emulated
    Scheme-II (M, K) @ (K, N) GEMM per training step, under the three
    residue data paths (``core.traffic`` counting):

      xla      — encode both operands + round-trip the (p, M, N) int32
                 accumulators and canonical residues through HBM into
                 the CRT, re-paid ``uses`` times,
      fused    — the fused residue pipeline: only the scale pass and the
                 fp32 operand stream touch HBM,
      prepared — one rhs residue encode per step (PreparedResidues),
                 reused by every use; the lhs still runs the prologue.
    """
    s = T.GemmShape(m, n, k)
    out = {
        "xla_bytes": T.scheme2_decomp_xla_bytes(s, p, uses, complex_3m),
        "prologue_bytes": T.scheme2_decomp_prologue_bytes(
            s, p, uses, complex_3m),
        "prepared_bytes": T.scheme2_decomp_prepared_bytes(
            s, p, uses, 1, complex_3m),
    }
    for key in ("xla", "prologue", "prepared"):
        out[f"{key}_s"] = out[f"{key}_bytes"] / HBM_BW
    return out


# ---------------------------------------------------------------------------
# Analytic model FLOPs (6ND / 6 N_active D), for the 'useful compute' ratio.
# ---------------------------------------------------------------------------

def model_flops(arch, shape, params_total: int, params_routed: int) -> float:
    """MODEL_FLOPS for one step of this (arch, shape) cell, global."""
    m = arch.model
    active = params_total - params_routed
    if m.moe is not None:
        per_expert = params_routed // max(1, _n_routed(arch))
        active += per_expert * m.moe.top_k * m.n_layers
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


def _n_routed(arch) -> int:
    from repro_torch.models.moe import padded_experts
    return padded_experts(arch.model.moe) * arch.model.n_layers


def routed_param_count(params) -> int:
    """Total parameters in routed-expert tensors (3-D leaves under 'moe')."""
    from repro_torch.utils.tree import tree_flatten
    return sum(math.prod(leaf.shape)
               for path, leaf in tree_flatten(params).items()
               if "moe" in path.split("/") and leaf.dim() >= 3)
