"""Profiling aid: one real step of an (arch, shape) cell on the card, its
device time attributed to kernels and to emulated-GEMM sites.

  PYTHONPATH=src python -m repro_torch.utils.perf_probe --arch olmo-1b \\
      --shape decode_32k --gemm ozaki1-p4 --batch 4 --by-emulation-site

The reference (``repro.utils.perf_probe``) compiles a dry-run cell against
a production mesh and attributes HLO bytes to op-name scopes. The port
runs eagerly on one card, so it runs the cell's step for real, once to
warm up and once under ``torch.profiler``, and attributes device time:

* :func:`attribute` — device ms by (kernel name, normalized scope), the
  scope being the innermost ``record_function`` range around the
  kernel's launch (an ``emugemm/<scheme>/<backend>/<impl>`` tag,
  ``telemetry.gemm_scope``), else the aten op that launched it;
* :func:`attribute_emulation` — per emulation tag and call site: calls,
  telemetry's modeled GB, device ms of everything launched inside the
  tag's ranges, and that time's share of the bound, the least time the
  card could take for the same GEMMs: max(int8 ops / int8 peak, bytes /
  HBM bandwidth), the float operands read once and the output written
  once, so that the bound reads the same work whatever kernel runs it.

Every run also prints the cell's model FLOPs (``roofline.model_flops``)
and ``mfu`` = model FLOPs / (step wall x the bf16 peak).

One card, so two flags the reference has no need of: ``--batch`` (the
step's global batch, default 1) and ``--layers`` (default: full depth).
``--device cpu`` runs the step on the CPU, ``--smoke`` takes the arch's
smoke config and ``--seq`` cuts the sequence, for the tests (the profiler
then sees no device kernels). Importing the module does nothing: no
environment is set and CUDA is not touched until :func:`main` runs.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import time

import torch

# Telemetry scope tags carry load-bearing digits (emugemm/ozaki1-p4/...):
# the generic digit-stripping normalization below must not turn them into
# the ambiguous "emugemm/ozaki-p/...".
_EMUTAG_RE = re.compile(r"emugemm/[^/\s\"(),]+/[^/\s\"(),]+/[^/\s\"(),]+")

# The hand-written emulation kernels (csrc/), by the names a trace gives
# them; flash attention (K10) is not an emulated GEMM.
EMU_KERNELS = ("emugemm1_", "decompose_kernel", "relayout_lhs_kernel",
               "relayout_rhs_kernel", "encode_kernel", "planes_kernel",
               "relayout_kernel", "residues_kernel")


def normalize_tag(tag):
    """Collapse shape suffixes / layer indices so per-layer duplicates
    fold into one row, while preserving the digits inside emugemm scope
    tags (p-count, moduli count — `ozaki1-p4` vs `ozaki1-p3` are
    different kernels, not different layers)."""
    m = _EMUTAG_RE.search(tag)
    strip = lambda s: re.sub(r"\[[^\]]*\]|\d+", "", s)
    if m is None:
        return strip(tag)[:110]
    return (strip(tag[:m.start()]) + m.group(0)
            + strip(tag[m.end():]))[:110]


def is_emulation_kernel(name: str) -> bool:
    return any(k in name for k in EMU_KERNELS)


# ---------------------------------------------------------------------------
# The cell.
# ---------------------------------------------------------------------------

def cell(arch_id: str, shape_name: str, batch: int = 1,
         layers: int | None = None, smoke: bool = False,
         seq: int | None = None):
    """(arch, shape) of a cell, its global batch set to ``batch``, its
    depth cut to ``layers`` and its sequence to ``seq`` (None: as
    published); a train step whose microbatches do not divide the batch
    runs as one. ``smoke`` takes the arch's smoke config."""
    from repro_torch import configs
    arch = (configs.get_smoke_config if smoke else configs.get_config)(
        arch_id)
    shape = next((s for s in arch.shapes() if s.name == shape_name), None)
    if shape is None:
        raise ValueError(f"{arch_id} has no shape {shape_name!r}; it has "
                         f"{[s.name for s in arch.shapes()]}")
    shape = dataclasses.replace(shape, global_batch=batch,
                                seq_len=seq or shape.seq_len)
    if layers is not None:
        arch = dataclasses.replace(
            arch, model=dataclasses.replace(arch.model, n_layers=layers))
    if batch % arch.train.microbatches:
        arch = dataclasses.replace(
            arch, train=dataclasses.replace(arch.train, microbatches=1))
    return arch, shape


def build_step(arch, shape, policy, device, seed: int = 0):
    """A callable that runs one step of the cell on seeded random weights
    and tokens: a train step (its new state replaces the old), a prefill
    of the whole sequence, or one decode step at the last position of a
    full cache."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    mcfg = arch.model
    gen = torch.Generator().manual_seed(seed)
    b, s = shape.global_batch, shape.seq_len

    def tokens(rows, cols):
        return torch.randint(0, mcfg.vocab, (rows, cols), generator=gen,
                             dtype=torch.int32).to(device)

    if shape.kind == "train":
        step = S.make_train_step(arch, None, shape, policy)
        state = {"st": S.init_state(arch, seed, device)}
        batch = {"tokens": tokens(b, s), "labels": tokens(b, s).long()}

        def run():
            state["st"], metrics = step(state["st"], batch)
            return metrics["loss"]
        return run
    params = M.init_params(mcfg, seed, device)
    if shape.kind == "prefill":
        step = S.make_prefill_step(arch, shape, None, policy)
        inputs = {"tokens": tokens(b, s)}
        return lambda: step(params, inputs)[0]
    step = S.make_decode_step(arch, shape, None, policy)
    cache = M.init_cache(mcfg, b, s, device)
    token = tokens(b, 1)
    return lambda: step(params, cache, token, s - 1)[0]


# ---------------------------------------------------------------------------
# Attribution.
# ---------------------------------------------------------------------------

def _duration_ms(event) -> float:
    return (event.time_range.end - event.time_range.start) / 1e3


def device_kernels(events):
    """The device kernels (and copies) of a trace, without the device
    spans the profiler draws for user annotations."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not _EMUTAG_RE.fullmatch(e.name)]


class _Ranges:
    """Time ranges (profiler events) sorted by start, for the innermost
    range that holds a time."""

    def __init__(self, ranges):
        import bisect
        import itertools
        self._bisect = bisect.bisect_right
        self.ranges = sorted(ranges, key=lambda e: e.time_range.start)
        self.starts = [e.time_range.start for e in self.ranges]
        self.max_end = list(itertools.accumulate(
            (e.time_range.end for e in self.ranges), max))

    def find(self, t):
        i = self._bisect(self.starts, t) - 1
        while i >= 0 and self.max_end[i] >= t:
            if self.ranges[i].time_range.end >= t:
                return self.ranges[i]
            i -= 1
        return None


def place_kernels(prof):
    """[(kernel event, its emugemm range or None, its launch event or
    None)] for every device kernel of a profiled step.

    The hand-written kernels are launched through ``ctypes``, outside any
    aten op, so the profiler links them to no op (a ``record_function``
    range takes part only in the device spans it draws for user
    annotations). So each kernel's runtime launch event (the same CUPTI
    correlation id) gives its launch's host time, and the innermost
    emugemm range holding that time is its range."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    launches = {e.id: e for e in events
                if e.device_type == DeviceType.CPU and "aunch" in e.name}
    ranges = _Ranges(e for e in events if e.device_type == DeviceType.CPU
                     and _EMUTAG_RE.fullmatch(e.name))
    placed = []
    for k in device_kernels(events):
        launch = launches.get(k.id)
        placed.append((k, None if launch is None
                       else ranges.find(launch.time_range.start), launch))
    return placed


def _scope(event) -> str:
    """The innermost emugemm tag around ``event`` (itself included), else
    the outermost op that is not a profiler step."""
    e, outer = event, event.name
    while e is not None:
        if _EMUTAG_RE.search(e.name):
            return e.name
        if not e.name.startswith("ProfilerStep"):
            outer = e.name
        e = e.cpu_parent
    return outer


def attribute(prof, top=20):
    """Device ms by (kernel name, normalized scope), most first: the scope
    is the kernel's emugemm range (:func:`place_kernels`), else the
    outermost op around its launch."""
    rows = collections.Counter()
    for k, rng, launch in place_kernels(prof):
        scope = (rng.name if rng is not None
                 else _scope(launch) if launch is not None else "?")
        rows[(k.name, normalize_tag(scope))] += _duration_ms(k)
    return rows.most_common(top)


def emulation_kernel_ms(prof) -> float:
    """Device ms of every hand-written emulation kernel the trace holds,
    in a tag's range or not."""
    return sum(_duration_ms(k) for k in device_kernels(list(prof.events()))
               if is_emulation_kernel(k.name))


def call_bound(call: dict, int8_ops_per_s: float,
               bytes_per_s: float) -> tuple[float, int, int]:
    """(seconds, int8 ops, bytes) of one recorded GEMM's bound: its int8
    GEMMs at the int8 peak, or its float operands read once and its output
    written once at the HBM rate, whichever is longer."""
    from repro_torch.utils.roofline import gemm_work
    ops, _ = gemm_work(call)
    batch = call["batch"] or 1
    in_bytes = call["in_bytes"] or call["out_bytes"]
    moved = batch * (in_bytes * (call["m"] * call["k"] + call["k"] * call["n"])
                     + call["out_bytes"] * call["m"] * call["n"])
    return max(ops / int8_ops_per_s, moved / bytes_per_s), ops, moved


def attribute_emulation(prof, calls):
    """Per (tag, site): calls, modeled GB, int8 ops, bound bytes, bound
    ms, device ms (all kernels launched inside the tag's ranges),
    emulation-kernel ms (the hand-written ones among them) and the share
    ``bound_ms / device_ms``.

    ``calls`` are telemetry's records of the profiled step
    (``telemetry.record.OBSERVERS``), in call order. Each call opens one
    range named by its tag, so the n-th range of a tag is its n-th call
    and carries that call's site; kernels go to ranges by
    :func:`place_kernels`. If a tag's ranges and calls do not pair up
    (the trace lost ranges), its rows take the tag's device time in
    proportion to their bounds and are marked ``paired: False``."""
    from repro_torch.core import traffic
    from torch.autograd import DeviceType
    peak = traffic.BACKEND_PEAKS["gpu"]["h100"]
    per_range = collections.defaultdict(lambda: [0.0, 0.0])
    for k, rng, _ in place_kernels(prof):
        if rng is not None:
            per_range[id(rng)][0] += _duration_ms(k)
            per_range[id(rng)][1] += _duration_ms(k) * is_emulation_kernel(
                k.name)
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and _EMUTAG_RE.fullmatch(e.name):
            ranges[e.name].append(e)
    by_tag = collections.defaultdict(list)
    for c in calls:
        by_tag[c["tag"]].append(c)
    rows = {}
    for tag in sorted(set(ranges) | set(by_tag)):
        evs = sorted(ranges.get(tag, []), key=lambda e: e.time_range.start)
        tag_calls = by_tag.get(tag, [])
        paired = len(evs) == len(tag_calls)
        timed = [tuple(per_range.get(id(e), (0.0, 0.0))) for e in evs]
        for i, c in enumerate(tag_calls):
            row = rows.setdefault((tag, c["site"]), {
                "calls": 0, "modeled_gb": 0.0, "int8_ops": 0,
                "bound_bytes": 0, "bound_ms": 0.0, "device_ms": 0.0,
                "emu_kernel_ms": 0.0, "paired": paired})
            s, ops, moved = call_bound(c, peak.int8_ops, peak.hbm_bw)
            row["calls"] += 1
            row["modeled_gb"] += c["modeled_bytes"] / 1e9
            row["int8_ops"] += ops
            row["bound_bytes"] += moved
            row["bound_ms"] += 1e3 * s
            if paired:
                row["device_ms"] += timed[i][0]
                row["emu_kernel_ms"] += timed[i][1]
        if not paired and timed:
            tag_rows = [r for (t, _), r in rows.items() if t == tag]
            total = sum(r["bound_ms"] for r in tag_rows) or 1.0
            for r in tag_rows:
                r["device_ms"] = sum(x for x, _ in timed) * r["bound_ms"] / total
                r["emu_kernel_ms"] = (sum(y for _, y in timed)
                                      * r["bound_ms"] / total)
        if not tag_calls and timed:
            rows[(tag, "-")] = {
                "calls": 0, "modeled_gb": 0.0, "int8_ops": 0,
                "bound_bytes": 0, "bound_ms": 0.0,
                "device_ms": sum(x for x, _ in timed),
                "emu_kernel_ms": sum(y for _, y in timed), "paired": False}
    for row in rows.values():
        row["share"] = (row["bound_ms"] / row["device_ms"]
                        if row["device_ms"] else None)
    return rows


# ---------------------------------------------------------------------------
# The probe.
# ---------------------------------------------------------------------------

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(arch_id: str, shape_name: str, gemm: str | None = None,
          batch: int = 1, layers: int | None = None, device="cuda",
          seed: int = 0, smoke: bool = False,
          seq: int | None = None) -> dict:
    """Run the cell's step twice (a warm-up, then one timed and one
    profiled) and return {"wall_s", "model_flops", "mfu", "prof",
    "calls", "emulation_kernel_ms", "device"}."""
    from repro_torch import api, telemetry
    from repro_torch.launch import steps as S
    from repro_torch.models.common import GemmPolicy
    from repro_torch.models.model import resolve_device
    from repro_torch.telemetry import record
    from repro_torch.utils import roofline
    from repro_torch.utils.tree import tree_leaves

    device = resolve_device(device)
    arch, shape = cell(arch_id, shape_name, batch, layers, smoke, seq)
    policy = (GemmPolicy(default=api.precision(gemm)) if gemm
              else arch.gemm_policy())
    abstract = S.abstract_params(arch)
    total = sum(x.numel() for x in tree_leaves(abstract))
    flops = roofline.model_flops(arch, shape, total,
                                 roofline.routed_param_count(abstract))
    run = build_step(arch, shape, policy, device, seed)
    run()
    _sync(device)
    t0 = time.perf_counter()
    run()
    _sync(device)
    wall = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    calls = []
    record.OBSERVERS.append(calls.append)
    try:
        with telemetry.recording(), \
                torch.profiler.profile(activities=activities) as prof:
            run()
            _sync(device)
    finally:
        record.OBSERVERS.remove(calls.append)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"arch": arch_id, "shape": shape_name, "gemm": gemm,
            "batch": batch, "seq": shape.seq_len,
            "layers": arch.model.n_layers, "device": name,
            "wall_s": wall, "model_flops": flops,
            # A CPU run's wall is no device metric: no mfu for it.
            "mfu": (flops / (wall * roofline.PEAK_FLOPS)
                    if device.type == "cuda" else None), "prof": prof,
            "calls": calls, "emulation_kernel_ms": emulation_kernel_ms(prof)}


def summary(result: dict) -> dict:
    """The printable part of :func:`probe`'s result, with the per-site
    rows and their coverage of the step's emulation-kernel time."""
    rows = attribute_emulation(result["prof"], result["calls"])
    covered = sum(r["emu_kernel_ms"] for r in rows.values())
    total = result["emulation_kernel_ms"]
    return {**{k: v for k, v in result.items()
               if k not in ("prof", "calls")},
            "rows": [{"tag": t, "site": s, **r}
                     for (t, s), r in sorted(rows.items())],
            "tagged_emulation_kernel_ms": covered,
            "coverage": covered / total if total else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--gemm", default=None,
                    help="precision spec override; omitted, the arch "
                         "config's gemm_sites table decides (native for "
                         "plain archs)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--by-emulation-site", action="store_true",
                    help="group device time on emugemm scope tags and "
                         "call sites, beside telemetry's modeled bytes and "
                         "the bound of the same calls")
    ap.add_argument("--batch", type=int, default=1,
                    help="the step's global batch (one card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (default: "
                         "full depth)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (CPU runs)")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut the sequence (CPU runs; default: the "
                         "shape's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="also print the summary as one JSON line")
    args = ap.parse_args(argv)
    res = probe(args.arch, args.shape, args.gemm, args.batch, args.layers,
                args.device, args.seed, args.smoke, args.seq)
    print(f"{res['arch']} {res['shape']} batch {res['batch']} layers "
          f"{res['layers']} on {res['device']}: step {res['wall_s']:.4f} s, "
          f"model flops {res['model_flops']:.4e}, mfu "
          + ("not measured (CPU)" if res["mfu"] is None
             else f"{res['mfu']:.4%}"))
    if args.by_emulation_site:
        s = summary(res)
        if not s["rows"]:
            print("no emugemm scopes in this cell (gemm=native?)")
        else:
            print(f"{'calls':>6} {'modeled GB':>11} {'device ms':>10} "
                  f"{'bound ms':>9} {'share':>7}  {'site':<10} tag")
            for r in s["rows"]:
                share = "-" if r["share"] is None else f"{r['share']:.4f}"
                print(f"{r['calls']:6d} {r['modeled_gb']:11.4f} "
                      f"{r['device_ms']:10.4f} {r['bound_ms']:9.4f} "
                      f"{share:>7}  {r['site']:<10} {r['tag']}")
            cov = ("-" if s["coverage"] is None
                   else f"{s['coverage']:.4f}")
            print(f"emulation kernels: {s['emulation_kernel_ms']:.4f} ms in "
                  f"the step, {s['tagged_emulation_kernel_ms']:.4f} ms in "
                  f"tagged ranges (coverage {cov})")
        if args.json:
            print(json.dumps(s, default=str))
        return s
    for (kernel, scope), ms in attribute(res["prof"], args.top):
        print(f"{ms:10.4f} ms  {kernel[:60]:60s} {scope}")
    return res


if __name__ == "__main__":
    main()
