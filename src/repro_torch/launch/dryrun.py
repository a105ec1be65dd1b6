"""Dry run of the port (``repro.launch.dryrun``): every (architecture x
input shape x production mesh) cell sized on the meta device, with no
allocation and no process group.

For each cell it builds the (16, 16) single-pod or (2, 16, 16)
multi-pod mesh device-free (``launch.mesh.make_production_mesh``), the
abstract state of the step on the meta device, and the reference's specs
of it (``parallel.sharding``), and writes the record the reference
writes, under the same keys:

* ``params`` and ``model_flops_global`` as the reference counts them;
* ``memory.argument_bytes``: the bytes one device holds of the step's
  arguments (train: params, optimizer state and batch; prefill: params
  and inputs; decode: params, cache and tokens), from the shard shapes
  the specs give;
* ``roofline`` from ``utils.roofline.roofline_terms`` on the H100's
  peaks: the model FLOPs a device, its argument bytes, and the modeled
  collective bytes of the step's dense GEMMs on the mesh
  (``core.traffic.sharded_gemm_traffic``, partitioned as
  ``parallel.shard_gemm.gemm_partition`` picks; three GEMMs a weight in
  training, one in serving).

What only XLA's compiler can fill stays ``None``: ``compile_s``,
``memory`` beyond the arguments (output, temporaries, generated code),
``cost_analysis``, ``hlo`` and with it ``useful_flops_ratio`` (model
FLOPs over the compiled HLO's). The port compiles nothing ahead of time:
it runs eagerly. These are projections, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh single --out /tmp/dry.json
  PYTHONPATH=src python -m repro_torch.utils.render_tables /tmp/dry.json
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback

from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import traffic
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import shard_gemm
from repro_torch.parallel import sharding as shd
from repro_torch.utils import roofline
from repro_torch.utils.tree import tree_leaves


def _bytes_per_device(tree, specs, mesh) -> int:
    leaves = shd._flatten_with_path(tree)
    spec_leaves = [s for _, s in shd._flatten_with_path(specs)]
    total = 0
    for (_, x), spec in zip(leaves, spec_leaves):
        shape = shd.local_shape(tuple(x.shape), spec, mesh)
        total += math.prod(shape) * x.element_size()
    return total


def _input_bytes(arch, shape, mesh) -> int:
    inputs = arch.input_specs(shape)
    return _bytes_per_device(inputs, S.batch_specs(arch, shape, mesh), mesh)


def _gemm_collective_bytes(params, tokens: int, mesh, gemm: str,
                           passes: int) -> int:
    """Modeled collective bytes a device of the step's dense GEMMs: each
    2-D dense weight (a layer stack counts its layers) as one (tokens, K)
    @ (K, N) partitioned as ``gemm_partition`` picks."""
    from repro_torch import api
    cfg = api.precision(gemm)
    scheme = cfg.scheme if cfg.scheme in ("ozaki1", "ozaki2") else "ozaki1"
    p = (len(cfg.resolved_moduli()) if cfg.scheme == "ozaki2"
         else (cfg.p if cfg.scheme == "ozaki1" else 1))
    mesh_shape = tuple(mesh.shape.items())
    total = 0
    for path, x in shd._flatten_with_path(params):
        core = x.shape[1:] if "layers" in path else x.shape
        if path[-1] not in shd.TILE_NAMES or len(core) != 2:
            continue
        k, n = core
        part = shard_gemm.gemm_partition(tokens, k, n, mesh)
        if part is None:
            continue
        t = traffic.sharded_gemm_traffic(
            traffic.GemmShape(tokens, n, k), p, mesh_shape,
            partition=part.kind, scheme=scheme)
        layers = x.shape[0] if "layers" in path else 1
        total += t["collective_bytes_per_device"] * layers * passes
    return total


def run_cell(arch_id: str, shape: ShapeSpec, multi_pod: bool,
             gemm: str = "native") -> dict:
    arch = configs.get_config(arch_id)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    rec = {"arch": arch_id, "shape": shape.name,
           "mesh": "2x16x16" if multi_pod else "16x16", "gemm": gemm,
           "kind": shape.kind}
    t0 = time.time()
    params = S.abstract_params(arch)
    p_specs = shd.param_pspecs(params, mesh, fsdp=arch.train.fsdp,
                               attn_sp=arch.model.attn_sharding == "sp")
    arg_bytes = _bytes_per_device(params, p_specs, mesh)
    if shape.kind == "train":
        specs = S.state_specs(arch, mesh)
        opt = S.abstract_opt(arch, params)
        arg_bytes += _bytes_per_device(opt, specs["opt"], mesh)
        arg_bytes += _input_bytes(arch, shape, mesh)
    elif shape.kind == "prefill":
        arg_bytes += _input_bytes(arch, shape, mesh)
    else:
        cache = S.abstract_cache(arch, shape.global_batch, shape.seq_len)
        arg_bytes += _bytes_per_device(cache, shd.cache_pspecs(cache, mesh),
                                       mesh)
        arg_bytes += _input_bytes(arch, shape, mesh)
    rec["lower_s"] = round(time.time() - t0, 1)
    rec["compile_s"] = None
    rec["memory"] = {"argument_bytes": int(arg_bytes), "output_bytes": None,
                     "temp_bytes": None, "generated_code_bytes": None}
    rec["cost_analysis"] = None
    rec["hlo"] = None

    n_params = sum(math.prod(p.shape) for p in tree_leaves(params))
    n_routed = roofline.routed_param_count(params)
    mf = roofline.model_flops(arch, shape, n_params, n_routed)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    coll = _gemm_collective_bytes(params, tokens, mesh, gemm,
                                  3 if shape.kind == "train" else 1)
    rec["roofline"] = roofline.roofline_terms(mf / n_chips, arg_bytes, coll)
    rec["model_flops_global"] = mf
    rec["useful_flops_ratio"] = None
    rec["params"] = n_params
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--gemm", default="native",
                    help="native | ozaki1-pN | ozaki2-mN")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write one telemetry record per cell to this JSONL "
                         "file (implies telemetry)")
    args = ap.parse_args(argv)

    from repro_torch import telemetry
    sink = tracker = None
    if args.metrics_jsonl:
        telemetry.enable()
        sink = telemetry.jsonl_sink(args.metrics_jsonl)
        tracker = telemetry.StepTracker()

    arch_ids = configs.ARCH_IDS if args.arch == "all" else (args.arch,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]
    try:
        with open(args.out) as f:
            results = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        results = []
    done = {(r["arch"], r["shape"], r["mesh"], r.get("gemm", "native"))
            for r in results}

    failures = 0
    cell_idx = 0
    for arch_id in arch_ids:
        arch = configs.get_config(arch_id)
        shapes = arch.shapes()
        if args.shape != "all":
            shapes = [s for s in shapes if s.name == args.shape]
        for shape in shapes:
            for multi in meshes:
                mesh_name = "2x16x16" if multi else "16x16"
                key = (arch_id, shape.name, mesh_name, args.gemm)
                if args.skip_existing and key in done:
                    print(f"skip {key}")
                    continue
                print(f"=== {arch_id} x {shape.name} x {mesh_name} "
                      f"(gemm={args.gemm}) ===", flush=True)
                try:
                    t_cell = time.time()
                    rec = run_cell(arch_id, shape, multi, args.gemm)
                    if tracker is not None:
                        tracker.step_metrics(
                            cell_idx, time.time() - t_cell, kind="cell",
                            extra={"arch": arch_id, "shape": shape.name,
                                   "mesh": mesh_name, "gemm": args.gemm})
                    cell_idx += 1
                    r = rec["roofline"]
                    print(f"  sized in {rec['lower_s']}s | compute "
                          f"{r['compute_s']:.4f}s memory {r['memory_s']:.4f}s"
                          f" coll {r['collective_s']:.4f}s -> "
                          f"{r['bottleneck']}", flush=True)
                    results = [x for x in results
                               if (x["arch"], x["shape"], x["mesh"],
                                   x.get("gemm", "native")) != key]
                    results.append(rec)
                except Exception as e:
                    failures += 1
                    print(f"  FAILED: {type(e).__name__}: {e}")
                    traceback.print_exc()
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    if sink is not None:
        sink.close()
    print(f"done; {failures} failures; results in {args.out}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
