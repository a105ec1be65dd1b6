"""Render dry-run JSON results into the EXPERIMENTS.md markdown tables."""

import json
import sys


def render(path, mesh_filter=None):
    rows = json.load(open(path))
    out = []
    out.append("| arch | shape | mesh | compute s | memory s | collective s"
               " | bottleneck | rf | useful | args GB/dev |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        t = r["roofline"]
        peak = max(t["compute_s"], t["memory_s"], t["collective_s"])
        rf = t["compute_s"] / peak if peak else 0
        mem = (r["memory"]["argument_bytes"] or 0) / 1e9
        # The port's dry run compiles nothing: no HLO, no useful ratio.
        useful = r["useful_flops_ratio"]
        useful = "-" if useful is None else f"{useful:.2f}"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['collective_s']:.4f} | {t['bottleneck']} "
            f"| {rf:.1%} | {useful} | {mem:.2f} |")
    return "\n".join(out)


if __name__ == "__main__":
    print(render(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None))
