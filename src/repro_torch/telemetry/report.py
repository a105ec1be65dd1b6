"""Aggregate a telemetry JSONL file into per-site tables
(``repro.telemetry.report``).

Usage::

    python -m repro_torch.telemetry.report steps.jsonl [--json]

Reads the step records the Trainer and the serve engines wrote through
``telemetry.jsonl_sink`` and prints (a) a run summary (steps, mean step
time, tokens/s) and (b) the per-site table: one row per
(site, scheme, backend, impl) with call counts, modeled GB, and the
cache/guard/fallback counters attributed to it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Iterable

from repro_torch.telemetry import record as _rec

SITE_KEY = ("site", "scheme", "backend", "impl")


def load(path: str) -> list[dict[str, Any]]:
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def aggregate(records: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """Fold step records into a run summary + per-site rows."""
    steps = 0
    seconds = 0.0
    tokens_rates: list[float] = []
    kinds: dict[str, int] = {}
    sites: dict[tuple[str, ...], dict[str, float]] = {}
    guard: dict[str, float] = {}
    fallbacks: dict[str, float] = {}
    cache = {"hit": 0.0, "miss": 0.0}
    prepared = {"fused": 0.0, "torch": 0.0}
    collective_bytes = 0.0

    for rec in records:
        steps += 1
        seconds += float(rec.get("seconds") or 0.0)
        kinds[rec.get("kind", "step")] = kinds.get(rec.get("kind", "step"), 0) + 1
        if rec.get("tokens_per_s"):
            tokens_rates.append(float(rec["tokens_per_s"]))
        for g, v in (rec.get("guard") or {}).items():
            guard[g] = guard.get(g, 0.0) + float(v)
        for item in rec.get("counters") or []:
            name = item.get("name")
            labels = item.get("labels") or {}
            value = float(item.get("value") or 0.0)
            if name in (_rec.EMULATED_CALLS, _rec.EMULATED_TRACES,
                        _rec.MODELED_HBM_BYTES):
                key = tuple(labels.get(k, "-") for k in SITE_KEY)
                row = sites.setdefault(
                    key, {"calls": 0.0, "traces": 0.0, "hbm_bytes": 0.0})
                if name == _rec.EMULATED_CALLS:
                    row["calls"] += value
                elif name == _rec.EMULATED_TRACES:
                    row["traces"] += value
                else:
                    row["hbm_bytes"] += value
            elif name == _rec.BLOCK_CACHE:
                result = labels.get("result", "miss")
                cache[result] = cache.get(result, 0.0) + value
            elif name == _rec.PREPARED_CONSUME:
                route = labels.get("route", "torch")
                prepared[route] = prepared.get(route, 0.0) + value
            elif name == _rec.FALLBACK_EVENTS:
                reason = labels.get("reason", "?")
                fallbacks[reason] = fallbacks.get(reason, 0.0) + value
            elif name == _rec.MODELED_COLLECTIVE_BYTES:
                collective_bytes += value

    return {
        "steps": steps,
        "kinds": kinds,
        "total_seconds": seconds,
        "mean_step_seconds": seconds / steps if steps else 0.0,
        "mean_tokens_per_s": (
            sum(tokens_rates) / len(tokens_rates) if tokens_rates else None
        ),
        "sites": [
            {
                "site": key[0], "scheme": key[1],
                "backend": key[2], "impl": key[3],
                **row,
            }
            for key, row in sorted(sites.items())
        ],
        "block_cache": cache,
        "prepared": prepared,
        "guard": guard,
        "fallbacks": fallbacks,
        "modeled_collective_bytes": collective_bytes,
    }


def _gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.3f}"


def render(summary: dict[str, Any]) -> str:
    lines = []
    lines.append(
        f"steps={summary['steps']} "
        f"total_s={summary['total_seconds']:.3f} "
        f"mean_step_s={summary['mean_step_seconds']:.4f} "
        + (
            f"mean_tokens_per_s={summary['mean_tokens_per_s']:.1f}"
            if summary["mean_tokens_per_s"] is not None
            else "mean_tokens_per_s=-"
        )
    )
    header = (
        f"{'site':>8} {'scheme':>10} {'backend':>8} {'impl':>14} "
        f"{'calls':>8} {'traces':>7} {'modeled_GB':>11}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for row in summary["sites"]:
        lines.append(
            f"{row['site']:>8} {row['scheme']:>10} {row['backend']:>8} "
            f"{row['impl']:>14} {row['calls']:>8.0f} {row['traces']:>7.0f} "
            f"{_gb(row['hbm_bytes']):>11}"
        )
    if not summary["sites"]:
        lines.append("(no emulated-call records — was REPRO_TELEMETRY=1 set?)")
    cache = summary["block_cache"]
    total = cache.get("hit", 0) + cache.get("miss", 0)
    lines.append(
        f"block_cache: hit={cache.get('hit', 0):.0f} "
        f"miss={cache.get('miss', 0):.0f} "
        f"ratio={cache.get('hit', 0) / total if total else 0:.3f}"
    )
    prep = summary["prepared"]
    lines.append(
        f"prepared_consume: fused={prep.get('fused', 0):.0f} "
        f"torch={prep.get('torch', 0):.0f}"
    )
    if summary["guard"]:
        lines.append(
            "guard: "
            + " ".join(f"{k}={v:.0f}" for k, v in sorted(summary["guard"].items()))
        )
    if summary["fallbacks"]:
        lines.append(
            "fallbacks: "
            + " ".join(
                f"{k}={v:.0f}" for k, v in sorted(summary["fallbacks"].items())
            )
        )
    if summary["modeled_collective_bytes"]:
        lines.append(
            f"modeled_collective_GB={_gb(summary['modeled_collective_bytes'])}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report", description=__doc__
    )
    parser.add_argument("jsonl", help="telemetry JSONL file to aggregate")
    parser.add_argument(
        "--json", action="store_true", help="emit the aggregate as JSON"
    )
    args = parser.parse_args(argv)
    summary = aggregate(load(args.jsonl))
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
