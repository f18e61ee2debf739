# Copied from repro/obs/report.py (the JAX package), so the port imports nothing of it; only the usage line (docstring and argparse prog) names repro_torch.
"""Per-run observability dashboard from flight-recorder JSONL files.

    PYTHONPATH=src python -m repro_torch.obs.report RUN.jsonl [MORE.jsonl ...]
                                                    [--json]

Groups records by ``run_id`` and renders, per run: the result summary
(acceptance, migrations), the rejection-reason breakdown, per-model
fragmentation/utilization curves (ASCII sparklines from the in-scan
telemetry), GRMU basket occupancy, compile-cache stats and aggregated
span timings.  ``--json`` prints the same summaries as a JSON list for
machine consumption (the round-trip is pinned in tests/test_obs.py).

Only stdlib imports — rendering a report can never perturb an engine.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from .inscan import SCHEMA_VERSION

_SPARK = "▁▂▃▄▅▆▇█"


def load(paths: Sequence[str]) -> List[dict]:
    """Parse JSONL files into per-run dicts, in first-seen order.  A
    record from a *newer* schema than this reader raises ValueError —
    versions are explicit, never silently misread."""
    runs: Dict[str, dict] = {}
    for path in paths:
        with open(path) as fh:
            for ln, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                ver = rec.get("schema")
                if ver is None or ver > SCHEMA_VERSION:
                    raise ValueError(
                        f"{path}:{ln}: record schema {ver!r} is newer "
                        f"than this reader ({SCHEMA_VERSION}); upgrade "
                        "repro.obs")
                rid = rec.get("run_id", "?")
                run = runs.setdefault(rid, {
                    "run_id": rid, "meta": {}, "spans": [],
                    "cache": None, "results": [], "telemetry": None,
                })
                kind = rec.get("kind")
                if kind == "meta":
                    run["meta"] = {k: v for k, v in rec.items()
                                   if k not in ("schema", "kind",
                                                "run_id")}
                elif kind == "span":
                    run["spans"].append(rec)
                elif kind == "cache":
                    run["cache"] = {k: rec[k] for k in
                                    ("hits", "misses", "evictions",
                                     "entries") if k in rec}
                elif kind == "result":
                    run["results"].append(rec)
                elif kind == "telemetry":
                    run["telemetry"] = {
                        k: v for k, v in rec.items()
                        if k not in ("schema", "kind", "run_id")}
    return list(runs.values())


def _agg_spans(spans: List[dict]) -> Dict[str, dict]:
    agg: Dict[str, dict] = {}
    for s in spans:
        a = agg.setdefault(s.get("name", "?"),
                           {"count": 0, "total_s": 0.0, "bytes": 0})
        a["count"] += 1
        a["total_s"] += float(s.get("dur_s", 0.0))
        a["bytes"] += int(s.get("nbytes", 0))
    return agg


def summarize(run: dict) -> dict:
    """Machine-readable summary of one run (what ``--json`` prints)."""
    out = {"run_id": run["run_id"], "meta": run["meta"],
           "spans": _agg_spans(run["spans"]), "cache": run["cache"]}
    if run["results"]:
        last = run["results"][-1]
        out["summary"] = last.get("summary", {})
        out["rejection_reasons"] = last.get("rejection_reasons", {})
        out["acceptance_rate"] = out["summary"].get("acceptance_rate")
    tele = run["telemetry"]
    if tele:
        out["model_names"] = tele.get("model_names", [])
        util = tele.get("util") or []
        out["final_util"] = util[-1] if util else None
        rej = tele.get("rej_hourly") or []
        out["final_rejections_by_reason"] = rej[-1] if rej else None
        baskets = tele.get("basket_hourly") or []
        out["final_baskets"] = baskets[-1] if baskets else None
    return out


def sparkline(values: Sequence[float], width: int = 48) -> str:
    """Downsample ``values`` to ``width`` chars of block-glyph sparkline
    (empty string for empty input)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        stride = len(vals) / width
        vals = [vals[int(i * stride)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in vals)


def render_text(run: dict) -> str:
    lines = [f"run {run['run_id']}"]
    if run["meta"]:
        lines.append("  meta: " + json.dumps(run["meta"], sort_keys=True))
    for res in run["results"]:
        s = res.get("summary", {})
        lines.append(
            f"  result: policy={s.get('policy')} "
            f"accepted={s.get('accepted')}/{s.get('total')} "
            f"(rate={s.get('acceptance_rate')}) "
            f"migrations={s.get('migrations')}")
        rr = res.get("rejection_reasons") or {}
        if rr:
            parts = " ".join(f"{k}={v}" for k, v in rr.items())
            lines.append(f"  rejections: {parts}")
    tele = run["telemetry"]
    if tele:
        names = tele.get("model_names", [])
        util = tele.get("util") or []
        frag = tele.get("frag_mean") or []
        for m, name in enumerate(names):
            u = [row[m] for row in util]
            f = [row[m] for row in frag]
            if u:
                lines.append(f"  util[{name}]  {sparkline(u)}  "
                             f"last={u[-1]:.3f}")
            if f:
                lines.append(f"  frag[{name}]  {sparkline(f)}  "
                             f"last={f[-1]:.3f}")
        baskets = tele.get("basket_hourly") or []
        if baskets and any(any(row) for row in baskets):
            h, l, p = baskets[-1]
            lines.append(f"  baskets: heavy={h} light={l} pool={p}")
    if run["cache"]:
        c = run["cache"]
        lines.append(f"  cache: hits={c.get('hits')} "
                     f"misses={c.get('misses')} "
                     f"evictions={c.get('evictions')} "
                     f"entries={c.get('entries')}")
    agg = _agg_spans(run["spans"])
    for name in sorted(agg):
        a = agg[name]
        extra = f" bytes={a['bytes']}" if a["bytes"] else ""
        lines.append(f"  span {name}: n={a['count']} "
                     f"total={a['total_s'] * 1e3:.1f}ms{extra}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render flight-recorder JSONL files.")
    ap.add_argument("paths", nargs="+", help="obs JSONL file(s)")
    ap.add_argument("--json", action="store_true",
                    help="print JSON summaries instead of text")
    args = ap.parse_args(argv)
    runs = load(args.paths)
    if args.json:
        print(json.dumps([summarize(r) for r in runs], indent=2))
    else:
        for r in runs:
            print(render_text(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["load", "summarize", "sparkline", "render_text", "main"]
