"""CLI entry point: ``PYTHONPATH=src python -m repro_torch.lint``.

Exit 0 iff (a) every AST violation is covered by the ratchet and (b) the
graph gate passes for every policy x variant.

Flags:
    --no-graph            AST rules only (no replay runs)
    --device {cpu,cuda}   where the gate replays (default: the card, as
                          every entry point of the port; raises without
                          one)
    --update-baselines    re-pin baselines.json (on the CPU)
    --update-ratchet      rewrite ratchet.json from the current violations
                          (review reasons!)
    --report PATH         write a JSON report
    --rules a,b           run only the named AST rules
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]

# The directories the AST layer scans (rules filter further by path), the
# JAX lint's three under the port.
SCAN_DIRS = ("src/repro_torch/core", "src/repro_torch/kernels",
             "src/repro_torch/obs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.lint")
    ap.add_argument("--no-graph", action="store_true")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    ap.add_argument("--update-baselines", action="store_true")
    ap.add_argument("--update-ratchet", action="store_true")
    ap.add_argument("--report", type=Path, default=None)
    ap.add_argument("--rules", type=str, default=None,
                    help="comma-separated subset of AST rules")
    args = ap.parse_args(argv)

    from . import ast_rules, ratchet
    from .common import iter_source_files

    files = iter_source_files(REPO_ROOT, SCAN_DIRS)
    rules = args.rules.split(",") if args.rules else None
    violations = ast_rules.run_rules(files, rules)

    ratchet_path = Path(__file__).with_name("ratchet.json")
    entries = ratchet.load_ratchet(ratchet_path)
    if args.update_ratchet:
        ratchet.save_ratchet(
            ratchet_path, ratchet.updated_entries(violations, entries))
        print(f"ratchet written: {ratchet_path}")
        entries = ratchet.load_ratchet(ratchet_path)
    ast_errors, ast_notes = ratchet.compare(violations, entries)

    report = {"ast": {"violations": [v.__dict__ for v in violations],
                      "errors": ast_errors, "notes": ast_notes}}
    print(f"repro-lint: {len(files)} files, {len(violations)} AST "
          f"violation(s), {len(ast_errors)} un-ratcheted group(s)")
    for v in violations:
        covered = "" if any(e.startswith(ratchet.key_to_str(v.key))
                            for e in ast_errors) else " [ratcheted]"
        print(f"  {v.format()}{covered}")
    for e in ast_errors:
        print(f"ERROR [ast] {e}")
    for n in ast_notes:
        print(f"note [ast] {n}")

    gate_errors = []
    if not args.no_graph:
        from . import graph_gate
        gate_errors, gate_notes, results = graph_gate.run_gate(
            args.device, update=args.update_baselines)
        report["graph"] = {"errors": gate_errors, "notes": gate_notes,
                           "fingerprints": results}
        print(f"graph gate: {len(results)} policy-variant entries, "
              f"{sum(len(k) for k in results.values())} event keys, "
              f"{len(gate_errors)} error(s)")
        for line in graph_gate.node_lines(results):
            print(f"  {line}")
        for e in gate_errors:
            print(f"ERROR [graph] {e}")
        for n in gate_notes:
            print(f"note [graph] {n}")

    if args.report:
        args.report.write_text(json.dumps(report, indent=2) + "\n")
        print(f"report written: {args.report}")

    ok = not ast_errors and not gate_errors
    print("repro-lint: " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
