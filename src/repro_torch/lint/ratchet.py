# Port of tools/lint/ratchet.py (the JAX package's repro-lint): copied, its file path and command the port's, so the port imports nothing of tools.
"""Ratchet: grandfathered AST violations that may only shrink.

``src/repro_torch/lint/ratchet.json`` maps ``"rule|path|scope|code"`` to
``{"count": N, "reason": "..."}``.  The gate fails on any violation
group absent from the ratchet, and on any group whose count *grew*;
groups that shrink or disappear are reported so the file can be
tightened with ``--update-ratchet`` (which never adds entries unless
run with ``--update-ratchet`` explicitly — landing a new violation
requires a deliberate ratchet edit, reason included).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from .common import Violation, group_counts

KeyT = Tuple[str, str, str, str]
SEP = "|"


def key_to_str(key: KeyT) -> str:
    return SEP.join(key)


def str_to_key(s: str) -> KeyT:
    parts = s.split(SEP)
    if len(parts) != 4:
        raise ValueError(f"malformed ratchet key: {s!r}")
    return tuple(parts)  # type: ignore[return-value]


def load_ratchet(path: Path) -> Dict[KeyT, dict]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str_to_key(k): v for k, v in data.get("entries", {}).items()}


def save_ratchet(path: Path, entries: Dict[KeyT, dict]) -> None:
    payload = {
        "_comment": ("Grandfathered repro-lint violations; counts may "
                     "only shrink. Regenerate with "
                     "`PYTHONPATH=src python -m repro_torch.lint --update-ratchet` after "
                     "deliberately accepting a violation (add a reason)."),
        "entries": {key_to_str(k): entries[k]
                    for k in sorted(entries)},
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=False) + "\n")


def compare(violations: Iterable[Violation],
            ratchet: Dict[KeyT, dict]
            ) -> Tuple[List[str], List[str]]:
    """(errors, notes): errors are new/grown groups; notes report slack
    (shrunk or vanished ratchet entries)."""
    counts = group_counts(violations)
    errors: List[str] = []
    notes: List[str] = []
    for key, n in sorted(counts.items()):
        allowed = ratchet.get(key, {}).get("count", 0)
        if n > allowed:
            kind = "new" if allowed == 0 else "grew"
            errors.append(
                f"{key_to_str(key)}: {n} violation(s), {allowed} "
                f"ratcheted ({kind})")
        elif n < allowed:
            notes.append(
                f"{key_to_str(key)}: shrank {allowed} -> {n}; tighten "
                "ratchet.json")
    for key, entry in sorted(ratchet.items()):
        if key not in counts:
            notes.append(
                f"{key_to_str(key)}: no longer occurs; drop from "
                "ratchet.json")
    return errors, notes


def updated_entries(violations: Iterable[Violation],
                    ratchet: Dict[KeyT, dict]) -> Dict[KeyT, dict]:
    """Current violations as ratchet entries, preserving existing
    reasons; vanished entries are dropped, shrunk counts tightened."""
    counts = group_counts(violations)
    out: Dict[KeyT, dict] = {}
    for key, n in counts.items():
        reason = ratchet.get(key, {}).get("reason", "TODO: justify")
        out[key] = {"count": n, "reason": reason}
    return out
