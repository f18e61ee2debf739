# Port of tools/lint/common.py (the JAX package's repro-lint): copied, one docstring line naming the port's ratchet.json, so the port imports nothing of tools.
"""Shared plumbing for repro-lint: source loading, scopes, violations.

A :class:`Violation` is the unit every rule emits.  Its *ratchet key*
deliberately excludes line/column numbers — grandfathered violations in
``src/repro_torch/lint/ratchet.json`` are keyed by ``(rule, path, scope, code)``
with a count, so unrelated edits that shift lines never invalidate the
ratchet, while a *new* occurrence of the same construct in the same
function does trip it (the count grows).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative posix path
    line: int
    scope: str         # qualified function/class scope, or "<module>"
    code: str          # short stable token, e.g. "np.float64", "jit-in-loop"
    message: str

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.scope, self.code)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message} "
                f"(scope {self.scope})")


@dataclasses.dataclass
class SourceFile:
    """A parsed module plus the repo-relative path rules filter on."""
    rel_path: str
    source: str
    tree: ast.Module

    @classmethod
    def load(cls, path: Path, rel_path: str) -> "SourceFile":
        src = path.read_text()
        return cls(rel_path=rel_path.replace("\\", "/"), source=src,
                   tree=ast.parse(src, filename=rel_path))


def iter_source_files(repo_root: Path,
                      rel_dirs: Sequence[str]) -> List[SourceFile]:
    out = []
    for rel in rel_dirs:
        base = repo_root / rel
        if base.is_file():
            out.append(SourceFile.load(base, rel))
            continue
        for p in sorted(base.rglob("*.py")):
            out.append(SourceFile.load(p, str(p.relative_to(repo_root))))
    return out


def attach_parents(tree: ast.AST) -> None:
    """Annotate every node with ``._lint_parent`` for ancestry walks."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._lint_parent = node  # type: ignore[attr-defined]


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_lint_parent", None)


def scope_of(node: ast.AST) -> str:
    """Qualified ``Class.method`` / ``outer.inner`` scope of a node
    (requires :func:`attach_parents`); ``<module>`` at top level."""
    parts = []
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            parts.append(anc.name)
    return ".".join(reversed(parts)) or "<module>"


def enclosing_functions(node: ast.AST) -> List[ast.AST]:
    """Innermost-first chain of enclosing function defs."""
    return [a for a in ancestors(node)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda))]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def module_aliases(tree: ast.Module,
                   targets: Dict[str, str]) -> Dict[str, str]:
    """Map local names to canonical module names.

    ``targets`` maps canonical import paths (``"numpy"``,
    ``"jax.numpy"``) to canonical short names (``"np"``, ``"jnp"``);
    returns {local_alias: canonical_short_name} for every matching
    ``import``/``from`` in the module (e.g. ``import numpy as onp`` ->
    ``{"onp": "np"}``).
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in targets:
                    out[a.asname or a.name.split(".")[0]] = \
                        targets[a.name]
        elif isinstance(node, ast.ImportFrom):
            # `from jax import numpy as jnp`
            for a in node.names:
                full = f"{node.module}.{a.name}" if node.module else a.name
                if full in targets:
                    out[a.asname or a.name] = targets[full]
    return out


def group_counts(violations: Iterable[Violation]
                 ) -> Dict[Tuple[str, str, str, str], int]:
    counts: Dict[Tuple[str, str, str, str], int] = {}
    for v in violations:
        counts[v.key] = counts.get(v.key, 0) + 1
    return counts
