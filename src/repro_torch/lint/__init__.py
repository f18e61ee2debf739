"""repro-lint for the port: static analysis of the replay's
decision-invariance contract under CUDA-graph capture.

Two layers, run as ``PYTHONPATH=src python -m repro_torch.lint`` (the
port's counterpart of the JAX package's ``python -m tools.lint``):

* AST rules (:mod:`repro_torch.lint.ast_rules`): backend-purity,
  dtype-discipline, capture-hazard, buffer-safety, capture-purity —
  stdlib ``ast``, ratcheted via ``ratchet.json``.
* graph gate (:mod:`repro_torch.lint.graph_gate`): replays every policy
  (plain / chunked / K = 2 sharded, and MCC / MECC through the pick
  kernels) on a mixed A30 + A100 + H100 fixture, records each event key's
  dispatched operations and pins float64-freedom, no host
  synchronisation in a captured key, key invariance and a fingerprint
  against ``baselines.json``; on the card also the captured graphs' nodes
  and pick launches.
"""
from .common import SourceFile, Violation, iter_source_files
from .ast_rules import RULES, run_rules

__all__ = ["SourceFile", "Violation", "iter_source_files", "RULES",
           "run_rules"]
