"""The port's repro-lint (``repro_torch.lint``), on the CPU.

Mirrors tests/test_lint.py: for each of the five AST rules a violating
snippet and its clean twin (and the sanctioned exemptions: the pick
wrappers' ``LAUNCHES`` count and GRMU's consolidation plan), the
ratchet's semantics, the repo clean under its ratchet; then the graph
gate: its fixture is the JAX gate's array for array, every policy x
variant passes, and it catches an injected float64, an injected
``.item()``, an event-dependent Python constant and fingerprint drift.
"""
import ast
import dataclasses
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import batched as B
from repro_torch.core import compile_cache
from repro_torch.lint import __main__ as cli
from repro_torch.lint import graph_gate as G
from repro_torch.lint import ratchet as R
from repro_torch.lint.ast_rules import (check_backend_purity,
                                        check_buffer_safety,
                                        check_capture_hazard,
                                        check_capture_purity,
                                        check_dtype_discipline, run_rules)
from repro_torch.lint.common import SourceFile, iter_source_files

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = "src/repro_torch"
BATCHED = f"{PKG}/core/batched.py"


def sf(src, rel=BATCHED, **parts):
    """A parsed snippet; each ``{name}`` in it is replaced by
    ``parts[name]``, whose later lines take the placeholder's indent."""
    src = textwrap.dedent(src)
    for name, text in parts.items():
        tag = "{" + name + "}"
        for line in src.split("\n"):
            if tag in line:
                pad = line[:len(line) - len(line.lstrip())]
                src = src.replace(tag, text.replace("\n", "\n" + pad))
    return SourceFile(rel_path=rel, source=src, tree=ast.parse(src))


def codes(violations):
    return sorted(v.code for v in violations)


# ---------------------------------------------------------------------------
# backend-purity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,want", [
    ("return np.maximum(free, 0)", ["np.maximum"]),
    ("return xp.maximum(free, 0)", []),
    ("def inner(m):\n    return np.zeros(m)\nreturn inner", ["np.zeros"]),
])
def test_backend_purity(body, want):
    src = sf("""
        import numpy as np
        def _stage_host(rows):      # xp-free helper: np is fine here
            return np.asarray(rows)
        def scores(xp, free):
            {body}
    """, rel=f"{PKG}/core/policy_core_np.py", body=body)
    assert codes(check_backend_purity([src])) == want


# ---------------------------------------------------------------------------
# dtype-discipline
# ---------------------------------------------------------------------------

def test_dtype_flags_packed_arith_and_64bit_literals():
    bad = sf("""
        import numpy as np
        import torch
        def stage(tr, h):
            k = tr["kind"] + 1                  # packed, not widened
            vmp = h["vm_pids"]
            off = vmp * 2                       # one-level dataflow
            a = np.float64(3)
            b = torch.zeros(2, dtype=torch.float64)
            c = torch.ones(2, dtype=torch.double)
            d = torch.arange(2, dtype=torch.int64)
            e = torch.arange(2, dtype=torch.long)
            f = np.zeros(2, np.complex128)
            g = np.asarray(k, dtype="float64")
            return k, off, a, b, c, d, e, f, g
    """)
    assert codes(check_dtype_discipline([bad])) == sorted([
        "packed-arith:kind", "packed-arith:vm_pids", "np.float64",
        "torch.float64", "torch.double", "torch.int64", "torch.long",
        "np.complex128", "dtype-str:float64"])


def test_dtype_clean_twin_widens_and_stays_32bit():
    good = sf("""
        import numpy as np
        import torch
        def stage(tr, trace):
            k = tr["kind"].astype(np.int32) + 1
            p = tr["profile"].to(torch.int32) * 2
            q = tr["vm_pids"][0].long() + 1
            d = trace.dev
            r = d["arr_pids"][3] + 1           # the widened device copy
            return k, p, q, r, torch.zeros(2, dtype=torch.int32)
    """)
    assert check_dtype_discipline([good]) == []


# ---------------------------------------------------------------------------
# capture-hazard
# ---------------------------------------------------------------------------

CAPTURE_HOME = """
    import torch
    class Runner:
        def _capture(self, fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                fn()
"""


def test_capture_hazard_flags_graphs_libraries_nvcc_and_compile():
    bad = sf("""
        import ctypes
        import subprocess
        import torch
        from torch.utils import cpp_extension
        def warm(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return torch.cuda.make_graphed_callables(fn, (torch.ones(1),))
        def lib(path):
            cmd = ["nvcc", "-shared", path]
            subprocess.run(cmd)
            cpp_extension.load(name="x", sources=[path])
            return ctypes.CDLL(path)
        @torch.compile
        def fused(x):
            return torch.compile(lambda y: y + 1)(x)
    """)
    assert codes(check_capture_hazard([bad])) == sorted([
        "graph-outside-cache", "graph-outside-cache",
        "graph-outside-cache", "nvcc-subprocess", "native-load:load",
        "native-load:CDLL", "torch.compile", "torch.compile"])


def test_capture_hazard_clean_twin_at_home():
    build = sf("""
        import ctypes
        import subprocess
        def build_all(nvcc, src):
            cmd = [nvcc, "-o", "lib.so", src]
            subprocess.Popen(cmd)
            return ctypes.CDLL("lib.so")
    """, rel=f"{PKG}/kernels/_build.py")
    assert check_capture_hazard([sf(CAPTURE_HOME), build]) == []
    # The same graph in another method, or another file, is flagged.
    moved = sf(CAPTURE_HOME.replace("_capture", "load"))
    elsewhere = sf(CAPTURE_HOME, rel=f"{PKG}/core/streaming.py")
    assert codes(check_capture_hazard([moved, elsewhere])) == [
        "graph-outside-cache"] * 4


KEY_SRC = """
    import dataclasses
    from . import compile_cache
    @dataclasses.dataclass{frozen}
    class Cfg:
        policy: int = 0
    def replay_key(st: Cfg, trace, state0, *variant, width=None):
        return (st, *variant, (1, 2), str(trace.device))
    def make(st: Cfg, trace, state0, rows):
        return compile_cache.cached_replay_fn(
            replay_key(st, trace, state0, "serve", {variant}),
            lambda: None)
"""


@pytest.mark.parametrize("frozen,variant,want", [
    ("", "rows", ["unhashable-cache-key:Cfg"]),
    ("(frozen=True)", "[rows]", ["mutable-cache-key"]),
    ("(frozen=True)", "rows", []),
])
def test_capture_hazard_cache_keys(frozen, variant, want):
    src = sf(KEY_SRC, frozen=frozen, variant=variant)
    assert codes(check_capture_hazard([src])) == want


# ---------------------------------------------------------------------------
# buffer-safety
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,want", [
    ("return runner.state['free']", ["static-buffer-escape:state"]),
    ("out = runner.step.ev_arg[:4]\nreturn out",
     ["static-buffer-escape:ev_arg"]),
    ("self.kept = run.runner.state", ["static-buffer-escape:state"]),
    ("return {k: v for k, v in finalize(runner.state).items()}",
     ["static-buffer-escape:state"]),
    # Clean twins: Runner.finish's clone, a copy into the caller's tensor,
    # a reduction (a fresh tensor), a shape.
    ("return {k: v.clone() for k, v in finalize(runner.state).items()}", []),
    ("for k, v in state.items():\n    v.copy_(runner.state[k])", []),
    ("return runner.state['hourly'].sum()", []),
    ("return runner.step.ev_arg.shape[0]", []),
])
def test_buffer_safety(body, want):
    src = sf("""
        def read(self, run, runner, state, finalize):
            {body}
    """, body=body)
    assert codes(check_buffer_safety([src])) == want


def test_buffer_safety_runner_keeps_its_own_buffers():
    src = sf("""
        class Runner:
            def __init__(self, st, state0):
                self.state = {k: v for k, v in state0.items()}
                self.step = Step(st, self.state)
            def finish(self, finalize):
                return {k: v.clone() for k, v in finalize(self.state).items()}
            def leak(self):
                return self.step.cur
    """)
    v = check_buffer_safety([src])
    assert codes(v) == ["static-buffer-escape:cur"]
    assert v[0].scope == "Runner.leak"


# ---------------------------------------------------------------------------
# capture-purity
# ---------------------------------------------------------------------------

STEP_SRC = """
    import time
    import torch
    from . import policy_core as pc
    class Step:
        def arrival(self, p, prof0, heavy):
            vi = self.ev_arg[self.cur]
            {arrival}
            pick = pc.select_gpu(self.st.policy, self.T, vi)
            self.cur.add_(1)
        def departure(self):
            self.cur.add_(1)
        def step_end(self, consolidate):
            self.cur.add_(1)
        def op(self, key):
            self._ops[key] = key        # host dispatch: not captured
    class DecisionStep:
        def __call__(self, state):
            return state["vmrow"].cpu().numpy()   # host work, no graph
"""
PC_SRC = """
    import torch
    from functools import lru_cache
    def select_gpu(policy, T, vi):
        {select}
        return _table(policy)
    @lru_cache(maxsize=None)
    def _table(policy):
        print("built once, before the capture")
        return policy
"""


@pytest.mark.parametrize("arrival,select,want", [
    ("n = int(vi)", "pass", ["host-sync:int()"]),
    ("v = vi.item()", "pass", ["host-sync:.item"]),
    ("print(vi)", "pass", ["host-io:print"]),
    ("t = time.perf_counter()", "pass", ["host-io:time.perf_counter"]),
    ("self.count += 1", "pass", ["py-mutation:.count"]),
    ("self.log.append(vi)", "pass", ["py-mutation:.append"]),
    ("ok = vi > 0\nx = self.free[ok]", "pass",
     ["host-sync:bool-mask-index"]),
    ("pass", "i = torch.nonzero(T.fits)", ["host-sync:nonzero"]),
    ("pass", "u = torch.unique(vi)", ["host-sync:unique"]),
    ("pass", "m = vi.masked_select(vi > 0)", ["host-sync:.masked_select"]),
    ("pass", "STATE['n'] = 1", ["py-mutation:STATE"]),
    # Clean twins: device operations only; a local list; a host int.
    ("row = [vi]\nrow.append(vi)", "x = torch.where(vi > 0, vi, -1)", []),
    ("pass", "w = int(T.shape[0])", []),
])
def test_capture_purity(arrival, select, want):
    step = sf(STEP_SRC, arrival=arrival)
    pc = sf("STATE = dict()\n" + textwrap.dedent(PC_SRC),
            rel=f"{PKG}/core/policy_core.py", select=select)
    assert codes(check_capture_purity([step, pc])) == want


@pytest.mark.parametrize("key", [
    "capture-purity|src/repro_torch/kernels/mask_scores.py|mcc_pick|"
    "py-mutation:LAUNCHES",
    "capture-purity|src/repro_torch/kernels/mask_scores.py|ecc_pick|"
    "py-mutation:LAUNCHES",
    "capture-purity|src/repro_torch/core/policy_core.py|consolidation_plan|"
    "host-sync:.cpu",
])
def test_capture_purity_sanctioned_exemptions_are_pinned(key):
    """The pick wrappers' LAUNCHES count and GRMU's consolidation plan are
    in the captured step's scope, flagged by the rule, and pinned in the
    ratchet with a reason."""
    files = iter_source_files(REPO, cli.SCAN_DIRS)
    got = {R.key_to_str(v.key) for v in run_rules(files, ["capture-purity"])}
    assert key in got
    entry = R.load_ratchet(REPO / PKG / "lint" / "ratchet.json")[
        R.str_to_key(key)]
    assert entry["count"] == 1 and len(entry["reason"]) > 40


# ---------------------------------------------------------------------------
# Ratchet semantics, the repo clean
# ---------------------------------------------------------------------------

def _one_violation():
    return check_backend_purity([sf("""
        import numpy as np
        def f(xp, a):
            return np.abs(a)
    """, rel=f"{PKG}/core/policy_core_np.py")])


def test_ratchet_blocks_new_allows_grandfathered():
    v = _one_violation()
    errors, _ = R.compare(v, {})
    assert len(errors) == 1 and "(new)" in errors[0]
    entries = {v[0].key: {"count": 1, "reason": "test"}}
    assert R.compare(v, entries) == ([], [])
    errors, _ = R.compare(v + v, entries)
    assert len(errors) == 1 and "grew" in errors[0]


def test_ratchet_reports_slack():
    v = _one_violation()
    entries = {v[0].key: {"count": 2, "reason": "test"},
               ("x", "y", "z", "w"): {"count": 1, "reason": "gone"}}
    errors, notes = R.compare(v, entries)
    assert errors == []
    assert any("shrank" in n for n in notes)
    assert any("no longer occurs" in n for n in notes)


def test_ratchet_roundtrip(tmp_path):
    v = _one_violation()
    p = tmp_path / "ratchet.json"
    R.save_ratchet(p, R.updated_entries(v, {}))
    assert R.compare(v, R.load_ratchet(p))[0] == []


def test_repo_clean_under_its_ratchet_with_reasons():
    files = iter_source_files(REPO, cli.SCAN_DIRS)
    violations = run_rules(files)
    entries = R.load_ratchet(REPO / PKG / "lint" / "ratchet.json")
    errors, notes = R.compare(violations, entries)
    assert errors == [], "\n".join(errors)
    assert notes == [], "\n".join(notes)      # the counts are tight
    for key, entry in entries.items():
        assert entry["reason"] and not entry["reason"].startswith("TODO"), key
    # Every rule ran over its files; backend-purity found nothing.
    assert run_rules(files, ["backend-purity"]) == []


# ---------------------------------------------------------------------------
# Graph gate
# ---------------------------------------------------------------------------

def test_mixed_fixture_is_the_jax_gates():
    from tools.lint.jaxpr_gate import mixed_fixture as jax_fixture
    got, want = G.mixed_fixture(), jax_fixture()
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "models":
            assert [m.name for m in a] == [m.name for m in b]
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    kern = G.kernel_fixture()
    assert [m.name for m in kern.models] == ["A100-40GB"]
    np.testing.assert_array_equal(kern.kind, got.kind)


@pytest.fixture(scope="module")
def cli_report(tmp_path_factory):
    """``python -m repro_torch.lint --device cpu`` once, with its report."""
    path = tmp_path_factory.mktemp("lint") / "report.json"
    rc = cli.main(["--device", "cpu", "--report", str(path)])
    return rc, json.loads(path.read_text())


def test_cli_passes_on_the_repo(cli_report):
    rc, report = cli_report
    assert rc == 0, report["ast"]["errors"] + report["graph"]["errors"]
    assert report["graph"]["errors"] == []
    assert sorted(report["graph"]["fingerprints"]) == sorted(G.entries())
    assert len(G.entries()) == 17


@pytest.mark.parametrize("entry", G.entries())
def test_gate_entry_passes(cli_report, entry):
    """Every policy x variant: fingerprints match the baselines, and each
    key of the plan was recorded; a key of several events was checked for
    invariance over all of them."""
    _, report = cli_report
    keys = report["graph"]["fingerprints"][entry]
    base = json.loads((REPO / PKG / "lint" / "baselines.json").read_text())
    assert keys.keys() == base["entries"][entry].keys()
    assert all(k["events"] >= 1 for k in keys.values())
    assert any(k["events"] >= 2 for k in keys.values())
    assert not [e for e in report["graph"]["errors"] if e.startswith(entry)]


def test_cli_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([])


@pytest.fixture
def fresh_runners():
    """Runners built anew: a cached runner's step keeps the methods it was
    built with, so an injected method needs a fresh one (and must not stay
    in the cache for later tests)."""
    compile_cache.clear_cache()
    yield
    compile_cache.clear_cache()


def _gate_errors(names=("FF:plain",), **kw):
    errors, _, _ = G.run_gate("cpu", names=list(names), **kw)
    return errors


def test_gate_catches_injected_float64(monkeypatch, fresh_runners):
    orig = B.Step.departure

    def departure(self):
        orig(self)
        self.zero_f.double()
    monkeypatch.setattr(B.Step, "departure", departure)
    errors = _gate_errors()
    assert any("departure" in e and "torch.float64" in e for e in errors)


def test_gate_catches_injected_item(monkeypatch, fresh_runners):
    orig = B.Step.step_end

    def step_end(self, consolidate):
        orig(self, consolidate)
        self.cur.item()
    monkeypatch.setattr(B.Step, "step_end", step_end)
    errors = _gate_errors()
    assert any("step_end" in e and "_local_scalar_dense" in e
               for e in errors)


def test_gate_catches_event_dependent_constant(monkeypatch, fresh_runners):
    """A Python value that changes per event is baked into a graph at
    capture; key invariance sees it as another argument."""
    orig = B.Step.arrival
    seen = []

    def arrival(self, p, prof0, heavy):
        orig(self, p, prof0, heavy)
        seen.append(p)
        self.zero_f.add(len(seen))
    monkeypatch.setattr(B.Step, "arrival", arrival)
    errors = _gate_errors()
    assert any("arrival" in e and "event 1 dispatches other" in e
               for e in errors)


def test_gate_catches_fingerprint_drift(tmp_path):
    base = json.loads((REPO / PKG / "lint" / "baselines.json").read_text())
    base["entries"]["FF:plain"]["departure"]["ops"]["aten.add.Tensor"] += 1
    p = tmp_path / "baselines.json"
    p.write_text(json.dumps(base))
    errors = _gate_errors(baselines_path=p)
    assert any("FF:plain departure: fingerprint mismatch" in e
               for e in errors)
    # Under another torch version the drift is a note, not an error.
    base["torch_version"] = "0.0"
    p.write_text(json.dumps(base))
    errors, notes, _ = G.run_gate("cpu", names=["FF:plain"],
                                  baselines_path=p)
    assert errors == [] and any("fingerprint mismatch" in n for n in notes)
