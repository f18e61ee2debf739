"""Layer 1 of the port's repro-lint: AST rules over the port's sources.

The port replays each event key through a CUDA graph captured once
(``core/batched.py``: ``Step`` run by a ``Runner`` from the replay compile
cache), so its decision-invariance contract is JAX's recast for capture.
Five rules, each the port's form of one of ``tools/lint/ast_rules.py``:

``backend-purity`` (JAX's, unchanged in meaning)
    In the ``xp``-parameterized copies (``BACKEND_AGNOSTIC_MODULES``), no
    bare ``np.`` inside a function that takes ``xp``.

``dtype-discipline``
    In ``core`` and ``kernels`` (``ENGINE_DIRS``): (a) arithmetic on a
    packed trace field (uint8 ``kind``, int16 ``profile`` / ``vm_pids`` /
    ``arr_pids``, from ``batched.trace_arrays``) without a widening first
    (``.astype`` / ``.to`` / ``.long`` / ``.int`` / ``.view``); the
    trace's device tensors (``Trace.dev``, widened by
    ``trace_from_numpy``) are not packed; (b) any literal 64-bit dtype:
    ``np.float64`` / ``np.int64`` / ``torch.float64`` / ``torch.double`` /
    ``torch.int64`` / ``torch.long`` / ``complex128`` ..., or a string
    spelling of one passed to a call.  Deliberate uses are ratcheted,
    each with its reason.

``capture-hazard`` (JAX's ``recompile-hazard``)
    A CUDA graph built outside ``batched.Runner._capture`` (a graph the
    replay compile cache does not hold); a native library loaded
    (``ctypes.CDLL``, ``torch.utils.cpp_extension.load*``) or ``nvcc``
    started outside ``kernels/_build.build_all``; ``torch.compile``
    anywhere scanned; a mutable literal or a non-frozen dataclass in a
    compile-cache key (``cached_replay_fn``'s key, ``replay_key``'s
    variant and result).

``buffer-safety`` (JAX's ``donation-safety``)
    A graph replay overwrites the runner's static buffers in place
    (``Runner.state``, the step's event rows, cursor, caps and resident
    tensors), so a tensor taken out of them that leaves (returned,
    yielded, stored in an attribute or a container) without ``.clone()``
    or a copy reads later events.  ``Runner.finish`` is the clean form.

``capture-purity`` (JAX's ``callback-purity``)
    In what a captured graph runs: the methods of ``batched.Step`` that
    an event key runs (``arrival``, ``departure``, ``step_end`` and what
    they call, through ``policy_core``, ``sharded``, ``obs/inscan`` and
    the kernel wrappers), a host synchronisation (``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()`` / ``float()`` /
    ``bool()`` of a tensor, ``nonzero``, ``masked_select``, boolean-mask
    indexing, ``unique``), host I/O (``print``, ``time.*``, ``logging``)
    or a mutation of Python state.  Each runs once at capture and never
    on a replay.  A function cached with ``lru_cache`` runs once, before
    the capture (the runner's warm-up), and is not followed.

Every rule is a pure function ``(files) -> [Violation]`` over parsed
:class:`~repro_torch.lint.common.SourceFile` objects, so tests run them
on snippets verbatim.
"""
from __future__ import annotations

import ast
import posixpath
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .common import (SourceFile, Violation, ancestors, attach_parents,
                     dotted_name, enclosing_functions, module_aliases,
                     scope_of)

PKG = "src/repro_torch"

# Modules whose array code must stay parameterized over ``xp``: the
# port's verbatim copies of the JAX package's generic modules.
BACKEND_AGNOSTIC_MODULES = (f"{PKG}/core/policy_core_np.py",
                            f"{PKG}/obs/reasons.py")

# Sources covered by dtype-discipline, capture-hazard and buffer-safety.
ENGINE_DIRS = (f"{PKG}/core", f"{PKG}/kernels")

BATCHED = f"{PKG}/core/batched.py"
BUILD = f"{PKG}/kernels/_build.py"

# The one place a graph is built, and the one place a library is loaded
# or nvcc runs: (path, scope).
GRAPH_HOME = (BATCHED, "Runner._capture")
BUILD_HOME = (BUILD, "build_all")

# Packed (sub-int32) trace fields: any arithmetic on these must widen.
PACKED_FIELDS = frozenset({"kind", "profile", "vm_pids", "arr_pids"})
_WIDENING = frozenset({"astype", "view", "to", "long", "int"})

# 64-bit dtypes by namespace, and their string spellings.
WIDE_DTYPES = {
    "np": frozenset({"int64", "uint64", "float64", "complex128", "double",
                     "longlong", "ulonglong", "cdouble"}),
    "torch": frozenset({"int64", "uint64", "float64", "complex128", "double",
                        "long", "cdouble"}),
}
WIDE_STRINGS = frozenset({"int64", "uint64", "float64", "complex128",
                          "double"})

_NS_TARGETS = {"numpy": "np", "torch": "torch"}

# The capture-purity roots: the Step methods an event key runs.
CAPTURE_ROOTS = ((BATCHED, "Step", "arrival"), (BATCHED, "Step", "departure"),
                 (BATCHED, "Step", "step_end"))

# The runner's static buffers: attributes of a Runner (``state``) or of
# its Step (the rest, and ``state``).
RUNNER_BUFFERS = frozenset({"state"})
STEP_BUFFERS = frozenset({"state", "ev_arg", "ev_time", "cur", "caps",
                          "dev"})


def _under(rel_path: str, dirs: Sequence[str]) -> bool:
    return any(rel_path == d or rel_path.startswith(d + "/") for d in dirs)


def in_engine_dirs(rel_path: str) -> bool:
    return _under(rel_path, ENGINE_DIRS)


def _xp_scoped(node: ast.AST) -> bool:
    """Is ``node`` (transitively) inside a function taking ``xp``?"""
    for fn in enclosing_functions(node):
        args = fn.args
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        if "xp" in names:
            return True
    return False


def _flag(out: List[Violation], rule: str, sf: SourceFile, node: ast.AST,
          code: str, msg: str) -> None:
    out.append(Violation(rule=rule, path=sf.rel_path, line=node.lineno,
                         scope=scope_of(node), code=code, message=msg))


# ---------------------------------------------------------------------------
# backend-purity
# ---------------------------------------------------------------------------

def check_backend_purity(files: Sequence[SourceFile]) -> List[Violation]:
    out: List[Violation] = []
    for sf in files:
        aliases = module_aliases(sf.tree, {"numpy": "np",
                                           "jax.numpy": "jnp"})
        if not aliases:
            continue
        attach_parents(sf.tree)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases and _xp_scoped(node)):
                continue
            canon = aliases[node.value.id]
            _flag(out, "backend-purity", sf, node, f"{canon}.{node.attr}",
                  f"bare `{node.value.id}.{node.attr}` inside an "
                  "`xp`-parameterized function — route every array op "
                  "through `xp` (host-side staging belongs in an xp-free "
                  "helper)")
    return out


# ---------------------------------------------------------------------------
# dtype-discipline
# ---------------------------------------------------------------------------

def _device_names(tree: ast.Module) -> Set[str]:
    """Names bound to a trace's device tensors (``d = trace.dev``,
    ``d = self.dev``) and parameters named ``dev``: their fields were
    widened by ``trace_from_numpy``."""
    out = {"dev"}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "dev"):
            out.add(node.targets[0].id)
    return out


def _is_device_ref(node: ast.AST, dev_names: Set[str]) -> bool:
    return ((isinstance(node, ast.Name) and node.id in dev_names)
            or (isinstance(node, ast.Attribute) and node.attr == "dev"))


def _packed_field_of(node: ast.AST, packed_names: Dict[str, str],
                     dev_names: Set[str]) -> Optional[str]:
    """The packed trace field a reference resolves to, or None:
    ``tr["kind"]``-style gathers, ``events.kind``-style attributes, names
    assigned from either, and subscripts of those; a gather from the
    device tensors is not packed."""
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Constant) and sl.value in PACKED_FIELDS:
            return None if _is_device_ref(node.value, dev_names) else sl.value
        return _packed_field_of(node.value, packed_names, dev_names)
    if isinstance(node, ast.Attribute) and node.attr in PACKED_FIELDS:
        return node.attr
    if isinstance(node, ast.Name):
        return packed_names.get(node.id)
    return None


def _collect_packed_names(tree: ast.Module,
                          dev_names: Set[str]) -> Dict[str, str]:
    """One-level dataflow: ``vmp = tr["vm_pids"]`` (tuple assigns too)
    makes ``vmp`` a packed name."""
    packed: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple) \
                and len(tgt.elts) == len(val.elts):
            pairs = list(zip(tgt.elts, val.elts))
        else:
            pairs = [(tgt, val)]
        for t, v in pairs:
            if isinstance(t, ast.Name):
                field = _packed_field_of(v, {}, dev_names)
                if field:
                    packed[t.id] = field
    return packed


def _is_widened(node: ast.AST) -> bool:
    parent = getattr(node, "_lint_parent", None)
    return isinstance(parent, ast.Attribute) and parent.attr in _WIDENING


def check_dtype_discipline(files: Sequence[SourceFile]) -> List[Violation]:
    out: List[Violation] = []
    for sf in files:
        aliases = module_aliases(sf.tree, _NS_TARGETS)
        attach_parents(sf.tree)
        dev_names = _device_names(sf.tree)
        packed_names = _collect_packed_names(sf.tree, dev_names)
        for node in ast.walk(sf.tree):
            # (b) literal 64-bit dtypes.
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases
                    and node.attr in WIDE_DTYPES[aliases[node.value.id]]):
                canon = aliases[node.value.id]
                _flag(out, "dtype-discipline", sf, node,
                      f"{canon}.{node.attr}",
                      f"literal 64-bit dtype `{node.value.id}.{node.attr}` "
                      "— decision state is 32-bit by contract and float64 "
                      "breaks the replay's bit-exactness against JAX "
                      "(ratchet deliberate uses, with a reason)")
            elif (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value in WIDE_STRINGS
                    and isinstance(getattr(node, "_lint_parent", None),
                                   (ast.Call, ast.keyword))):
                _flag(out, "dtype-discipline", sf, node,
                      f"dtype-str:{node.value}",
                      f'string dtype "{node.value}" passed to a call')
            # (a) un-widened arithmetic on packed trace fields.
            operands: Iterable[ast.AST] = ()
            if isinstance(node, ast.BinOp):
                operands = (node.left, node.right)
            elif isinstance(node, ast.UnaryOp) \
                    and isinstance(node.op, (ast.USub, ast.Invert)):
                operands = (node.operand,)
            elif isinstance(node, ast.AugAssign):
                operands = (node.target, node.value)
            for op in operands:
                field = _packed_field_of(op, packed_names, dev_names)
                if field and not _is_widened(op):
                    _flag(out, "dtype-discipline", sf, op,
                          f"packed-arith:{field}",
                          f"arithmetic on packed trace field `{field}` "
                          "without a widening first — packed dtypes "
                          "overflow and promote silently")
    return out


# ---------------------------------------------------------------------------
# capture-hazard
# ---------------------------------------------------------------------------

def _dataclass_registry(files: Sequence[SourceFile]) -> Dict[str, bool]:
    """{class name: frozen?} for every @dataclass in the file set."""
    reg: Dict[str, bool] = {}
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if (dotted_name(target) or "").split(".")[-1] != "dataclass":
                    continue
                reg[node.name] = isinstance(dec, ast.Call) and any(
                    kw.arg == "frozen" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in dec.keywords)
    return reg


def _annotation_of(name: str, node: ast.AST) -> Optional[str]:
    """``name``'s parameter annotation in the enclosing functions (its
    last dotted part), or None."""
    for fn in enclosing_functions(node):
        if isinstance(fn, ast.Lambda):
            continue
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
            if a.arg == name and a.annotation is not None:
                ann = dotted_name(a.annotation)
                if ann:
                    return ann.split(".")[-1]
                if isinstance(a.annotation, ast.Constant):
                    return str(a.annotation.value).split(".")[-1]
    return None


def _mutable_literal(node: ast.AST) -> Optional[ast.AST]:
    for n in ast.walk(node):
        if isinstance(n, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
            return n
    return None


def _mentions_nvcc(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "nvcc" in n.value:
            return True
        if isinstance(n, ast.Name) and "nvcc" in n.id:
            return True
        if isinstance(n, ast.Attribute) and "nvcc" in n.attr:
            return True
    return False


def _assigned_in(fn: Optional[ast.AST], name: str) -> List[ast.AST]:
    if fn is None:
        return []
    return [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == name
                    for t in n.targets)]


_SUBPROCESS = frozenset({"subprocess.Popen", "subprocess.run",
                         "subprocess.call", "subprocess.check_call",
                         "subprocess.check_output", "os.system", "os.popen"})


def _is_graph_ctor(name: str) -> bool:
    last = name.split(".")[-1]
    return (last in ("CUDAGraph", "make_graphed_callables")
            or name.endswith("cuda.graph"))


def _is_native_load(name: str) -> bool:
    last = name.split(".")[-1]
    return (last == "CDLL" or name.endswith("cdll.LoadLibrary")
            or "cpp_extension" in name or last == "load_inline")


def check_capture_hazard(files: Sequence[SourceFile]) -> List[Violation]:
    out: List[Violation] = []
    frozen = _dataclass_registry(files)
    for sf in files:
        attach_parents(sf.tree)

        def flag(node, code, msg):
            _flag(out, "capture-hazard", sf, node, code, msg)

        def check_key_part(arg: ast.AST, node: ast.AST, where: str) -> None:
            lit = _mutable_literal(arg)
            if lit is not None:
                flag(node, f"mutable-{where}",
                     f"mutable literal in a {where} — compile-cache keys "
                     "must be hashable and fixed")
                return
            if isinstance(arg, ast.Name):
                ann = _annotation_of(arg.id, node)
                if ann in frozen and not frozen[ann]:
                    flag(node, f"unhashable-{where}:{ann}",
                         f"`{arg.id}` is a non-frozen dataclass `{ann}` in a "
                         f"{where} — declare it @dataclass(frozen=True)")

        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if (dotted_name(target) or "").endswith("torch.compile"):
                        flag(dec, "torch.compile",
                             "`torch.compile` in the replay's sources — the "
                             "replay runs hand-written kernels and captured "
                             "graphs only")
                if node.name == "replay_key":
                    for ret in ast.walk(node):
                        if isinstance(ret, ast.Return) and ret.value is not None:
                            elts = (ret.value.elts if isinstance(
                                ret.value, ast.Tuple) else [ret.value])
                            for e in elts:
                                check_key_part(e, ret, "cache-key")
                continue
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            scope = (sf.rel_path, scope_of(node))
            if name.endswith("cached_replay_fn") and node.args:
                key = node.args[0]
                if not (isinstance(key, ast.Call) and (dotted_name(
                        key.func) or "").endswith("replay_key")):
                    check_key_part(key, node, "cache-key")
            elif name.endswith("replay_key"):
                for arg in node.args[3:]:
                    check_key_part(arg.value if isinstance(arg, ast.Starred)
                               else arg, node,
                                   "cache-key")
            elif _is_graph_ctor(name) and scope != GRAPH_HOME:
                flag(node, "graph-outside-cache",
                     f"`{name}` outside batched.Runner._capture — a graph "
                     "the replay compile cache does not hold (capture "
                     "through a Runner)")
            elif _is_native_load(name) and scope != BUILD_HOME:
                flag(node, f"native-load:{name.split('.')[-1]}",
                     f"`{name}` outside kernels/_build.build_all — load "
                     "libraries through _build.load")
            elif name.endswith("torch.compile"):
                flag(node, "torch.compile",
                     "`torch.compile` in the replay's sources — the replay "
                     "runs hand-written kernels and captured graphs only")
            elif name in _SUBPROCESS and scope != BUILD_HOME:
                fns = [f for f in enclosing_functions(node)
                       if not isinstance(f, ast.Lambda)]
                args = list(node.args) + [k.value for k in node.keywords]
                via = [v for a in args if isinstance(a, ast.Name)
                       for v in _assigned_in(fns[0] if fns else None, a.id)]
                if any(_mentions_nvcc(a) for a in args + via):
                    flag(node, "nvcc-subprocess",
                         "nvcc started outside kernels/_build.build_all")
    return out


# ---------------------------------------------------------------------------
# buffer-safety
# ---------------------------------------------------------------------------

# Methods whose result may share the receiver's storage (any other
# method's result is a copy or a fresh tensor).
_ALIAS_METHODS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "flatten", "squeeze",
    "unsqueeze", "t", "transpose", "permute", "expand", "expand_as",
    "narrow", "select", "split", "chunk", "unbind", "unflatten",
    "as_strided", "detach", "contiguous", "to", "type", "float", "double",
    "long", "int", "bool", "half", "cpu", "cuda", "numpy", "items",
    "values", "get", "copy_", "data_ptr", "__getitem__"})
_COPY_FUNCS = frozenset({"torch.clone", "np.array", "np.copy", "numpy.array",
                         "numpy.copy", "copy.deepcopy", "copy.copy"})
# torch functions whose result may be a view of an argument.
_TORCH_VIEWS = frozenset({
    "as_tensor", "asarray", "from_numpy", "narrow", "select", "split",
    "chunk", "unbind", "squeeze", "unsqueeze", "reshape", "flatten", "t",
    "transpose", "permute", "movedim", "detach", "view_as_real",
    "view_as_complex", "broadcast_to", "diagonal", "tensor_split"})
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda"})


def _is_runner_ref(node: ast.AST, in_runner: bool) -> bool:
    """``self`` inside class Runner, or any ``...runner`` reference."""
    if isinstance(node, ast.Name) and node.id == "self":
        return in_runner
    name = dotted_name(node) or ""
    return name.split(".")[-1] == "runner"


def _in_class(node: ast.AST, name: str) -> bool:
    return any(isinstance(a, ast.ClassDef) and a.name == name
               for a in ancestors(node))


def _buffer_reads(fn: ast.AST, in_runner: bool) -> List[ast.AST]:
    """The static-buffer reads in ``fn``: ``<runner>.state`` and
    ``<runner>.step.<buffer>``, also through a name bound to
    ``<runner>.step``."""
    steps: Set[str] = set()
    for n in ast.walk(fn):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Attribute)
                and n.value.attr == "step"
                and _is_runner_ref(n.value.value, in_runner)):
            steps.add(n.targets[0].id)
    reads = []
    for n in ast.walk(fn):
        if not (isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load)):
            continue
        base = n.value
        if n.attr in RUNNER_BUFFERS and _is_runner_ref(base, in_runner):
            reads.append(n)
        elif n.attr in STEP_BUFFERS and (
                (isinstance(base, ast.Name) and base.id in steps)
                or (isinstance(base, ast.Attribute) and base.attr == "step"
                    and _is_runner_ref(base.value, in_runner))):
            reads.append(n)
    return reads


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _names_bound(target: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


def _climb(node: ast.AST, stop: Optional[ast.AST] = None
           ) -> Optional[ast.AST]:
    """From a value that may share a static buffer's storage, climb the
    expressions whose value may still share it; the topmost such node
    (``stop`` at the latest), or None where a copy or a fresh result cuts
    the chain."""
    while True:
        parent = getattr(node, "_lint_parent", None)
        if parent is None or node is stop:
            return node
        if isinstance(parent, ast.Subscript) and parent.value is node:
            node = parent
        elif isinstance(parent, ast.Attribute) and parent.value is node:
            if parent.attr in _META_ATTRS:
                return None
            call = getattr(parent, "_lint_parent", None)
            if isinstance(call, ast.Call) and call.func is parent:
                if parent.attr not in _ALIAS_METHODS:
                    return None      # a copy, or a fresh tensor (sum, eq)
                node = call
            else:
                node = parent
        elif isinstance(parent, ast.Call) and parent.func is not node:
            name = dotted_name(parent.func) or ""
            if isinstance(parent.func, ast.Attribute) and \
                    parent.func.attr == "copy_":
                return None          # copied into another tensor
            if name in _COPY_FUNCS or (
                    name.startswith("torch.")
                    and name.split(".")[-1] not in _TORCH_VIEWS):
                return None
            node = parent            # an unknown call: may alias
        elif isinstance(parent, (ast.Tuple, ast.List, ast.Dict, ast.Set,
                                 ast.Starred, ast.IfExp, ast.keyword,
                                 ast.NamedExpr)):
            node = parent
        elif isinstance(parent, ast.comprehension) and node is parent.iter:
            comp = parent._lint_parent
            names = set(_names_bound(parent.target))
            # A dict's keys are its names, not tensors: its values alias.
            parts = [comp.value if isinstance(comp, ast.DictComp)
                     else comp.elt]
            if not any(_climb(n, part) is part for part in parts
                       for n in ast.walk(part)
                       if isinstance(n, ast.Name) and n.id in names):
                return None
            node = comp
        elif isinstance(parent, (ast.BinOp, ast.UnaryOp, ast.Compare,
                                 ast.BoolOp)):
            return None
        else:
            return node


def _escape(node: ast.AST, fn: ast.AST, depth: int = 0,
            in_runner: bool = False) -> Optional[ast.AST]:
    """Where a value that may share a static buffer's storage leaves the
    function (the statement returning, yielding or storing it), or None.
    Names bound to it are followed two levels deep."""
    top = _climb(node)
    if top is None:
        return None
    stmt = getattr(top, "_lint_parent", None)
    if isinstance(stmt, (ast.Return, ast.Yield, ast.YieldFrom)):
        return stmt
    names: Set[str] = set()
    after: ast.AST = stmt
    if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and \
            top is stmt.value:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        if any(isinstance(t, (ast.Attribute, ast.Subscript))
               and not (in_runner and _root_name(t) == "self")
               for t in targets):
            return stmt              # stored outside the runner
        names = {n for t in targets for n in _names_bound(t)}
    elif isinstance(stmt, ast.For) and top is stmt.iter:
        names = set(_names_bound(stmt.target))
    if not names or depth >= 2:
        return None
    for n in ast.walk(fn):
        if (isinstance(n, ast.Name) and n.id in names
                and isinstance(n.ctx, ast.Load)
                and (n.lineno, n.col_offset) > (after.lineno,
                                                after.col_offset)):
            hit = _escape(n, fn, depth + 1, in_runner)
            if hit is not None:
                return hit
    return None


def check_buffer_safety(files: Sequence[SourceFile]) -> List[Violation]:
    out: List[Violation] = []
    for sf in files:
        attach_parents(sf.tree)
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if _in_class(fn, "Step"):
                continue             # the step's own reads stay inside it
            in_runner = _in_class(fn, "Runner")
            for read in _buffer_reads(fn, in_runner):
                if enclosing_functions(read)[0] is not fn:
                    continue         # judged in its own (nested) function
                hit = _escape(read, fn, in_runner=in_runner)
                if hit is None:
                    continue
                what = dotted_name(read) or read.attr
                _flag(out, "buffer-safety", sf, hit,
                      f"static-buffer-escape:{read.attr}",
                      f"`{what}` leaves the runner (line {hit.lineno}) "
                      "without .clone() or a copy — the next graph replay "
                      "overwrites it in place")
    return out


# ---------------------------------------------------------------------------
# capture-purity
# ---------------------------------------------------------------------------

_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero",
                           "masked_select", "unique", "unique_consecutive",
                           "argwhere"})
_SYNC_FUNCS = frozenset({"nonzero", "masked_select", "unique",
                         "unique_consecutive", "argwhere"})
_HOST_SCALAR_ANN = frozenset({"int", "float", "bool", "str"})
_CONTAINER_MUTATORS = frozenset({"append", "extend", "insert", "update",
                                 "setdefault", "pop", "popitem", "clear",
                                 "add", "discard", "remove"})
_CACHE_DECORATORS = frozenset({"lru_cache", "cache"})


class _Index:
    """Functions and classes of the scanned files, and each file's
    imports of the others, for the capture-purity call graph."""

    def __init__(self, files: Sequence[SourceFile]):
        self.files = {sf.rel_path: sf for sf in files}
        self.funcs: Dict[str, Dict[str, ast.AST]] = {}
        self.classes: Dict[str, Dict[str, Dict[str, ast.AST]]] = {}
        self.globals: Dict[str, Set[str]] = {}
        for sf in files:
            attach_parents(sf.tree)
            fs, cs, gs = {}, {}, set()
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fs[node.name] = node
                elif isinstance(node, ast.ClassDef):
                    cs[node.name] = {m.name: m for m in node.body if isinstance(
                        m, (ast.FunctionDef, ast.AsyncFunctionDef))}
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    ts = (node.targets if isinstance(node, ast.Assign)
                          else [node.target])
                    gs.update(n for t in ts for n in _names_bound(t))
            self.funcs[sf.rel_path] = fs
            self.classes[sf.rel_path] = cs
            self.globals[sf.rel_path] = gs
        self.modules = {p: self._imports(self.files[p]) for p in self.files}

    def _imports(self, sf: SourceFile):
        """{local name: module path} and {local name: (path, function)}."""
        mods: Dict[str, str] = {}
        fns: Dict[str, Tuple[str, str]] = {}
        here = posixpath.dirname(sf.rel_path)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ImportFrom) or not node.level:
                continue
            base = here
            for _ in range(node.level - 1):
                base = posixpath.dirname(base)
            if node.module:
                base = posixpath.join(base, *node.module.split("."))
            for a in node.names:
                local = a.asname or a.name
                as_mod = posixpath.join(base, a.name) + ".py"
                if as_mod in self.files:
                    mods[local] = as_mod
                elif base + ".py" in self.files:
                    fns[local] = (base + ".py", a.name)
        return mods, fns

    def resolve(self, path: str, cls: Optional[str], call: ast.Call):
        """(path, class or None, function node) a call reaches, or None."""
        f = call.func
        mods, fns = self.modules[path]
        if isinstance(f, ast.Name):
            if f.id in self.funcs[path]:
                return path, None, self.funcs[path][f.id]
            if f.id in fns:
                p, name = fns[f.id]
                node = self.funcs.get(p, {}).get(name)
                return (p, None, node) if node is not None else None
            return None
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                node = self.classes[path].get(cls, {}).get(f.attr)
                return (path, cls, node) if node is not None else None
            if base.id in mods:
                p = mods[base.id]
                node = self.funcs[p].get(f.attr)
                return (p, None, node) if node is not None else None
            ann = _annotation_of(base.id, call)
            for p, cs in self.classes.items():
                if ann in cs and f.attr in cs[ann]:
                    return p, ann, cs[ann][f.attr]
        return None


def _cached(fn: ast.AST) -> bool:
    return any((dotted_name(d.func if isinstance(d, ast.Call) else d)
                or "").split(".")[-1] in _CACHE_DECORATORS
               for d in fn.decorator_list)


def capture_scope(idx: _Index) -> List[Tuple[str, ast.AST]]:
    """(path, function) of everything an event key's operations run:
    ``CAPTURE_ROOTS`` and the functions they call in the indexed files,
    not following ``lru_cache``d functions."""
    todo = []
    for path, cls, name in CAPTURE_ROOTS:
        node = idx.classes.get(path, {}).get(cls, {}).get(name)
        if node is not None:
            todo.append((path, cls, node))
    seen: Dict[int, Tuple[str, ast.AST]] = {}
    while todo:
        path, cls, fn = todo.pop()
        if id(fn) in seen or _cached(fn):
            continue
        seen[id(fn)] = (path, fn)
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                hit = idx.resolve(path, cls, n)
                if hit is not None:
                    todo.append(hit)
    return sorted(seen.values(), key=lambda pf: (pf[0], pf[1].lineno))


def _host_scalar(arg: ast.AST, call: ast.AST) -> bool:
    """Is the argument of ``int()`` / ``float()`` / ``bool()`` plainly a
    host value (a constant, a shape, a length, a parameter annotated as a
    Python scalar)?"""
    if isinstance(arg, ast.Constant):
        return True
    if isinstance(arg, ast.Name):
        return _annotation_of(arg.id, call) in _HOST_SCALAR_ANN
    for n in ast.walk(arg):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim"):
            return True
        if isinstance(n, ast.Call) and (dotted_name(n.func) or "").split(
                ".")[-1] in ("len", "numel"):
            return True
    return False


def _mask_like(node: ast.AST, masks: Set[str]) -> bool:
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _mask_like(node.operand, masks) or isinstance(
            node.operand, ast.Name)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _mask_like(node.left, masks) or _mask_like(node.right, masks)
    return isinstance(node, ast.Name) and node.id in masks


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound inside ``fn`` (not its parameters)."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


def check_capture_purity(files: Sequence[SourceFile]) -> List[Violation]:
    out: List[Violation] = []
    idx = _Index(files)
    for path, fn in capture_scope(idx):
        sf = idx.files[path]
        gl = idx.globals[path]
        local = _local_names(fn)
        masks = {t.id for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 for t in n.targets if isinstance(t, ast.Name)
                 and _mask_like(n.value, set())}

        def flag(node, code, msg):
            _flag(out, "capture-purity", sf, node, code, msg)

        def mutation(target, node):
            if isinstance(target, ast.Attribute):
                flag(node, f"py-mutation:.{target.attr}",
                     f"assigns `{dotted_name(target) or target.attr}` — a "
                     "Python attribute set once at capture, never on a "
                     "replay")
            elif isinstance(target, ast.Subscript):
                base = target.value
                if isinstance(base, ast.Name) and base.id in gl:
                    flag(node, f"py-mutation:{base.id}",
                         f"mutates the module's `{base.id}` — runs once at "
                         "capture, never on a replay")
                elif isinstance(target.slice, ast.Constant) and isinstance(
                        target.slice.value, str):
                    flag(node, f"py-mutation:[{target.slice.value!r}]",
                         "stores into a Python dict — runs once at capture, "
                         "never on a replay")

        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func) or ""
                last = name.split(".")[-1]
                if name.startswith("torch.") and last in _SYNC_FUNCS:
                    flag(node, f"host-sync:{last}",
                         f"`{name}` — a data-dependent shape, a host "
                         "synchronisation")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SYNC_METHODS:
                    flag(node, f"host-sync:.{node.func.attr}",
                         f"`.{node.func.attr}()` in a captured step — a "
                         "host synchronisation: it runs once at capture "
                         "and its value is baked into the graph")
                elif name == "torch.where" and len(node.args) == 1:
                    flag(node, "host-sync:nonzero",
                         "one-argument `torch.where` is `nonzero`, a host "
                         "synchronisation")
                elif name in ("int", "float", "bool") and node.args and \
                        not _host_scalar(node.args[0], node):
                    flag(node, f"host-sync:{name}()",
                         f"`{name}()` of a device value in a captured step "
                         "— a host synchronisation, its value baked into "
                         "the graph")
                elif name == "print" or name.startswith(
                        ("time.", "logging.", "logger.")):
                    flag(node, f"host-io:{name}",
                         f"`{name}` in a captured step runs once at capture, "
                         "never on a replay")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _CONTAINER_MUTATORS:
                    recv = node.func.value
                    if not (isinstance(recv, ast.Name) and recv.id in local
                            and recv.id not in gl):
                        flag(node, f"py-mutation:.{node.func.attr}",
                             f"`{name}` mutates Python state outside the "
                             "step — it runs once at capture, never on a "
                             "replay")
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    _mask_like(node.slice, masks):
                flag(node, "host-sync:bool-mask-index",
                     "boolean-mask indexing — a data-dependent shape, a "
                     "host synchronisation")
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    mutation(t, node)
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                flag(node, "py-mutation:global",
                     "rebinds a global — runs once at capture, never on a "
                     "replay")
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

RULES = {
    "backend-purity": (check_backend_purity,
                       lambda p: p in BACKEND_AGNOSTIC_MODULES),
    "dtype-discipline": (check_dtype_discipline, in_engine_dirs),
    "capture-hazard": (check_capture_hazard, lambda p: _under(
        p, (f"{PKG}/core", f"{PKG}/kernels", f"{PKG}/obs"))),
    "buffer-safety": (check_buffer_safety, lambda p: _under(
        p, (f"{PKG}/core", f"{PKG}/kernels", f"{PKG}/obs"))),
    "capture-purity": (check_capture_purity, lambda p: _under(
        p, (f"{PKG}/core", f"{PKG}/kernels", f"{PKG}/obs"))),
}


def run_rules(files: Sequence[SourceFile],
              rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Run (a subset of) the AST rules, each over the files its path
    filter selects."""
    out: List[Violation] = []
    for name, (check, selects) in RULES.items():
        if rules is not None and name not in rules:
            continue
        out.extend(check([sf for sf in files if selects(sf.rel_path)]))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule, v.code))
