"""AST-based concurrency lint over the ``repro_torch`` source tree (a port
of ``repro.analysis.lint``).

Project-specific rules (each with a stable finding ID usable in the
baseline file and in ``# analysis: ignore[...]`` inline suppressions):

  * **R1 guarded-by** — a shared attribute declared with a
    ``# guarded-by: _lock`` trailing comment (or a class-level
    ``_guarded_by = {...}`` registry) may only be accessed inside a
    ``with self._lock:`` scope.  Methods whose name ends in ``_locked``
    are the documented caller-holds-the-lock convention and are
    skipped; ``__init__`` is skipped (the object is not yet shared);
    nested ``def``/``lambda`` bodies are skipped (deferred execution —
    their lock context is unknowable statically).  The write-only
    variant ``# guarded-by[writes]: _lock`` checks mutations only
    (stores, aug-assigns, subscript stores, mutating method calls) —
    for append-only instrumentation read after the threads join.  An
    attribute counts as a lock only when its assignment calls a lock
    factory (``threading.Lock()`` ... ``make_condition(...)``); a lock
    borrowed from another object needs such a call in its assignment.
  * **R2 cv-wait discipline** — every ``Condition.wait`` must sit
    inside a ``while`` loop (missed-wakeup / spurious-wakeup safety),
    and a numeric-literal timeout (``cv.wait(0.02)``) is flagged: the
    event-driven pipeline must never regress to polling grids.
    Computed deadlines (Algorithm 1) pass variables, not literals.
  * **R3 lock-order** — nested ``with``-acquisitions (plus one level of
    call-graph resolution through typed ``self.<attr>`` fields) build a
    module-spanning acquisition-order graph; a cycle is a static
    deadlock hazard.  The same graph merges with the runtime probe's
    observed edges in ``python -m repro_torch.analysis lockgraph``.
  * **R4 no time.sleep** — outside the simulated storage device
    (``store/store.py``) and the trace-replay inter-arrival gap
    (``serving/engine.py``), a ``time.sleep`` is a polling wait and is
    an error.

The reference's R5 (``jax.jit`` of a bound method sharing jax's global
jit cache) has nothing to check in a package that never calls
``jax.jit``, so it is left out and no rule takes its place.

Suppression: ``# analysis: ignore`` or ``# analysis: ignore[R1,R2]``
on the flagged line, or the finding's ID in the reviewed baseline file
(``src/repro_torch/analysis/baseline.txt``) with a one-line
justification.  Finding IDs, suppressions and the baseline format are
the reference's, so the two lints agree on shared sources.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = ("R1", "R2", "R3", "R4")

# file suffixes (posix, relative) where time.sleep models physical time
SLEEP_ALLOWED = ("store/store.py", "serving/engine.py")

# receiver attr/name must match one of these to count as a Condition
# for R2 when not resolvable from class assignments
_CV_NAME = re.compile(r"(^|_)(cv|cond|condition)$")

_GUARD_RE = re.compile(
    r"self\.(\w+)\b[^#]*#\s*guarded-by(\[writes\])?:\s*(\w+)")
_IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore(?:\[([\w,\s]+)\])?")

_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "move_to_end", "difference_update", "push", "sort",
}

_LOCK_FACTORIES = {"Lock", "RLock", "Condition",
                   "make_lock", "make_rlock", "make_condition"}
_CV_FACTORIES = {"Condition", "make_condition"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str               # posix-relative path (stable across checkouts)
    line: int
    scope: str              # "Class.method" | "Class" | "<module>"
    detail: str             # stable discriminator within the scope
    message: str

    @property
    def id(self) -> str:
        return f"{self.rule}:{self.path}:{self.scope}:{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.scope}] {self.message}\n    id: {self.id}")


# ---------------------------------------------------------------------------
# per-file model
# ---------------------------------------------------------------------------

class ClassInfo:
    def __init__(self, name: str):
        self.name = name
        self.lock_attrs: Set[str] = set()      # attrs holding locks/CVs
        self.cv_attrs: Set[str] = set()        # subset: condition variables
        self.guards: Dict[str, Tuple[str, str]] = {}  # attr->(guard, mode)
        self.attr_types: Dict[str, str] = {}   # attr -> class name (typed)


class FileModel:
    """One parsed source file + everything the rules need from it."""

    def __init__(self, source: str, relpath: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.classes: Dict[str, ClassInfo] = {}
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = self._class_info(node)

    # ------------------------------------------------------------ helpers
    def ignored(self, line: int, rule: str) -> bool:
        if not (1 <= line <= len(self.lines)):
            return False
        m = _IGNORE_RE.search(self.lines[line - 1])
        if not m:
            return False
        if m.group(1) is None:
            return True
        return rule in {r.strip() for r in m.group(1).split(",")}

    def _class_info(self, cdef: ast.ClassDef) -> ClassInfo:
        info = ClassInfo(cdef.name)
        # annotation-declared guards: scan the class's line range
        end = cdef.end_lineno or len(self.lines)
        for ln in range(cdef.lineno, end + 1):
            if ln > len(self.lines):
                break
            m = _GUARD_RE.search(self.lines[ln - 1])
            if m:
                mode = "writes" if m.group(2) else "all"
                info.guards[m.group(1)] = (m.group(3), mode)
        for node in ast.walk(cdef):
            # registry-declared guards: class-level _guarded_by dict
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "_guarded_by" \
                    and isinstance(node.value, ast.Dict):
                for k, v in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant) \
                            and isinstance(v, ast.Constant):
                        guard, _, mode = str(v.value).partition(":")
                        info.guards[str(k.value)] = (
                            guard, mode or "all")
            # self.<attr> = <... Lock()/Condition()/make_*() ...>
            tgt = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                tgt, val = node.target, node.value
            else:
                continue
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            calls = [n for n in ast.walk(val) if isinstance(n, ast.Call)]
            factory = None
            for c in calls:
                fname = c.func.attr if isinstance(c.func, ast.Attribute) \
                    else (c.func.id if isinstance(c.func, ast.Name)
                          else None)
                if fname in _LOCK_FACTORIES:
                    factory = fname
                    break
            if factory is not None:
                info.lock_attrs.add(tgt.attr)
                if factory in _CV_FACTORIES:
                    info.cv_attrs.add(tgt.attr)
                continue
            # typed attribute: self.cache = cache  (cache: WeightCache)
            if isinstance(val, ast.Name):
                ann = self._param_annotation(cdef, val.id)
                if ann:
                    info.attr_types[tgt.attr] = ann
            elif isinstance(val, ast.Call) \
                    and isinstance(val.func, ast.Name):
                info.attr_types[tgt.attr] = val.func.id
        return info

    @staticmethod
    def _param_annotation(cdef: ast.ClassDef, pname: str) -> Optional[str]:
        """Class name from an __init__ parameter annotation, unwrapping
        Optional[...] / quoted forms."""
        for node in cdef.body:
            if isinstance(node, ast.FunctionDef) and node.name == "__init__":
                for arg in (node.args.posonlyargs + node.args.args
                            + node.args.kwonlyargs):
                    if arg.arg == pname and arg.annotation is not None:
                        return _ann_class(arg.annotation)
        return None


def _ann_class(ann: ast.expr) -> Optional[str]:
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.split("[")[-1].rstrip("]").split(".")[-1]
        return name or None
    if isinstance(ann, ast.Subscript):          # Optional[X] / "X" forms
        return _ann_class(ann.slice)
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


# ---------------------------------------------------------------------------
# lock-order graph (R3) — shared with the CLI's `lockgraph`
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LockEdge:
    src: str                 # "Class._lock"
    dst: str
    where: str               # "path:line" provenance


def _with_lock_attr(item: ast.withitem) -> Optional[str]:
    e = item.context_expr
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "self":
        return e.attr
    return None


class _LockOrderVisitor(ast.NodeVisitor):
    """Collects (a) locks each method acquires directly and (b) nested
    acquisition edges, with one level of call resolution."""

    def __init__(self, model: FileModel, cls: ClassInfo,
                 method_locks: Dict[Tuple[str, str], Set[str]],
                 global_classes: Dict[str, ClassInfo]):
        self.model = model
        self.cls = cls
        self.method_locks = method_locks
        self.global_classes = global_classes
        self.edges: List[LockEdge] = []
        self._held: List[str] = []           # lock node names

    def node_name(self, attr: str) -> str:
        return f"{self.cls.name}.{attr}"

    def visit_With(self, node: ast.With):
        pushed = 0
        for item in node.items:
            attr = _with_lock_attr(item)
            if attr is not None and attr in self.cls.lock_attrs:
                lock = self.node_name(attr)
                for held in self._held:
                    if held != lock:
                        self.edges.append(LockEdge(
                            held, lock,
                            f"{self.model.relpath}:{node.lineno}"))
                self._held.append(lock)
                pushed += 1
        for child in node.body:
            self.visit(child)
        for _ in range(pushed):
            self._held.pop()

    def visit_Call(self, node: ast.Call):
        if self._held:
            for dst in self._callee_locks(node):
                for held in self._held:
                    if held != dst:
                        self.edges.append(LockEdge(
                            held, dst,
                            f"{self.model.relpath}:{node.lineno}"))
        self.generic_visit(node)

    def _callee_locks(self, node: ast.Call) -> Set[str]:
        f = node.func
        if not isinstance(f, ast.Attribute):
            return set()
        meth = f.attr
        base = f.value
        # self.<m>() -> same class
        if isinstance(base, ast.Name) and base.id == "self":
            return {f"{self.cls.name}.{a}" for a in
                    self.method_locks.get((self.cls.name, meth), ())}
        # self.<attr>.<m>() with a typed attr -> that class
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self":
            tname = self.cls.attr_types.get(base.attr)
            if tname:
                return {f"{tname}.{a}" for a in
                        self.method_locks.get((tname, meth), ())}
        return set()

    # deferred bodies: lock context at call time is unknown
    def visit_FunctionDef(self, node):        # nested def
        pass

    def visit_AsyncFunctionDef(self, node):
        pass

    def visit_Lambda(self, node):
        pass


def build_static_lockgraph(models: Sequence[FileModel]
                           ) -> Tuple[List[LockEdge], List[List[str]]]:
    """(edges, cycles) over every model's classes."""
    global_classes: Dict[str, ClassInfo] = {}
    for m in models:
        global_classes.update(m.classes)
    # pass 1: direct acquisitions per method
    method_locks: Dict[Tuple[str, str], Set[str]] = {}
    for m in models:
        for node in m.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            cls = m.classes[node.name]
            for fn in node.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                acquired = set()
                for w in ast.walk(fn):
                    if isinstance(w, ast.With):
                        for item in w.items:
                            attr = _with_lock_attr(item)
                            if attr in cls.lock_attrs:
                                acquired.add(attr)
                if acquired:
                    method_locks[(node.name, fn.name)] = acquired
    # pass 2: nested acquisitions
    edges: List[LockEdge] = []
    for m in models:
        for node in m.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            cls = m.classes[node.name]
            for fn in node.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                v = _LockOrderVisitor(m, cls, method_locks, global_classes)
                for child in fn.body:
                    v.visit(child)
                edges.extend(v.edges)
    return edges, find_cycles({(e.src, e.dst) for e in edges})


def find_cycles(edge_set: Set[Tuple[str, str]]) -> List[List[str]]:
    """Every elementary cycle's node list (rotated to its minimum node
    for a stable identity), via iterative DFS per SCC-free shortcut."""
    adj: Dict[str, List[str]] = {}
    for a, b in edge_set:
        adj.setdefault(a, []).append(b)
    cycles: List[List[str]] = []
    seen_ids: Set[Tuple[str, ...]] = set()
    for start in sorted(adj):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == start:
                    cyc = _rotate_min(path)
                    key = tuple(cyc)
                    if key not in seen_ids:
                        seen_ids.add(key)
                        cycles.append(cyc)
                elif nxt not in path and len(path) < 16:
                    stack.append((nxt, path + [nxt]))
    return cycles


def _rotate_min(path: List[str]) -> List[str]:
    i = path.index(min(path))
    return path[i:] + path[:i]


# ---------------------------------------------------------------------------
# R1 guarded-by
# ---------------------------------------------------------------------------

class _GuardVisitor(ast.NodeVisitor):
    def __init__(self, model: FileModel, cls: ClassInfo, scope: str,
                 findings: List[Finding]):
        self.model = model
        self.cls = cls
        self.scope = scope
        self.findings = findings
        self._held: Set[str] = set()
        self._parents: Dict[ast.AST, ast.AST] = {}

    def run(self, fn: ast.FunctionDef):
        for parent in ast.walk(fn):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        for child in fn.body:
            self.visit(child)

    def visit_With(self, node: ast.With):
        pushed = []
        for item in node.items:
            attr = _with_lock_attr(item)
            if attr is not None and attr in self.cls.lock_attrs \
                    and attr not in self._held:
                self._held.add(attr)
                pushed.append(attr)
        for child in node.body:
            self.visit(child)
        for attr in pushed:
            self._held.discard(attr)

    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self" \
                and node.attr in self.cls.guards:
            guard, mode = self.cls.guards[node.attr]
            if guard not in self._held and \
                    (mode == "all" or self._is_write(node)):
                kind = "write" if self._is_write(node) else "read"
                f = Finding(
                    "R1", self.model.relpath, node.lineno, self.scope,
                    node.attr,
                    f"{kind} of self.{node.attr} (guarded-by {guard}) "
                    f"outside `with self.{guard}`")
                if not self.model.ignored(node.lineno, "R1"):
                    self.findings.append(f)
        self.generic_visit(node)

    def _is_write(self, node: ast.Attribute) -> bool:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return True
        parent = self._parents.get(node)
        if isinstance(parent, ast.Subscript) and parent.value is node \
                and isinstance(parent.ctx, (ast.Store, ast.Del)):
            return True
        if isinstance(parent, ast.Attribute) and parent.value is node \
                and parent.attr in _MUTATORS:
            gp = self._parents.get(parent)
            if isinstance(gp, ast.Call) and gp.func is parent:
                return True
        return False

    def visit_FunctionDef(self, node):
        pass                                  # deferred execution

    def visit_AsyncFunctionDef(self, node):
        pass

    def visit_Lambda(self, node):
        pass


# ---------------------------------------------------------------------------
# rule drivers
# ---------------------------------------------------------------------------

def _check_r1(model: FileModel, findings: List[Finding]):
    for node in model.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        cls = model.classes[node.name]
        if not cls.guards:
            continue
        for fn in node.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            if fn.name in ("__init__", "__post_init__") \
                    or fn.name.endswith("_locked"):
                continue                     # not-yet-shared / by-convention
            v = _GuardVisitor(model, cls, f"{node.name}.{fn.name}",
                              findings)
            v.run(fn)


def _enclosing_function(parents: Dict[ast.AST, ast.AST],
                        node: ast.AST) -> Optional[ast.AST]:
    p = parents.get(node)
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        p = parents.get(p)
    return p


def _check_r2(model: FileModel, findings: List[Finding]):
    cv_attrs: Set[str] = set()
    for cls in model.classes.values():
        cv_attrs |= cls.cv_attrs
    parents: Dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(model.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    for node in ast.walk(model.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "wait"):
            continue
        recv = node.func.value
        rname = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else None)
        if rname is None:
            continue
        if rname not in cv_attrs and not _CV_NAME.search(rname):
            continue
        scope = _scope_of(parents, node)
        # (a) must sit inside a while loop within the same function
        fn = _enclosing_function(parents, node)
        p, in_while = parents.get(node), False
        while p is not None and p is not fn:
            if isinstance(p, ast.While):
                in_while = True
                break
            p = parents.get(p)
        if not in_while and not model.ignored(node.lineno, "R2"):
            findings.append(Finding(
                "R2", model.relpath, node.lineno, scope,
                f"{rname}.wait-not-in-while",
                f"{rname}.wait() outside a while-predicate loop "
                f"(missed/spurious wakeups)"))
        # (b) numeric-literal timeout = polling grid
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, (int, float)) \
                and not model.ignored(node.lineno, "R2"):
            findings.append(Finding(
                "R2", model.relpath, node.lineno, scope,
                f"{rname}.wait-literal-timeout-{node.args[0].value}",
                f"{rname}.wait({node.args[0].value!r}): numeric-literal "
                f"timeout — polling; use notification or a computed "
                f"Algorithm-1 deadline"))


def _check_r4(model: FileModel, findings: List[Finding]):
    if any(model.relpath.endswith(sfx) for sfx in SLEEP_ALLOWED):
        return
    parents: Dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(model.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "sleep" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "time" \
                and not model.ignored(node.lineno, "R4"):
            findings.append(Finding(
                "R4", model.relpath, node.lineno,
                _scope_of(parents, node), "time.sleep",
                "time.sleep outside the simulated store/BandwidthModel/"
                "trace-replay gap — polling wait"))


def _scope_of(parents: Dict[ast.AST, ast.AST], node: ast.AST) -> str:
    names: List[str] = []
    p: Optional[ast.AST] = node
    while p is not None:
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.append(p.name)
        p = parents.get(p)
    return ".".join(reversed(names)) if names else "<module>"


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, relpath: str = "<string>") -> List[Finding]:
    """Lint one source string (the fixture-test entry point).  R3 runs
    file-locally here; cross-file edges need :func:`lint_paths`."""
    model = FileModel(source, relpath)
    return _lint_models([model])


def _lint_models(models: Sequence[FileModel]) -> List[Finding]:
    findings: List[Finding] = []
    for m in models:
        _check_r1(m, findings)
        _check_r2(m, findings)
        _check_r4(m, findings)
    _, cycles = build_static_lockgraph(models)
    for cyc in cycles:
        m0 = models[0]
        findings.append(Finding(
            "R3", m0.relpath if len(models) == 1 else "<project>",
            0, "<lockgraph>", "cycle:" + "->".join(cyc),
            f"static lock-order cycle: {' -> '.join(cyc + [cyc[0]])}"))
    # dedupe identical IDs (keep first occurrence's line)
    out, seen = [], set()
    for f in findings:
        if f.id not in seen:
            seen.add(f.id)
            out.append(f)
    return out


def iter_py_files(root: str) -> Iterable[Tuple[str, str]]:
    """Yield (abspath, relpath) for every .py under ``root`` (or the
    single file)."""
    if os.path.isfile(root):
        yield root, os.path.basename(root)
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                yield full, os.path.relpath(full, root)


def load_models(root: str) -> List[FileModel]:
    models = []
    for full, rel in iter_py_files(root):
        with open(full) as f:
            models.append(FileModel(f.read(), rel))
    return models


def lint_paths(roots: Sequence[str]) -> List[Finding]:
    models: List[FileModel] = []
    for root in roots:
        models.extend(load_models(root))
    return _lint_models(models)


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, str]:
    """{finding-id: justification} from the reviewed baseline file.
    Format: one ID per line, justification after ``  #``; blank lines
    and full-line comments ignored."""
    entries: Dict[str, str] = {}
    try:
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                fid, _, just = line.partition(" #")
                entries[fid.strip()] = just.strip()
    except OSError:
        pass
    return entries


def apply_baseline(findings: Sequence[Finding], baseline: Dict[str, str]
                   ) -> Tuple[List[Finding], List[str]]:
    """(unsuppressed findings, stale baseline IDs that matched
    nothing)."""
    ids = {f.id for f in findings}
    unsuppressed = [f for f in findings if f.id not in baseline]
    stale = sorted(b for b in baseline if b not in ids)
    return unsuppressed, stale
