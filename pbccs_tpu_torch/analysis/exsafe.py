"""Atomic-publish lint: user-visible outputs are published atomically
(ATM001/ATM002).

The BAM, report, and checkpoint writers are ENOSPC-safe: they stream
into a same-directory ``*.tmp``, fsync, then ``os.replace`` under the
final path, so a crash or full disk never publishes a torn artifact (a
torn ``.pbi`` published beside a valid BAM is the bug class this pass
makes unrepresentable):

  ATM001  a write-mode `open()` publishes directly under a final path:
          route it through `resources.atomic_output` (the registered
          helper), the tmp+fsync+rename idiom, or a registered
          journal writer (append-only + per-record fsync + torn-tail-
          tolerant loader);
  ATM002  half an atomic publish: a temp-staged write whose scope never
          fsyncs or never renames into place, or an `os.replace`/
          `os.rename` publish in a scope with no fsync (rename is only
          atomic against crashes if the data got to disk first).

What counts as temp-staged: the opened path expression contains a
``".tmp"`` literal, names a local assigned from one, or is a
``self.<attr>`` the class assigns from one (BamWriter's
``self._tmp = path + ".tmp"``).  The fsync/replace requirement is
satisfied anywhere in the enclosing class (any method) or, for module
functions, in the function itself or a resolvable callee -- the stage
and the publish are usually split across ``__init__``/``close``.

Opens whose handle immediately escapes into a larger expression (a
log stream handed to a Logger) are a hand-off, not an artifact
publish: the receiver owns the handle, and the lint only checks the
structural forms it can reason about (with-item, simple assignment,
bare statement).  Read-mode opens and unresolvable modes never flag.

Scope: package sources only (`pbccs_tpu_torch/`); chip_smoke.py is an
operator script whose scratch artifacts are not product outputs.
Path-scoped runs (fixtures, `ccs analyze file.py`) check every given
file.
"""

from __future__ import annotations

import ast

from pbccs_tpu_torch.analysis.callgraph import build_graph, node_call_names
from pbccs_tpu_torch.analysis.core import Finding, SourceFile, dotted_name

# (module path, class name) pairs whose writers own a different
# durability contract than tmp+fsync+rename (append-only journal with
# per-record fsync and a torn-tail-tolerant loader)
JOURNAL_WRITERS = {
    ("pbccs_tpu_torch/resilience/checkpoint.py", "CheckpointJournal"),
    # append-only NDJSON perf journal: flushed line records, torn-tail-
    # tolerant reader (read_ledger), degrade-to-absence on write failure
    ("pbccs_tpu_torch/obs/ledger.py", "PerfLedger"),
    # ccs tune resume journal: same contract (append + flush per line,
    # loaded via read_ledger, OSError degrades to a re-measure)
    ("pbccs_tpu_torch/tune/driver.py", "Journal"),
}

_TMP_MARKER = ".tmp"
_PUBLISH_CALLS = {"replace", "rename"}


def _contains_tmp_literal(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and _TMP_MARKER in n.value:
            return True
    return False


def _resolve_modes(call: ast.Call, local_consts: dict[str, ast.expr]
                   ) -> list[str] | None:
    """Possible mode strings of an open() call; None = unresolvable."""
    mode_node: ast.expr | None = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if mode_node is None:
        return ["r"]

    def resolve(node: ast.expr) -> list[str] | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return [node.value]
        if isinstance(node, ast.IfExp):
            a = resolve(node.body)
            b = resolve(node.orelse)
            if a is not None and b is not None:
                return a + b
        if isinstance(node, ast.Name) and node.id in local_consts:
            return resolve(local_consts[node.id])
        return None

    return resolve(mode_node)


def _local_assigns(fn: ast.AST) -> dict[str, ast.expr]:
    """name -> last assigned expr, for tmp-var and mode resolution."""
    out: dict[str, ast.expr] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            out[n.targets[0].id] = n.value
    return out


class _Scope:
    """One analyzed open/publish context: the enclosing class (all
    methods) or the enclosing module function."""

    def __init__(self, src: SourceFile, cls: ast.ClassDef | None,
                 fn: ast.AST | None, graph):
        self.src = src
        self.cls = cls
        self.fn = fn
        self.graph = graph
        self._names: set[str] | None = None
        self._tmp_attrs: set[str] | None = None
        self._locals = _local_assigns(fn) if fn is not None else {}

    def call_names(self) -> set[str]:
        """Every call name reachable from the scope (class: every
        method, unscoped; function: own body plus resolved callees)."""
        if self._names is None:
            names: set[str] = set()
            if self.cls is not None:
                names |= node_call_names(self.cls, scoped=False)
            elif self.fn is not None:
                names |= node_call_names(self.fn, scoped=False)
                cls_name = None
                for n in ast.walk(self.fn):
                    if isinstance(n, ast.Call):
                        target = self.graph.resolve(n, self.src.rel,
                                                    cls_name)
                        if target is not None:
                            names |= self.graph.reaches(target)
            self._names = names
        return self._names

    def tmp_attrs(self) -> set[str]:
        """self.<attr> names the class assigns from a ".tmp" expr."""
        if self._tmp_attrs is None:
            attrs: set[str] = set()
            if self.cls is not None:
                for n in ast.walk(self.cls):
                    if isinstance(n, ast.Assign) and len(n.targets) == 1:
                        d = dotted_name(n.targets[0])
                        if d is not None and len(d) == 2 \
                                and d[0] == "self" \
                                and _contains_tmp_literal(n.value):
                            attrs.add(d[1])
            self._tmp_attrs = attrs
        return self._tmp_attrs

    def is_tmp_path(self, path_node: ast.expr) -> bool:
        if _contains_tmp_literal(path_node):
            return True
        if isinstance(path_node, ast.Name):
            assigned = self._locals.get(path_node.id)
            if assigned is not None and _contains_tmp_literal(assigned):
                return True
        d = dotted_name(path_node)
        if d is not None and len(d) == 2 and d[0] == "self" \
                and d[1] in self.tmp_attrs():
            return True
        return False


def _parents(tree: ast.Module) -> dict[int, ast.AST]:
    out: dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _enclosing(parents: dict[int, ast.AST], node: ast.AST
               ) -> tuple[ast.ClassDef | None, ast.AST | None]:
    """(enclosing class, enclosing function) of a node."""
    cls = None
    fn = None
    cur = node
    while True:
        parent = parents.get(id(cur))
        if parent is None:
            break
        if fn is None and isinstance(parent, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)):
            fn = parent
        if isinstance(parent, ast.ClassDef):
            cls = parent
            break
        cur = parent
    return cls, fn


def _checkable_position(parents: dict[int, ast.AST],
                        call: ast.Call) -> bool:
    """Only with-items, simple assignments, and bare statements are
    publishes; a handle escaping into a larger expression is a
    hand-off the receiver owns."""
    parent = parents.get(id(call))
    if isinstance(parent, ast.withitem):
        return True
    if isinstance(parent, ast.Assign) and parent.value is call:
        return True
    if isinstance(parent, ast.Expr):
        return True
    return False


def analyze_exsafe(sources: list[SourceFile],
                   scoped: bool = False) -> list[Finding]:
    findings: list[Finding] = []
    graph = build_graph(sources)
    for src in sources:
        if not scoped and not src.rel.startswith("pbccs_tpu_torch/"):
            continue
        parents = _parents(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            # cheap name filter FIRST: scope construction walks the
            # whole enclosing function, so only candidate calls pay it
            is_open = d == ("open",) and bool(node.args)
            is_publish = (d is not None and len(d) == 2 and d[0] == "os"
                          and d[1] in _PUBLISH_CALLS)
            if not is_open and not is_publish:
                continue
            cls, fn = _enclosing(parents, node)
            scope = _Scope(src, cls, fn, graph)
            # ---------------------------------------- write-mode open()
            if is_open:
                if not _checkable_position(parents, node):
                    continue
                modes = _resolve_modes(node, scope._locals)
                if modes is None or not any(
                        c in m for m in modes for c in "wax+"):
                    continue
                if scope.is_tmp_path(node.args[0]):
                    names = scope.call_names()
                    if not names.intersection(_PUBLISH_CALLS):
                        findings.append(Finding(
                            "ATM002", src.rel, node.lineno,
                            "temp-staged write is never renamed into "
                            "place in this scope (stage + os.replace "
                            "belong together; see resources."
                            "atomic_output)"))
                    elif "fsync" not in names:
                        findings.append(Finding(
                            "ATM002", src.rel, node.lineno,
                            "temp-staged write publishes without fsync: "
                            "rename is only crash-atomic once the data "
                            "is on disk (fsync before os.replace)"))
                    continue
                if cls is not None and (src.rel, cls.name) \
                        in JOURNAL_WRITERS:
                    continue
                findings.append(Finding(
                    "ATM001", src.rel, node.lineno,
                    "write-mode open() publishes directly under a "
                    "final path: route it through resources."
                    "atomic_output (or tmp+fsync+rename, or register "
                    "a journal contract) so a crash/ENOSPC never "
                    "publishes a torn file"))
            # ------------------------------------- os.replace / rename
            else:
                names = scope.call_names()
                if "fsync" not in names:
                    findings.append(Finding(
                        "ATM002", src.rel, node.lineno,
                        f"os.{d[1]} publish in a scope that never "
                        "fsyncs the staged data: the rename can land "
                        "while the bytes do not (fsync the temp file "
                        "first)"))
    return findings
