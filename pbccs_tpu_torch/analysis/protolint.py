"""Protocol-conformance lint: the serve/router wire tiers against the
machine-readable spec in serve/protocol.py (PRO001-PRO003).

Review caught, by hand, a handler that could complete a request it no
longer owned and replies racing failover toward double emission.  The
wire contract lives as data (`WIRE_VERBS` / `WIRE_REPLIES` /
`WIRE_ERRORS` in serve/protocol.py) and this pass derives the checks
from it:

  PRO001  wire-spec drift, both directions: a VERB_*/TYPE_*/ERR_*
          constant missing from the spec tables (or a spec entry no
          constant defines); a spec verb with no concrete handler
          definition or no dispatch branch; a verb/reply-type/error-
          code that reaches a wire (dict literal, error_to_wire call)
          but is not in the spec.  Repo-wide only (needs
          serve/protocol.py); path-scoped runs skip it.
  PRO002  a reply handler (an `_on_*` session method that sends)
          completes a request zero times or more than once on some
          path.  "Completes" counts direct `self.send(...)` calls and
          the registration of a sending closure with another call (the
          ownership-transfer rule: `engine.submit(...,
          callback=on_done)` hands the exactly-once obligation to
          `on_done`).  Calls that MAY send (a callee whose effect
          closure reaches `send`) keep a zero-send path from flagging
          -- conservative, so silence is not proof.
  PRO003  the `_locked`-suffix ownership contract: a `*_locked`
          function asserts its caller holds the owning lock, so (a)
          calling one outside a `with self.<lock>` block -- unless the
          caller is itself `*_locked` -- and (b) a `*_locked` function
          acquiring the class lock itself are both findings.
          Completion helpers (`_complete_locked`,
          `_sweep_inflight_locked`) follow exactly this contract, so
          the rule mechanizes "complete a request only while owning
          it".
"""

from __future__ import annotations

import ast

from pbccs_tpu_torch.analysis.callgraph import (
    CallGraph,
    build_graph,
    node_call_names,
)
from pbccs_tpu_torch.analysis.conc import _is_lock_ctor  # shared lock-ctor
# detection; conc owns the repo's threading conventions
from pbccs_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    dotted_name,
    module_str_constants,
)
from pbccs_tpu_torch.analysis.dataflow import PathEngine, PathSemantics

SPEC_MODULE = "pbccs_tpu_torch/serve/protocol.py"
TIER_MODULES = ("pbccs_tpu_torch/serve/server.py",
                "pbccs_tpu_torch/serve/router.py",
                "pbccs_tpu_torch/serve/client.py")

_CONST_PREFIXES = {"verbs": "VERB_", "replies": "TYPE_", "errors": "ERR_",
                   "fields": "FIELD_", "field keys": "KEY_"}


# ------------------------------------------------------------- spec parsing

class WireSpec:
    def __init__(self) -> None:
        self.verbs: dict[str, dict] = {}
        self.replies: set[str] = set()
        self.errors: set[str] = set()
        self.unsolicited: set[str] = set()
        # optional cross-cutting frame fields (trace context):
        # {field: {"keys": (...), "verbs": (...)}}
        self.fields: dict[str, dict] = {}
        self.lines: dict[str, int] = {}     # table name -> lineno


def _eval_node(node: ast.expr, consts: dict[str, str]):
    """Literal evaluation with Name resolution through the module's
    string constants (so the spec is written in VERB_*/TYPE_* terms)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in consts:
            return consts[node.id]
        raise ValueError(f"unresolvable name {node.id!r}")
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_eval_node(e, consts) for e in node.elts)
    if isinstance(node, ast.Dict):
        out = {}
        for k, v in zip(node.keys, node.values):
            if k is None:
                raise ValueError("** in spec dict")
            out[_eval_node(k, consts)] = _eval_node(v, consts)
        return out
    raise ValueError(f"non-literal spec node {type(node).__name__}")


def parse_spec(src: SourceFile) -> tuple[WireSpec | None, Finding | None]:
    consts = module_str_constants(src.tree)
    spec = WireSpec()
    found = set()
    for node in src.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                or not isinstance(node.targets[0], ast.Name):
            continue
        name = node.targets[0].id
        if name not in ("WIRE_VERBS", "WIRE_REPLIES", "WIRE_ERRORS",
                        "WIRE_UNSOLICITED", "WIRE_FIELDS"):
            continue
        try:
            value = _eval_node(node.value, consts)
        except ValueError as e:
            return None, Finding(
                "PRO001", src.rel, node.lineno,
                f"wire spec {name} is not a resolvable literal ({e}); "
                "protolint cannot derive the protocol checks")
        spec.lines[name] = node.lineno
        found.add(name)
        if name == "WIRE_VERBS":
            spec.verbs = value
        elif name == "WIRE_REPLIES":
            spec.replies = set(value)
        elif name == "WIRE_ERRORS":
            spec.errors = set(value)
        elif name == "WIRE_UNSOLICITED":
            spec.unsolicited = set(value)
        elif name == "WIRE_FIELDS":
            spec.fields = value
    if "WIRE_VERBS" not in found:
        return None, Finding(
            "PRO001", src.rel, 1,
            "serve/protocol.py defines no WIRE_VERBS spec table; the "
            "wire state machine must be machine-readable")
    return spec, None


# ------------------------------------------------------------ PRO001 (drift)

def _resolve_wire_value(node: ast.expr, own_consts: dict[str, str],
                        proto_consts: dict[str, str]) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return own_consts.get(node.id) or proto_consts.get(node.id)
    if isinstance(node, ast.Attribute):
        d = dotted_name(node)
        if d is not None and len(d) == 2 and d[0] == "protocol":
            return proto_consts.get(d[1])
    return None


def _dispatch_verbs(tree: ast.Module, own_consts: dict[str, str],
                    proto_consts: dict[str, str]) -> set[str] | None:
    """Verbs compared inside the wire `_dispatch` loop, or None when
    the module defines none.  A wire dispatch is a `_dispatch` that
    COMPARES verb values -- the router's request _dispatch (replica
    routing) shares the name but compares nothing, so it never
    qualifies."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or node.name != "_dispatch":
            continue
        verbs: set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.ops[0], (ast.Eq, ast.NotEq)):
                for side in (n.left, *n.comparators):
                    v = _resolve_wire_value(side, own_consts,
                                            proto_consts)
                    if v is not None:
                        verbs.add(v)
        if verbs:
            return verbs
    return None


def _concrete_methods(sources: list[SourceFile]
                      ) -> dict[str, list[tuple[str, int]]]:
    """method name -> [(module, lineno)] for non-abstract defs in the
    tier modules (a body of just `raise NotImplementedError` is the
    abstract front-door hook, not a handler)."""
    out: dict[str, list[tuple[str, int]]] = {}
    for src in sources:
        if src.rel not in TIER_MODULES:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                body = [s for s in item.body
                        if not isinstance(s, ast.Expr)
                        or not isinstance(s.value, ast.Constant)]
                abstract = (len(body) == 1
                            and isinstance(body[0], ast.Raise)
                            and "NotImplementedError" in ast.dump(body[0]))
                if not abstract:
                    out.setdefault(item.name, []).append(
                        (src.rel, item.lineno))
    return out


def _check_drift(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    proto = next((s for s in sources if s.rel == SPEC_MODULE), None)
    if proto is None:
        return findings
    spec, err = parse_spec(proto)
    if err is not None:
        return [err]
    proto_consts = module_str_constants(proto.tree)

    # constants <-> spec membership (within protocol.py itself)
    field_keys: set[str] = set()
    for entry in spec.fields.values():
        if isinstance(entry, dict):
            field_keys.update(entry.get("keys", ()))
    sections = {"verbs": set(spec.verbs), "replies": spec.replies,
                "errors": spec.errors, "fields": set(spec.fields),
                "field keys": field_keys}
    # a field's carrier verbs must themselves be spec verbs
    for field, entry in sorted(spec.fields.items()):
        carriers = entry.get("verbs", ()) if isinstance(entry, dict) else ()
        for verb in carriers:
            if verb not in spec.verbs:
                findings.append(Finding(
                    "PRO001", proto.rel, spec.lines.get("WIRE_FIELDS", 1),
                    f"wire field {field!r} names carrier verb {verb!r} "
                    "that the wire spec does not declare"))
    for section, prefix in _CONST_PREFIXES.items():
        declared = {v for k, v in proto_consts.items()
                    if k.startswith(prefix)}
        in_spec = sections[section]
        for value in sorted(declared - in_spec):
            findings.append(Finding(
                "PRO001", proto.rel, spec.lines.get("WIRE_VERBS", 1),
                f"protocol constant {prefix}* value {value!r} is "
                f"missing from the wire spec ({section})"))
        for value in sorted(in_spec - declared):
            findings.append(Finding(
                "PRO001", proto.rel, spec.lines.get("WIRE_VERBS", 1),
                f"wire spec lists {value!r} under {section} but no "
                f"{prefix}* constant defines it"))

    methods = _concrete_methods(sources)
    for verb, entry in sorted(spec.verbs.items()):
        handler = entry.get("handler") if isinstance(entry, dict) else None
        if handler is not None and handler not in methods:
            findings.append(Finding(
                "PRO001", proto.rel, spec.lines.get("WIRE_VERBS", 1),
                f"verb {verb!r} names handler {handler!r} but no "
                "concrete session method of that name exists in the "
                "serve tier"))

    for src in sources:
        if src.rel not in TIER_MODULES:
            continue
        own_consts = module_str_constants(src.tree)
        dispatched = _dispatch_verbs(src.tree, own_consts, proto_consts)
        if dispatched is not None:
            for verb in sorted(set(spec.verbs) - dispatched):
                findings.append(Finding(
                    "PRO001", src.rel, 1,
                    f"spec verb {verb!r} has no branch in this "
                    "module's _dispatch loop (a peer sending it gets "
                    "an unknown-verb error)"))
            for verb in sorted(dispatched - set(spec.verbs)):
                findings.append(Finding(
                    "PRO001", src.rel, 1,
                    f"_dispatch handles verb {verb!r} that the wire "
                    "spec does not declare"))
        for node in ast.walk(src.tree):
            # wire dict literals: {"verb": X} / {"type": X}
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if not (isinstance(k, ast.Constant)
                            and k.value in ("verb", "type")):
                        continue
                    value = _resolve_wire_value(v, own_consts,
                                                proto_consts)
                    if value is None or value.startswith("__"):
                        continue   # local sentinel, never hits a wire
                    pool = (set(spec.verbs) if k.value == "verb"
                            else spec.replies)
                    if value not in pool:
                        findings.append(Finding(
                            "PRO001", src.rel, node.lineno,
                            f"{k.value} {value!r} is sent here but the "
                            "wire spec does not declare it"))
            elif isinstance(node, ast.Call):
                d = dotted_name(node.func)
                if d is None:
                    continue
                # status.update(type=...) reply construction
                if d[-1] == "update":
                    for kw in node.keywords:
                        if kw.arg == "type":
                            value = _resolve_wire_value(
                                kw.value, own_consts, proto_consts)
                            if value is not None \
                                    and value not in spec.replies:
                                findings.append(Finding(
                                    "PRO001", src.rel, node.lineno,
                                    f"reply type {value!r} is sent "
                                    "here but the wire spec does not "
                                    "declare it"))
                elif d[-1] == "error_to_wire" and len(node.args) >= 2:
                    value = _resolve_wire_value(node.args[1], own_consts,
                                                proto_consts)
                    if value is not None and value not in spec.errors:
                        findings.append(Finding(
                            "PRO001", src.rel, node.lineno,
                            f"error code {value!r} is sent here but "
                            "the wire spec does not declare it"))
    return findings


# --------------------------------------------------- PRO002 (exactly-once)

class _CompletionSemantics(PathSemantics):
    """State = (definite, may) completion counts, saturating at 2."""

    def __init__(self, src: SourceFile, fn, cls: str | None,
                 graph: CallGraph, findings: list[Finding]):
        self.src = src
        self.fn = fn
        self.cls = cls
        self.graph = graph
        self.findings = findings
        self.closure_senders: set[str] = set()
        self._reported: set[str] = set()

    def initial_state(self):
        return (0, 0)

    def _is_send(self, call: ast.Call) -> bool:
        d = dotted_name(call.func)
        return d is not None and len(d) == 2 \
            and d[0] in ("self", "cls") and d[1] == "send"

    def _events(self, node: ast.AST) -> tuple[int, int]:
        definite = may = 0
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not isinstance(n, ast.Call):
                continue
            if self._is_send(n):
                definite += 1
                continue
            # a sending closure registered with a call completes later
            for a in list(n.args) + [kw.value for kw in n.keywords]:
                if isinstance(a, ast.Name) \
                        and a.id in self.closure_senders:
                    definite += 1
                    break
            else:
                target = self.graph.resolve(n, self.src.rel, self.cls)
                if target is not None \
                        and "send" in self.graph.reaches(target):
                    may += 1
        return definite, may

    def _bump(self, state, node):
        d, m = self._events(node)
        return (min(2, state[0] + d), min(2, state[1] + m))

    def stmt_effect(self, stmt, state):
        return self._bump(state, stmt)

    def test_split(self, test, state):
        st = self._bump(state, test)
        return [st], [st]

    def with_effect(self, node, state):
        for item in node.items:
            state = self._bump(state, item.context_expr)
        return state

    def on_nested_def(self, node, state):
        names = node_call_names(node, scoped=False)
        if "send" in names:
            self.closure_senders.add(node.name)
        return state

    def _report(self, kind: str, line: int, msg: str) -> None:
        if kind in self._reported:
            return
        self._reported.add(kind)
        self.findings.append(Finding("PRO002", self.src.rel, line, msg))

    def on_exit(self, kind, node, state):
        if kind == "raise":
            return   # error propagation is the session reader's problem
        definite, may = state
        line = getattr(node, "lineno", self.fn.lineno)
        if definite >= 2:
            self._report(
                "double", line,
                f"handler {self.fn.name}() can complete a request "
                "more than once on a path reaching this exit "
                "(exactly-once emission)")
        elif definite == 0 and may == 0:
            self._report(
                "none", line,
                f"handler {self.fn.name}() has a path to this exit "
                "that neither replies nor registers a completion "
                "callback (the request would dangle forever)")


def _check_completion(sources: list[SourceFile],
                      graph: CallGraph) -> list[Finding]:
    findings: list[Finding] = []
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if not item.name.startswith("_on_"):
                    continue
                if "send" not in node_call_names(item, scoped=False):
                    continue   # not a reply handler (emits elsewhere)
                sem = _CompletionSemantics(src, item, node.name, graph,
                                           findings)
                PathEngine(sem).run(item)
    return findings


# ------------------------------------------------- PRO003 (_locked contract)

def _class_lock_attrs(cls: ast.ClassDef) -> set[str]:
    """Lock/Condition attributes of a class: `self._lock = Lock()` in
    any method, or a class-body `lock = Lock()` attribute."""
    locks: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) \
                or not _is_lock_ctor(node.value):
            continue
        for t in node.targets:
            d = dotted_name(t)
            if d is None:
                continue
            if len(d) == 2 and d[0] == "self":
                locks.add(d[1])
            elif len(d) == 1:
                locks.add(d[0])
    return locks


def _module_lock_names(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


class _LockedWalker(ast.NodeVisitor):
    def __init__(self, src: SourceFile, fn_name: str, locks: set[str],
                 mod_locks: set[str], findings: list[Finding]):
        self.src = src
        self.fn_name = fn_name
        self.locks = locks
        self.mod_locks = mod_locks
        self.findings = findings
        self.depth = 0

    def visit_With(self, node):  # noqa: N802 (ast API)
        held = 0
        for item in node.items:
            self.visit(item.context_expr)
            d = dotted_name(item.context_expr)
            if d is None:
                continue
            if (len(d) == 2 and d[0] in ("self", "cls")
                    and d[1] in self.locks) \
                    or (len(d) == 1 and d[0] in self.mod_locks):
                held += 1
                if self.fn_name.endswith("_locked"):
                    self.findings.append(Finding(
                        "PRO003", self.src.rel, node.lineno,
                        f"{self.fn_name}() acquires "
                        f"{'.'.join(d)} itself: the _locked suffix "
                        "promises the CALLER already holds it"))
        self.depth += held
        for stmt in node.body:
            self.visit(stmt)
        self.depth -= held

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):  # noqa: N802
        saved, self.depth = self.depth, 0
        saved_name, self.fn_name = self.fn_name, node.name
        self.generic_visit(node)
        self.depth, self.fn_name = saved, saved_name

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # noqa: N802
        saved, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = saved

    def visit_Call(self, node):  # noqa: N802
        d = dotted_name(node.func)
        if d is not None and d[-1].endswith("_locked") \
                and not self.fn_name.endswith("_locked") \
                and self.depth == 0:
            self.findings.append(Finding(
                "PRO003", self.src.rel, node.lineno,
                f"{'.'.join(d)}() called without holding the owning "
                "lock (the _locked suffix is a caller-holds-the-lock "
                "contract; completion/ownership helpers rely on it)"))
        self.generic_visit(node)


def _check_lock_contract(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in sources:
        mod_locks = _module_lock_names(src.tree)
        for node in src.tree.body:
            if isinstance(node, ast.ClassDef):
                locks = _class_lock_attrs(node)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        _LockedWalker(src, item.name, locks, mod_locks,
                                      findings).generic_visit(item)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                _LockedWalker(src, node.name, set(), mod_locks,
                              findings).generic_visit(node)
    return findings


# ------------------------------------------------------------------- entry

def analyze_proto(sources: list[SourceFile],
                  scoped: bool = False) -> list[Finding]:
    findings: list[Finding] = []
    graph = build_graph(sources)
    if not scoped:
        findings += _check_drift(sources)
    findings += _check_completion(sources, graph)
    findings += _check_lock_contract(sources)
    return findings
