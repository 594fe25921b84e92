"""Lease-release lint: every acquired releasable resource provably
releases on every path, including exceptions (LSE001/LSE002).

Review kept finding the same bug class by hand: a HostBudget charge
released on the happy path but not when the prepare pool aborted, a
session in-flight slot held past a parse error, a file descriptor left
open behind an early return.  This pass mechanizes the
contract over the repo's releasable resources:

  resource                      acquire                    release
  ---------------------------   ------------------------   ----------
  HostBudget byte lease         <budget>.admit(...)        .release()
  session in-flight slot        self._try_acquire_slot()   self._release_slot()
  file descriptor               open(...)                  .close()

plus the with-only scope factories (`device_scope`, `atomic_output`,
span scopes): calling one as a bare statement discards the scope
without ever entering it.

Semantics (built on analysis.dataflow + analysis.callgraph):

  * a `with open(...)` / with-item acquire is safe by construction;
  * a lease that ESCAPES stops being this function's responsibility:
    returned, stored on an object (`self._fh = open(...)`), passed as
    a call argument (the receiver now owns it -- checked at ITS acquire
    sites), or captured by a nested def/lambda (the callback-release
    idiom: `callback=lambda fut: polish_done(..., lease)`);
  * a nested def that (transitively) calls the resource's release and
    is then passed to any call counts as a release-by-callback for the
    anonymous resources (`on_done` releasing the session slot, handed
    to `engine.submit`);
  * release is checked TRANSITIVELY through the call graph: a helper
    whose effect closure contains the release name releases;
  * LSE001 fires when a tracked, non-escaping resource is still held at
    a `return` or at the end of the function;
  * LSE002 fires when (a) a `raise` happens while holding an
    unprotected resource, or (b) any call ran while the resource was
    held and NO try in the function releases it from a handler or
    finally (the coarse implicit-raise rule: calls can always raise,
    so the function must own an exception-path release somewhere).

Conservative by design: unresolvable aliasing drops tracking (silence
is not proof); a finding is strong evidence.
"""

from __future__ import annotations

import ast
import dataclasses

from pbccs_tpu_torch.analysis.callgraph import (
    CallGraph,
    build_graph,
    node_call_names,
    scoped_walk,
)
from pbccs_tpu_torch.analysis.core import Finding, SourceFile, dotted_name
from pbccs_tpu_torch.analysis.dataflow import PathEngine, PathSemantics


@dataclasses.dataclass(frozen=True)
class LeaseSpec:
    key: str                      # short id used in messages
    what: str                     # human phrase for findings
    acquires: tuple[str, ...]     # call last-names that acquire
    releases: tuple[str, ...]     # call last-names that release
    bare_acquire: bool = False    # acquire call must be an undotted name
    bool_result: bool = False     # acquire returns a bool (anonymous hold)
    # every spec's handle may be None-checked: test_split drops the
    # token on the `is None` branch generically


SPECS: tuple[LeaseSpec, ...] = (
    LeaseSpec("budget", "host-budget lease",
              acquires=("admit",), releases=("release",)),
    LeaseSpec("slot", "session in-flight slot",
              acquires=("_try_acquire_slot",),
              releases=("_release_slot",), bool_result=True),
    LeaseSpec("fd", "file handle",
              acquires=("open",), releases=("close",),
              bare_acquire=True),
)

# context-manager factories that allocate nothing until entered: calling
# one as a bare expression statement is always a bug (the scope -- and
# for atomic_output the whole write -- silently never happens)
SCOPE_FACTORIES = ("device_scope", "atomic_output")

_ACQUIRE_NAMES = {name for spec in SPECS for name in spec.acquires}


def _spec_for_call(call: ast.Call) -> LeaseSpec | None:
    d = dotted_name(call.func)
    if d is None:
        return None
    for spec in SPECS:
        if d[-1] in spec.acquires:
            if spec.bare_acquire and len(d) != 1:
                continue
            return spec
    return None


# one held resource; lineno makes tokens unique per acquire site
Token = tuple  # (spec.key, var | None, lineno)


class _LeaseSemantics(PathSemantics):
    """State = frozenset of Tokens."""

    def __init__(self, src: SourceFile, fn, cls: str | None,
                 graph: CallGraph, findings: list[Finding]):
        self.src = src
        self.fn = fn
        self.cls = cls
        self.graph = graph
        self.findings = findings
        self.specs_by_key = {s.key: s for s in SPECS}
        # closure name -> spec keys it (transitively) releases
        self.closure_releasers: dict[str, set[str]] = {}
        # tokens that had a call run while held (implicit-raise risk)
        self.risky: set[Token] = set()
        self.protection_stack: list[set[str]] = []
        self._try_protection: dict[int, set[str]] = {}
        self._reported: set[tuple] = set()
        # spec keys for which SOME try in this fn releases on an
        # exception path (the coarse implicit-raise requirement)
        self.fn_exception_release: set[str] = set()
        self._precompute_try_protection()

    # ------------------------------------------------------ try scanning

    def _releases_in(self, body: list[ast.stmt]) -> set[str]:
        """Spec keys released (transitively) somewhere in `body`."""
        keys: set[str] = set()
        names: set[str] = set()
        for stmt in body:
            names |= node_call_names(stmt, scoped=False)
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    target = self.graph.resolve(n, self.src.rel, self.cls)
                    if target is not None:
                        names |= self.graph.reaches(target)
        for spec in SPECS:
            if names.intersection(spec.releases):
                keys.add(spec.key)
        return keys

    def _precompute_try_protection(self) -> None:
        for node in scoped_walk(self.fn):
            if not isinstance(node, ast.Try):
                continue
            body: list[ast.stmt] = list(node.finalbody)
            for h in node.handlers:
                body += h.body
            keys = self._releases_in(body)
            self._try_protection[id(node)] = keys
            self.fn_exception_release |= keys

    def _protected(self, key: str) -> bool:
        return any(key in p for p in self.protection_stack)

    def enter_try(self, node: ast.Try) -> None:
        self.protection_stack.append(self._try_protection.get(id(node),
                                                              set()))

    def exit_try(self, node: ast.Try) -> None:
        self.protection_stack.pop()

    # -------------------------------------------------------- reporting

    def _report(self, rule: str, line: int, msg: str, dedup: tuple) -> None:
        if dedup in self._reported:
            return
        self._reported.add(dedup)
        self.findings.append(Finding(rule, self.src.rel, line, msg))

    # --------------------------------------------------------- helpers

    def _held_vars(self, state: frozenset) -> dict[str, Token]:
        return {t[1]: t for t in state if t[1] is not None}

    def _names_in(self, node: ast.AST) -> set[str]:
        return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}

    def _drop(self, state: frozenset, token: Token) -> frozenset:
        return state - {token}

    def _release_matches(self, call: ast.Call, state: frozenset
                         ) -> set[Token]:
        """Tokens this call releases (directly, transitively, or via a
        registered releasing closure passed as an argument)."""
        out: set[Token] = set()
        d = dotted_name(call.func)
        held = self._held_vars(state)
        if d is not None:
            # var.release() / var.close()
            if len(d) == 2 and d[0] in held:
                token = held[d[0]]
                spec = self.specs_by_key[token[0]]
                if d[1] in spec.releases:
                    out.add(token)
            # self._release_slot()-style releases free the anonymous
            # holds of their spec
            for token in state:
                spec = self.specs_by_key[token[0]]
                if d[-1] in spec.releases and token[1] is None:
                    out.add(token)
            # a resolvable callee whose effect closure releases,
            # receiving the resource as an argument (transfer-release)
            target = self.graph.resolve(call, self.src.rel, self.cls)
            if target is not None:
                reached = self.graph.reaches(target)
                arg_names: set[str] = set()
                for a in call.args:
                    arg_names |= self._names_in(a)
                for kw in call.keywords:
                    arg_names |= self._names_in(kw.value)
                for var, token in held.items():
                    spec = self.specs_by_key[token[0]]
                    if var in arg_names and reached.intersection(
                            spec.releases):
                        out.add(token)
        # releasing closure handed to any call: counts for the
        # anonymous holds of the specs it releases
        for node in ast.walk(call):
            if isinstance(node, ast.Name) \
                    and node.id in self.closure_releasers:
                keys = self.closure_releasers[node.id]
                for token in state:
                    if token[0] in keys and token[1] is None:
                        out.add(token)
        return out

    def _escapes(self, stmt: ast.stmt, state: frozenset) -> set[Token]:
        """Tokens whose variable escapes in this statement."""
        out: set[Token] = set()
        held = self._held_vars(state)
        if not held:
            return out
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                for a in list(node.args) + [kw.value for kw in
                                            node.keywords]:
                    for name in self._names_in(a):
                        if name in held:
                            out.add(held[name])
            elif isinstance(node, (ast.Lambda, ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                for name in self._names_in(node):
                    if name in held:
                        out.add(held[name])
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        for name in self._names_in(node.value):
                            if name in held:
                                out.add(held[name])
                # plain alias x = lease: stop tracking (conservative)
                if isinstance(node.value, ast.Name) \
                        and node.value.id in held:
                    out.add(held[node.value.id])
            elif isinstance(node, (ast.Yield, ast.YieldFrom)):
                if node.value is not None:
                    for name in self._names_in(node.value):
                        if name in held:
                            out.add(held[name])
        return out

    # ----------------------------------------------------- PathSemantics

    def initial_state(self):
        return frozenset()

    def on_nested_def(self, node, state):
        names = node_call_names(node, scoped=False)
        keys = {spec.key for spec in SPECS
                if names.intersection(spec.releases)}
        if keys:
            self.closure_releasers[node.name] = keys
        # capture-escape: the closure now co-owns whatever it references
        held = self._held_vars(state)
        for name in self._names_in(node):
            if name in held:
                state = self._drop(state, held[name])
        return state

    def with_effect(self, node, state):
        # with-item acquires are safe by construction; held vars used
        # inside item expressions escape
        for item in node.items:
            for name in self._names_in(item.context_expr):
                held = self._held_vars(state)
                if name in held:
                    state = self._drop(state, held[name])
        return state

    def stmt_effect(self, stmt, state):
        pre_held = set(state)
        # 1. releases
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                for token in self._release_matches(node, state):
                    state = self._drop(state, token)
        # 2. escapes
        for token in self._escapes(stmt, state):
            state = self._drop(state, token)
        # 3. acquires (an Assign whose VALUE is the acquire call binds)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.value, ast.Call):
            spec = _spec_for_call(stmt.value)
            if spec is not None and isinstance(stmt.targets[0], ast.Name):
                state = state | {(spec.key, stmt.targets[0].id,
                                  stmt.lineno)}
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                       ast.Call):
            spec = _spec_for_call(stmt.value)
            if spec is not None:
                # result discarded: an anonymous hold nothing can ever
                # release by name (bool specs release via their named
                # release call; fds cannot)
                state = state | {(spec.key, None, stmt.lineno)}
        # 4. implicit-raise risk: a call ran while a PRE-EXISTING hold
        # was live
        if pre_held:
            has_call = any(isinstance(n, ast.Call)
                           for n in ast.walk(stmt))
            if has_call:
                for token in pre_held:
                    if token in state:
                        self.risky.add(token)
        return state

    def test_split(self, test, state):
        # risk accounting for calls inside the test itself
        if state and any(isinstance(n, ast.Call)
                         for n in ast.walk(test)):
            for token in state:
                self.risky.add(token)
        # if acquire(): ...     /  if not acquire(): return
        if isinstance(test, ast.Call):
            spec = _spec_for_call(test)
            if spec is not None and spec.bool_result:
                token = (spec.key, None, test.lineno)
                return [state | {token}], [state]
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = test.operand
            if isinstance(inner, ast.Call):
                spec = _spec_for_call(inner)
                if spec is not None and spec.bool_result:
                    token = (spec.key, None, inner.lineno)
                    return [state], [state | {token}]
            if isinstance(inner, ast.Name):
                held = self._held_vars(state)
                if inner.id in held:
                    token = held[inner.id]
                    return [self._drop(state, token)], [state]
        # if lease: / if lease is None: / if lease is not None:
        if isinstance(test, ast.Name):
            held = self._held_vars(state)
            if test.id in held:
                token = held[test.id]
                return [state], [self._drop(state, token)]
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.left, ast.Name) \
                and len(test.comparators) == 1 \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            held = self._held_vars(state)
            if test.left.id in held:
                token = held[test.left.id]
                if isinstance(test.ops[0], ast.Is):
                    return [self._drop(state, token)], [state]
                if isinstance(test.ops[0], ast.IsNot):
                    return [state], [self._drop(state, token)]
        return [state], [state]

    def on_exit(self, kind, node, state):
        for token in state:
            spec = self.specs_by_key[token[0]]
            if kind == "return":
                value = getattr(node, "value", None)
                if value is not None and token[1] is not None \
                        and token[1] in self._names_in(value):
                    continue   # ownership transferred to the caller
                self._report(
                    "LSE001", node.lineno,
                    f"{spec.what} acquired at line {token[2]} is not "
                    "released on this return path (release it, or "
                    "transfer ownership explicitly)",
                    ("LSE001", token, node.lineno))
            elif kind == "fall":
                self._report(
                    "LSE001", token[2],
                    f"{spec.what} acquired here is not released by the "
                    "end of the function on some path",
                    ("LSE001", token, "fall"))
            elif kind == "raise" and not self._protected(token[0]):
                self._report(
                    "LSE002", node.lineno,
                    f"{spec.what} acquired at line {token[2]} leaks on "
                    "this raise (no enclosing finally/except releases "
                    "it)", ("LSE002", token, node.lineno))

    def finish(self) -> None:
        """The coarse implicit-raise rule, applied after the walk."""
        for token in self.risky:
            key = token[0]
            spec = self.specs_by_key[key]
            if key not in self.fn_exception_release:
                self._report(
                    "LSE002", token[2],
                    f"calls run while this {spec.what} is held, but no "
                    "try in the function releases it on an exception "
                    "path (add a finally/except release, use a with "
                    "block, or transfer ownership before calling out)",
                    ("LSE002", token, "implicit"))


def _fn_mentions_resources(fn: ast.AST) -> bool:
    for n in scoped_walk(fn):
        if isinstance(n, ast.Call):
            d = dotted_name(n.func)
            if d is not None and d[-1] in _ACQUIRE_NAMES:
                return True
    return False


def _check_scope_factories(src: SourceFile,
                           findings: list[Finding]) -> None:
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            d = dotted_name(node.value.func)
            if d is not None and d[-1] in SCOPE_FACTORIES:
                findings.append(Finding(
                    "LSE001", src.rel, node.lineno,
                    f"{d[-1]}(...) called as a bare statement: the "
                    "scope is never entered (use `with`)"))


def analyze_leases(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    graph = build_graph(sources)
    for src in sources:
        _check_scope_factories(src, findings)
        # every function INCLUDING nested defs: a lease acquired inside
        # a worker closure (executor.prep_one) is that closure's to
        # release, so each def gets its own walk with the enclosing
        # class as its resolution context
        todo: list[tuple[ast.AST, str | None]] = []

        def collect(body, cls):
            for node in body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    todo.append((node, cls))
                    collect(node.body, cls)
                elif isinstance(node, ast.ClassDef):
                    collect(node.body, node.name)
                elif hasattr(node, "body") and isinstance(
                        getattr(node, "body"), list):
                    collect(node.body, cls)
                    for attr in ("orelse", "finalbody", "handlers"):
                        sub = getattr(node, attr, None)
                        if attr == "handlers" and sub:
                            for h in sub:
                                collect(h.body, cls)
                        elif isinstance(sub, list):
                            collect(sub, cls)

        collect(src.tree.body, None)
        for fn, cls in todo:
            if not _fn_mentions_resources(fn):
                continue
            sem = _LeaseSemantics(src, fn, cls, graph, findings)
            PathEngine(sem).run(fn)
            sem.finish()
    return findings
